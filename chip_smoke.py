#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 21]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), runs the combine_balance
phase, then drives the port's three graph paths on a Graph500 R-MAT graph
(scale 21, edge factor 16, weighted, seed 0: 2,097,152 vertices,
33,554,432 edges; P = 8 partitions, 8 x 8 tiles): LOCAL and OOC through
PageRank (2 iterations), BFS, SSSP and WCC, DIST_OOC through PageRank and
BFS, in threads and as 2 OS ranks over sockets (process mode, with one
rank killed and recovered), multi-query serving on LOCAL, OOC and
DIST_OOC, the SHARD_MAP executor on 8 ranks sharing the card, and the
Chaos- and GridGraph-like baselines; then the kernel entry point and LM
serving (Gemma2-9B and Zamba2-1.2B at full width) and LM training
(Zamba2-1.2B at full width and depth, on one card and on a (2, 2) device
mesh of 4 ranks sharing it), and the LM dry run held against them.

combine_balance (the two combine entry points on synthetic layouts built
on the card from a seed, ~5 s).  The combine kernels split a call by live
slots into units of K merge-path items; this phase shows that rows do not
set the time:
  * (a) 4,000,000 live tiles over 8 destinations x 8,192 rows, rows even;
    (b) the same total with one row per destination holding 25% of its
    tiles, the rest in runs of 64 rows between runs of 64 empty rows;
    (c) rows of K - 1, K, K + 1, 1, 0 and 3K + 2 tiles (8 x 1,024 rows),
    a call with a single tile and an all-empty call;
  * each through the solo kernel in all four modes and the panel kernel in
    min and add at Q = 8 and Q = 16, held against the plain versions with
    the tolerances below and every panel column bit-equal to a solo launch;
  * prints the solo add and min times on (a) and (b) beside their bounds
    and the balance ratio, add's time on (b) over (a).

LOCAL (the in-memory engine, ``block_csr`` backend; one engine per backend
serves the four algorithms, so the block tiles are built once, in
PageRank's cold run).  For each algorithm it
  * resets the combine kernel's launch count, runs the algorithm through
    the public entry points, and reads the count (it must have grown);
  * holds the values against the numpy oracles (BFS and WCC exactly,
    PageRank within rtol 1e-4 / atol 1e-7, SSSP against the float64
    Bellman-Ford oracle within rtol 1e-5 / atol 1e-5 — the tolerances of
    the repo's oracle tests; a spawned process computes them on the same
    seeded graph while the kernels build and the graph is partitioned),
    and the values (BFS/SSSP/WCC bit for bit),
    every counter and the iteration count against the port's own
    ``segment`` backend on the card;
  * (PageRank: add / add_b modes, WCC: min / max modes) replays the
    kernel's first call of the run against its plain PyTorch version:
    min/max bit-equal, has-message counts exact, add/add_b within rtol
    1e-5 (the plain version sums in another order), and times the kernel,
    the plain version and one PyTorch library call computing the same
    function, beside the least time the card could take.

Baselines (``baselines_path``: ``repro_torch.core.baselines`` on the same
graph, after LOCAL).  The Chaos-like engine on 4 nodes (the setting of
``benchmarks/table45_engines.py``) runs PageRank (2), BFS and SSSP from the
source; the Grid-like engine (grid 8) runs PageRank (2) and SSSP with an
unbounded memory budget and with one below two vertex windows (every
active block re-reads both).  It
  * records each step's active mask (one host copy a step, inside the
    timed run) and requires every counter to equal an exact numpy count
    of those masks on the graph (Chaos: streamed edges, updates and
    messages per active out-edge, remote updates at 12 B; Grid: the
    active blocks' edges and vertex windows);
  * holds the values against LOCAL's (BFS and SSSP bit for bit, PageRank
    within 1e-5) and the oracles, and the iteration counts against
    LOCAL's;
  * prints setup seconds, per run seconds, peak device memory, and LOCAL
    DFOGraph's edge and vertex bytes, messages and net bytes beside the
    baseline's (the Fig. 5 / Table 4 ratios); then the phase's seconds.

OOC (fully out of core: ``executor="ooc"``, ``block_csr``, chunks decoded
on the card).  It
  * builds the forward and reversed chunk stores of the same graph in a
    temporary directory under ``.smoke_tmp/`` (removed at exit);
  * decodes every chunk of the forward store, in one of the
    representations it stores taken in turn, on the card through the fused
    decode (``chunk_decode``, one chunk an item) and with the host codec,
    and requires bit-equality;
  * holds the varint stencil and both scan modes against their plain
    versions (bit-equal) on the largest chunk's streams and on one long
    stream (partition 1's whole dst-residue section), and times them
    beside the library calls and the byte bound, per call and on the
    card alone (``torch.profiler``: device time and operations per call);
    then sweeps both scan modes over 2^10, 2^16, 2^20 and 2^24 seeded
    elements (bit-equal, add also to ``torch.cumsum``), timed the same
    way beside ``torch.cumsum`` / ``torch.cummax``;
  * runs the four algorithms cold with the launch counts of the combine, the
    fused decode, the stencil and the scans set to 0 just before each and
    read just after (the combine and the fused decode must have run, at
    most two decode launches per item, the stencil and the scans not at
    all), and requires every chunk read to have been decoded on the card, the
    measured I/O to equal the model, the values to equal LOCAL's (BFS,
    SSSP, WCC bit for bit, PageRank within 1e-5) and the oracles', every
    modeled counter to equal LOCAL's (rtol 1e-5: LOCAL sums its counters
    in float32) and the iteration counts to match;
  * (PageRank: add, WCC: min) replays the combine kernel's largest call
    of the run — one streamed batch of the all-active first iteration,
    its ragged rows and value tiles built on the card — against its plain
    version with LOCAL's tolerances, and times it as on LOCAL;
  * replays the largest streamed item of each algorithm's run through the
    fused decode and its plain version on the card (bit-equal), and times
    it: the call (CUDA events around the copy from page-locked memory and
    the decode), the two kernels alone (``torch.profiler``) and the plain
    version, beside the byte bound (staged bytes in, 16 B per edge out).

Serving (multi-query, on the same graph, while the forward store exists).
The 8 highest out-degree vertices are the sources (query 0 is the BFS
source above).  It
  * runs a solo LOCAL ``segment`` BFS from each of the 8 sources on the
    card: the reference levels, iteration counts and counters;
  * serves them on LOCAL (``segment``, Q = 8): ``multi_bfs`` of sources
    0–7, each column bit-equal to its solo BFS with equal iteration
    counts; ``pairwise_reachability`` of the pairs s_k -> s_(k+1 mod 8),
    each answer equal to the solo levels' finiteness;
    ``personalized_pagerank`` of sources 0–7 (one iteration), query 0
    within rtol 1e-4 / atol 1e-7 of the numpy oracle ``ref_ppr``;
  * serves them on OOC (``block_csr``, chunks decoded on the card, Q = 8,
    a fresh spill): a ``GraphServeSession`` with 8 slots takes the first
    4 sources and drains — every result bit-equal to its solo BFS with
    its run and wait iterations those the solo counts imply, every
    logical counter equal to the sum of the 4 solo runs' (rtol 1e-5) and
    every shared-stream counter at most that sum (its counters after each
    step are kept for the DIST_OOC session); then
    ``personalized_pagerank`` of sources 0–7 (one iteration), values
    within 1e-5 of LOCAL serving's and every
    counter LOCAL reports within rtol 1e-5 of LOCAL's;
  * counts the launches of ``block_csr_combine_mq`` (set to 0 before the
    session and before PPR; each must have grown, in min and add mode),
    of the stencil and of the scans;
  * replays the largest panel-combine call of the session (min) and of
    PPR (add) against its plain version (min bit-equal, add within rtol
    1e-5) and against 8 solo ``block_csr_combine`` launches, one per
    column (bit-equal in both modes), and times it as above.

DIST_OOC (``executor="dist_ooc"``, W = 4 workers, ``block_csr``, chunks
and wire gap streams decoded on the card, ``verify_io``).  It
  * builds a sharded store of the forward graph (contiguous blocks of 2
    destination partitions per worker) beside the OOC stores;
  * runs PageRank (2) and BFS each cold with the workers in sequence
    (the per-worker split is the cold run's), then once more with
    ``parallel_workers``, with the launch
    counts of the combine, the fused decode, the stencil and the scans set
    to 0 just before each run and read just after: the combine and the
    fused decode must have run (at most two decode launches and one
    page-locked copy an item), the stencil and the add scan once per wire
    gap stream decoded on the card (counted around
    ``exchange._gap_decode``; more than 0 for BFS, whose batches are
    uniform-value), the max scan never;
  * requires measured == model for disk and network, every chunk read
    decoded on the card, the values equal to LOCAL's and OOC's (BFS bit
    for bit, PageRank within 1e-5) and the oracles', the iteration counts
    equal, every counter but the two network ones equal to LOCAL's (rtol
    1e-5) and to OOC's, and the parallel run bit-identical to the
    sequential one (values as int32 patterns, per-iteration returns,
    every counter, ``worker_totals``);
  * replays the largest combine call and the largest streamed item of
    each algorithm against their plain versions and times them as on
    OOC, and the wire's largest gap stream through the stencil and the
    add scan (bit-equal to their plain versions, timed as in phase 7) and
    through the whole gap decode (copy in, two launches, gaps back)
    against the host codec, timed on the host clock;
  * prints cold, warm and parallel seconds, each worker's host seconds
    per stage, the split per iteration, the wire's bytes and batches per
    format, and peak device memory.

DIST_OOC serving (``dist_ooc_serve``: the same W = 4 sharded store with
fresh Q = 8 spills, ``block_csr``, chunks and wire decoded on the card,
``verify_io``).  It
  * runs a ``GraphServeSession`` of 8 slots over the first 4 sources (the
    OOC session's queries, all admitted at once), workers in sequence:
    every result bit-equal to its solo BFS with its run and wait
    iterations those of the OOC session, logical counters equal to the
    sum of the 6 solo runs' and shared-stream ones at most that sum, and
    every counter but the two network ones equal to the OOC session's
    after as many steps (rtol 1e-5);
  * runs ``multi_bfs`` of sources 0–7 for one iteration
    (``DIST_MQ_ITERS``, cut from two to make room for ``lm_train``),
    sequential and then with ``parallel_workers``: bit-identical
    (levels as int32 patterns, per-iteration returns, every counter,
    ``worker_totals``);
  * runs ``personalized_pagerank`` of sources 0–7 (one iteration),
    sequential: within 1e-5 of LOCAL serving's, every counter but the two
    network ones within rtol 1e-5 of LOCAL's;
  * requires in every run measured == model for disk and network, every
    chunk read decoded on the card, ``block_csr_combine_mq`` launched and
    the solo combine not, at most two fused-decode launches and one
    page-locked copy an item, the stencil and the add scan once per wire
    gap stream decoded on the card (panels' and legacy items'), the max
    scan never;
  * replays the largest panel-combine call of the session (min) and of PPR
    (add) against the plain version and 8 solo launches, the largest
    panel gap stream through the stencil and the add scan, and the
    session's largest streamed item through the fused decode, each
    against its plain version and timed as above;
  * prints drain seconds, queries per second, p50 and max latency, steps,
    each worker's send / recv / post / take seconds per step, bytes per
    query (disk + measured net), the panel, legacy and worker-local
    batches (counted where ``Exchange.post_mq`` files them), and peak
    device memory.

Process mode (``proc_path``: DIST_OOC's W = 4 logical workers on 2 OS
ranks sharing the card, two workers each, over TCP sockets on the loopback,
spawned from this script; ``repro_torch.runtime.procworker.run_rank`` with
the reference's run specs, ``block_csr``, ``verify_io``).  The parent
writes the graph and its formats once as ``.npy`` files under
``.smoke_tmp/`` (the mesh ranks map the same files); each rank maps them,
opens the DIST phase's sharded store and loads the kernels the parent
built.  It
  * runs PageRank (2) and BFS failure-free, then BFS with
    ``FaultPlan.kill(1, pe=2, phase="recv")``: rank 1 exits with
    ``FAULT_EXIT``, rank 0 adopts workers 1 and 3, rolls the op back from
    its per-op block-store checkpoints and replays it;
  * requires every result (rank 0's of the recovery run) bit-identical to
    the DIST_OOC phase's in-thread run: values as int32 patterns,
    iterations, per-iteration returns, every counter, ``worker_totals``;
    the recovery at least one, worker 1 on rank 0; the other exit codes 0;
  * sets the DIST launch counts to 0 before each run in each rank and reads
    them after: summed over the ranks, the combine, the fused decode, the
    stencil and the add scan equal the in-thread run's (the max scan 0),
    and the payload bytes the ranks' sockets carried plus the bytes passed
    between two workers of one rank equal ``measured_net_bytes``;
  * rank 0 replays the largest combine call of PageRank (add) and of BFS
    (min), BFS's largest streamed item and largest wire gap stream
    against their plain versions and times them, as on DIST_OOC;
  * prints spawn and load seconds, per rank and run the wall seconds, peak
    device memory, per-op checkpoint seconds and bytes, wire frames,
    socket payload bytes, recovery seconds and launches.

Mesh (``mesh_path``: the SHARD_MAP executor, ``Engine(..., mesh=...)``
on 8 ``gloo`` ranks, one per partition, all on the one card, launched by
``repro_torch.core.mesh.run_mesh``).  Each rank maps the structures the
process-mode phase wrote
read-only and moves only its own partition's rows to the card, and loads
the kernels the parent built.  It
  * runs (a) PageRank (2) under ``block_csr`` with the physical exchange
    auto (on): within rtol/atol 1e-5 of LOCAL's, the counters
    ``tests/test_distributed_engine.py`` lists within rtol 1e-5 of LOCAL's,
    every iteration on the wire the largest need list implies (an
    all-active frontier ships every need list whole); (b) BFS from the
    source, same engine: levels and iterations bit-equal to LOCAL's, every
    counter but the mesh wire's within rtol 1e-5 of LOCAL's, at least one
    iteration compacted; (c) BFS with the exchange off, 3 iterations:
    bit-equal to LOCAL's BFS at that depth (run in the parent), every
    iteration dense, its per-iteration returns (b)'s; (d) ``multi_bfs`` of
    the 8
    serving sources (Q = 8, ``segment``, 2 iterations): bit-equal to the
    port's LOCAL ``multi_bfs`` with the same arguments (run in the parent
    just before), its counters within rtol 1e-5;
  * requires on every rank the same values and counters,
    ``measured_net_payload_elems == net_payload_elems`` (also checked
    inside every call), one ``block_csr_combine`` launch per rank per
    ProcessEdges in (a)-(c) (counts set to 0 before each run, summed over
    the ranks) and no ``block_csr_combine_mq`` launch;
  * replays the largest per-rank combine call of (a) (add) and of (b)
    (min), on the rank that made it, against the plain version (min
    bit-equal, add within rtol 1e-5) and times it as above;
  * prints spawn and load seconds, per iteration the exchange's wall
    seconds (the slowest rank's, staging copies included), its payload
    elements and bytes and whether it went compacted, per rank the compute
    and collective seconds and peak device memory.
``GraphServeSession`` on the mesh is host logic over
``process_edges_multi`` and is held by the CPU tests.

Kernel entry point (``repro_torch.kernels.ops``, after the graph phases
have freed the card).  Each call runs with its kernel's launch count set
to 0 just before it (the count must grow), is held against the kernel's
plain version, and is timed beside its bound and, where one PyTorch call
computes the same function, that call:
  * ``ops.spmv`` (``block_csr_spmv``, T = 8) on ``uniform_graph(2**21,
    2**25, seed=0, weighted=True)`` through ``ops.build_block_csr``'s
    padded layout (~12 GB of tiles), which its first call packs into the
    occupied cells of the live tiles (~0.56 GB, kept in the structure's
    dict; packed exactly once, and a second pack timed alone must equal
    it): within rtol/atol 1e-5 of the packed plain version, the dense
    plain version and the float64 edge oracle; library
    ``torch.sparse.mm``;
  * ``ops.attention`` (``flash_attention``) at Gemma2-9B widths (16 query
    heads, the 8 KV heads repeated to 16, head dim 256, bf16, 8,192
    positions, causal, q and k at variance 40 so the scores reach the
    softcap): global with softcap 50, local (window 4,096) with softcap
    50, global without softcap (library: SDPA), within rtol 2e-2 / atol
    1e-3 of the plain version; float32 global at 1,024 positions and local
    at 8,192 within 1e-5; and at Yi-6B widths (32 query heads, the 4 KV heads
    repeated to 32, head dim 128, bf16, 4,096 positions, global, no
    softcap; library SDPA) within rtol 2e-2 / atol 1e-3.  Each call also
    shows that the plain version without its causal mask, window or
    softcap falls outside the tolerance, so the check would catch a
    kernel that dropped one.  The bf16 calls take the tensor-core route,
    whose SASS must hold ``HGMMA`` and ``UTMALDG`` (checked after the
    build); the library calls' differences are reported, not checked.
    The softcapped calls' library call is ``torch.compile`` of
    ``flex_attention`` with a tanh ``score_mod`` and a causal / window
    ``block_mask``, its compile outside the timed window: a spawned
    process compiles the same calls while the graph is built, into the
    Inductor and Triton caches under the kernels' build directory, where
    this phase's compile finds them;
  * ``ops.gla`` (``gla_chunked``, chunk 128, batch 8 x 4,096 steps, bf16
    q / k / v) at RWKV6-1.6B widths (32 heads of 64, bonus u) and
    Zamba2-1.2B's Mamba2 (64 heads, state 64, include_current, a per-head
    decay): y within 2e-2 and the float32 state within 1e-4 of the plain
    version, through the tensor-core route (sub-chunks of 16, three
    kernels, whose SASS must hold ``HMMA``); and float32 q / k / v at
    RWKV6-1.6B widths through the CUDA-core route, y and state within
    1e-4.  Bound: the larger of the bytes and the lesser work of the
    chunked and the sub-chunked form (``gla_ops_ms``, products at the
    inputs' rate; both printed).
``--scale`` below 21 shrinks the spmv graph with the main one, and the
sequences and the GLA batch by the same factor (heads and widths stay).

LM serving (``lm_serve``, last, on a card freed of the earlier phases;
``repro_torch.models`` and ``repro_torch.serve``, plain torch: the
reference's models call no Pallas kernel).  It
  * builds Gemma2-9B (42 layers, local / global alternation, softcaps,
    post-norms, tied 256k vocabulary, head dim 256; 9.24 B parameters,
    18.5 GB in bf16) and Zamba2-1.2B (38 Mamba2 layers and the shared
    attention block every 6) at full width and depth in bf16, drawing the
    weights on the card from a seeded ``torch.Generator``;
  * serves each with a ``ServeSession`` of batch 4: a 32-token prompt fed
    through the cache, then 16 greedy steps; requires the tokens' shape
    and range and one more step's logits finite of shape [4, padded
    vocabulary]; prints init seconds, the session's steps and tokens per
    second (its first step included), peak device memory, 3 more steps'
    steady wall milliseconds a step, and from ``torch.profiler`` over 3
    more the device milliseconds and launches a step, the heaviest kernels
    and the device's idle share of a steady step;
  * cuts each to its first cycle (Gemma2: 2 layers, its local window cut
    to 16 so that the local layer's 16-slot ring buffer wraps and the
    forward masks the window; Zamba2: 6 Mamba2 layers and the shared
    block) in float32 with TF32 off, and requires
    the cached decode's logits at each of 64 positions (batch 2) within
    rtol = atol = 1e-3 of the teacher-forced forward's; prints the
    largest difference, then the phase's seconds.

LM training (``lm_train``, after LM serving; ``repro_torch.train``, plain
torch under autograd, as the reference's training path reaches no Pallas
kernel).  It
  * trains Zamba2-1.2B at full width and depth in bf16 with remat (each
    step of a stage's loop checkpointed), weights from a seed: 2 AdamW
    steps (float32 moments and masters, warmup 1) of ``TokenPipeline``
    batches of 8 sequences of 4,096 tokens as 4 microbatches of 2;
    requires every loss and grad norm finite, parameters moved and none
    NaN; prints seconds a step (the first apart), tokens per second, peak
    device memory, the losses and an estimate of the model's FLOP/s
    (6 x parameters x tokens over the step) beside the card's name and
    power limit;
  * cuts it to its first 6 Mamba2 layers and the shared block (full
    width), batches of 4 as 2 microbatches of 2: saves the state through
    ``CheckpointManager`` after step 2,
    restores it into a fresh state (``checkpoint_template``) and requires
    step 3's loss and every leaf of the new state bit-equal to the
    uninterrupted run's; times one more step and profiles another
    (device milliseconds, operations, heaviest kernels, idle share);
  * at that depth in float32 with TF32 off, requires 2 microbatches of a
    batch of 4 x 1,024 tokens to equal the whole batch: loss, ce and grad
    norm within rtol 1e-5, each first-moment leaf within rtol 1e-5 (Mamba2's
    ``A_log`` and ``dt_bias`` within 1e-5 x their conditioning over the
    per-token gradient terms), the parameters within the reference test's
    5e-2 / 5e-3.

LM training on a device mesh (``lm_train_mesh``, after ``lm_train``;
``repro_torch.sharding``, ``launch.mesh``, ``runtime.elastic``, DTensor on
a ('data', 'model') = (2, 2) ``DeviceMesh`` of 4 gloo ranks sharing the
card, ``run_mesh``).  Before the ranks start, the one-card loss of the
seed-0 weights on the first batch (a forward pass).  Then it
  * trains Zamba2-1.2B at full width and depth in bf16 with remat under
    ``plan_for(cfg, "train", mesh)`` (FSDP over 'data', the SSM heads,
    attention heads, FFN and vocab over 'model'): 2 AdamW steps of
    ``TokenPipeline`` batches of 4 sequences of 1,024 tokens (2 a data
    shard, one microbatch); requires step 1's loss within 1e-2 relative
    of the one-card loss and every loss and local shard finite; prints
    seconds a step, tokens per second, each rank's peak memory and each
    step's collectives (calls by kind, bytes, seconds:
    ``sharding.wire``), and the placements of a few leaves;
  * at its first 6 Mamba2 layers and the shared block in float32 with TF32
    off: step 1 on the mesh against the same step on one card (run by rank
    0 alone; loss and ce within rtol 1e-5, each first-moment leaf within
    1e-5 relative in its norm, ``A_log`` and ``dt_bias`` within 1e-5 x
    their conditioning, the grad norm within the bound those leaf
    tolerances imply, the parameters within 5e-2 / 5e-3); the state of
    step 1 saved logically unsharded, ``elastic_restart`` onto a (1, 2)
    mesh with ranks 2 and 3 idle, and step 2 there against the
    uninterrupted (2, 2) step 2 under the same tolerances; prints the
    largest difference per leaf class.

Long-context decode on the same mesh (``lm_long_decode``: the
``long_500k`` cell's context parallelism, ``plan_for(cfg, "long_decode",
mesh)``).  The ranks of ``lm_train_mesh`` go on, the training state freed:
  * Zamba2-1.2B at full width and depth in bf16 decodes 4 greedy tokens
    over 524,288 cached tokens, from position 524,284 (the last write lands
    in the last slot): ``cache_seq`` over 'data', ``kv_heads`` over
    'model', so each rank holds a quarter of the shared block's 25.8 GB of
    caches, drawn block by block from seeded generators (the same values on
    one card and on any mesh), with seeded Mamba2 states; each rank writes
    the token into its own shard and attends to its own slots, three
    all-reduces an attention layer making the softmax whole;
  * the same draws decoded in float32 at full depth (a quarter of 51.6 GB
    a rank), its first 6 layers in float32 over 65,536 slots, and
    RWKV6-1.6B at 4 layers in bf16 (the one-token ``seq`` the plan cuts
    over 'data'), 4 steps each.
After the ranks exit, the parent decodes the same four on one card, fed
rank 0's tokens, and requires, step by step: for a float32 run the tokens
equal and the logits within 1e-4 relative in their norm; for a bf16 run
the logits within 3x the one card's own bf16 error over the steps (its
logits against the same draws decoded in float32), and the tokens equal
but where the one-card top two lie within 3x the largest change bf16
rounding makes to a logit at that step (a near tie); it prints each rank's
cache and weight bytes, peak memory, seconds a step and collectives a step
by kind (calls, bytes, seconds).

The LM dry run (``dryrun``; ``repro_torch.launch.dryrun``: one step under
``FakeTensorMode`` as rank 0 of a fake process group, nothing allocated).
Four jobs start in spawned processes before ``kernel_ops`` and use only
the host's CPU: ``lm_train``'s step (unsharded, 4 microbatches through
``TRAIN_MICROBATCHES``), ``lm_train_mesh``'s step on its (2, 2) mesh,
``lm_long_decode``'s full-depth step on that mesh, and Gemma2-9B
``train_4k`` on the 256-rank production mesh.  After ``lm_train_mesh`` it
  * requires each predicted peak (rank 0's arguments plus the peak of live
    bytes the step created) within 0.75-1.25x of the step-1 peak the phase
    measured on the card;
  * requires rank 0's collective calls and operand bytes by kind equal to
    those ``lm_train_mesh``'s rank 0 counted in step 1 (``sharding.wire``),
    and the long-context decode step's equal to those of
    ``lm_long_decode``'s last full-depth step on rank 0, its predicted peak
    within 0.9-1.1x of that step's measured peak;
  * prints the production cell's per-rank memory, FLOPs, bytes,
    transcendentals and collectives (its artifact lands in
    ``artifacts/dryrun_torch/``) and each job's trace seconds.

Every phase prints one JSON line; the line before the last holds the
kernel table (each combine once per mode and path, each row measured on
that path's inputs beside that path's launches), the last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises and the script exits non-zero.  Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "block_csr_combine.cu"
TPU_KERNEL = "src/repro/kernels/csr_spmv.py:203"
TPU_KERNEL_MQ = "src/repro/kernels/csr_spmv.py:354"
VARINT_SOURCE = "varint.cu"
DECODE_SOURCE = "chunk_decode.cu"
TPU_SCAN = "src/repro/kernels/varint.py:88"
TPU_STENCIL = "src/repro/kernels/varint.py:159"
CSRC = "src/repro_torch/kernels/csrc/"
TPU_SPMV = "src/repro/kernels/csr_spmv.py:79"
TPU_FLASH = "src/repro/kernels/flash_attention.py:75"
TPU_GLA = "src/repro/kernels/gla_chunk.py:76"
SOURCES = (KERNEL_SOURCE, VARINT_SOURCE, DECODE_SOURCE, "block_csr_spmv.cu",
           "flash_attention.cu", "gla_chunk.cu")
DEVICE = "cuda"
LIBRARY_CALLS = {
    "add": "torch.cumsum(x, 0, dtype=torch.int32)",
    "max": "torch.cummax(x, 0) (values and indices, no 0 seed)",
    "stencil": None,    # no single PyTorch call decodes LEB128
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM, dense bf16 on the tensor cores
SPMV_TILE = 8
# kernel_ops widths: Gemma2-9B attention (src/repro/configs/gemma2_9b.py:
# 16 query heads, 8 KV heads, head dim 256, softcap 50, local window 4,096;
# 8,192 positions, Gemma 2's context), Yi-6B attention
# (configs/yi_6b.py: 32 query heads, 4 KV heads, head dim 128, global, no
# softcap; 4,096 positions, its context), RWKV6-1.6B time mix
# (configs/rwkv6_1_6b.py: 32 heads of 64, chunk 128) and Zamba2-1.2B's
# Mamba2 (configs/zamba2_1_2b.py: 64 heads = 2 x 2048 / 64, state 64,
# chunk 128), batch 8 x 4,096 steps for both GLA models
ATTN_MODELS = {   # name -> (query heads, KV heads, head dim)
    "gemma2-9b": (16, 8, 256),
    "yi-6b": (32, 4, 128),
}
GEMMA_SEQ, GEMMA_WINDOW, GEMMA_SOFTCAP = 8192, 4096, 50.0
YI_SEQ = 4096
# q and k are drawn with variance 40, so the scaled scores q.k / sqrt(D)
# have a standard deviation of 40 at any D and reach Gemma's softcap as
# trained Gemma logits do (at variance 1, tanh(s/50)*50 differs from s by
# ~1e-4)
SCORE_VAR = 40.0
GLA_SUB = 16     # sub-chunk of the least-work GLA count (gla_ops_ms)
GLA_BATCH, GLA_STEPS, GLA_CHUNK = 8, 4096, 128
GLA_MODELS = {   # name -> (heads, Dk, Dv, include_current, bonus)
    "rwkv6_1_6b": (32, 64, 64, False, True),
    "zamba2_1_2b_mamba2": (64, 64, 64, True, False),
}
PR_ITERS = 2                   # PageRank's iterations on every path (cut
                               # from 5 to make room for the dryrun phase)
SERVE_SOURCES = 8              # solo references (10 before PR 23)
SESSION_SOURCES = 4            # queries each session submits (cut from 6,
                               # and before that OOC 8 and DIST_OOC 10, to
                               # make room for later phases)
SERVE_Q = 8                    # concurrent query slots
PPR_ITERS = 1
DIST_MQ_ITERS = 1              # DIST serving's multi_bfs depth (cut from
                               # 2 to make room for the lm_train phase)


def emit(**obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILER_SESSIONS = 3    # sessions tried before a time is "not measured"


def device_ms(fn, reps=20, split=()):
    """(mean device milliseconds per call of ``fn``, device operations per
    call, {name: (milliseconds, operations) per call}) from one profiler
    session over ``reps`` calls: the summed durations of the kernels,
    copies and memsets it records on the card, and the same for the events
    whose name holds each name of ``split`` ((None, 0) for a name it
    recorded no event of).  Where a call's host path takes longer than its
    device work, :func:`cuda_ms` measures the host; this measures the card
    alone.  The profiler drops events more as a process ages, so up to
    ``PROFILER_SESSIONS`` sessions are tried; if none records a device
    operation it returns (None, 0, {}): not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    if not ops:
        return None, 0, {}
    per_call = lambda evs: (sum(e.time_range.elapsed_us() for e in evs)
                            / reps / 1e3, len(evs) / reps)
    by_name = {}
    for name in split:
        evs = [e for e in ops if name in e.name]
        by_name[name] = per_call(evs) if evs else (None, 0)
    return (*per_call(ops), by_name)


def bound(bytes_, ops_ms):
    """(bound ms, what binds): the larger of the bytes at the memory rate
    and the operations' time ``ops_ms``."""
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= ops_ms
            else (ops_ms, "operations"))


ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


def kernel_row(name, source, replaces, launches, row):
    """One row of the kernel table: ``source`` is the file under
    ``CSRC``, ``row`` holds the measured ``ROW_KEYS``."""
    return dict(name=name, route="cuda", source=CSRC + source,
                replaces=replaces, launches=launches,
                **{key: row[key] for key in ROW_KEYS})


@contextlib.contextmanager
def recorded_combine(module, largest=False, name="block_csr_combine"):
    """Record the arguments of one combine call the engine makes through
    ``module.<name>`` (``phases`` on LOCAL, ``executor`` on OOC,
    ``multiquery`` for the panel combine) inside the block: the first
    call, or with ``largest`` the call with the most tile slots — the
    kernel's inputs at the main path's shapes."""
    real = getattr(module, name)
    seen = {}

    def recording(*args, **kw):
        if not seen or (largest and
                        args[1].shape[1] > seen["args"][1].shape[1]):
            seen.update(args=args, kw=kw)
        return real(*args, **kw)

    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def live_slots(row_cnt):
    return int(row_cnt.sum())


def combine_bound_ms(args, mode):
    """Least time for one combine call on these inputs: every byte it must
    move (each live tile of each tile array it reads, the slot indices,
    the vector blocks the live tiles select — Q columns of them for a
    panel call — the row metadata, the two outputs) at the HBM rate, or
    its float32 operations at the float32 rate, whichever is larger."""
    import torch
    row_ptr, tile_idx, tile_col, row_cnt = args[:4]
    nq = args[7].shape[2] if args[7].dim() == 3 else 1
    q_cnt, n_rows = row_cnt.shape
    n_slots = tile_idx.shape[1]
    t = 8
    n_live = live_slots(row_cnt)
    n_tile_arrays = {"add": 2, "add_b": 3, "min": 2, "max": 2}[mode]
    # distinct (q, source block) pairs the live slots read
    pos = torch.arange(n_slots, device=row_cnt.device)[None, :]
    start = row_ptr[:, :-1].long()
    row_of = torch.searchsorted(row_ptr[:, 1:].contiguous(),
                                pos.expand(q_cnt, -1).contiguous(),
                                right=True).clamp(max=n_rows - 1)
    live = pos - torch.gather(start, 1, row_of) < torch.gather(
        row_cnt.long(), 1, row_of)
    cols = (torch.arange(q_cnt, device=row_cnt.device)[:, None] * 2**31
            + tile_col.long())[live]
    n_blocks = int(torch.unique(cols).numel())
    bytes_ = (n_live * (n_tile_arrays * t * t * 4 + 8)
              + q_cnt * n_rows * 8 + n_blocks * 2 * t * 4 * nq
              + 2 * q_cnt * n_rows * t * 4 * nq)
    products = {"add": 2, "add_b": 3, "min": 1, "max": 1}[mode]
    ops = n_live * t * t * 2 * nq * (products + (1 if mode in ("min", "max")
                                                 else 0))
    return (*bound(bytes_, ops / F32_FLOPS * 1e3), bytes_)


def library_call(args, kw):
    """One PyTorch library computation of the same function, for scale:
    add/add_b — one ``torch.sparse.mm`` of the live cells (value rows over
    [xv; xc] and count rows over xc in one CSR matrix) against the vector,
    or the [C*T, Q] panel of a panel call; min/max — the live cells'
    ``B + xv`` gathered and folded with ``scatter_reduce_`` (val only, all
    Q columns of a panel at once).  Returns a zero-argument callable."""
    import torch
    row_ptr, tile_idx, tile_col, row_cnt, tv, tb, tc, xv, xc = args
    mode, t, ident = kw["mode"], kw["tile"], kw["identity"]
    q_cnt, n_rows = row_cnt.shape
    n_slots, n_src = tile_idx.shape[1], xv.shape[1]
    panel = xv.dim() == 3
    dev = row_cnt.device
    counts = row_cnt.reshape(-1).long()
    owner = torch.repeat_interleave(torch.arange(q_cnt * n_rows,
                                                 device=dev), counts)
    j = torch.arange(owner.numel(), device=dev) - (
        torch.cumsum(counts, 0) - counts)[owner]
    q = owner // n_rows
    pos = row_ptr[:, :-1].reshape(-1).long()[owner] + j
    tid = q * n_slots + tile_idx.reshape(-1)[q * n_slots + pos].long()
    col = tile_col.reshape(-1)[q * n_slots + pos].long()
    cnt_cells = tc.reshape(-1, t, t)[tid]                      # [L, T, T]
    nz = cnt_cells != 0
    li, ri, ci = nz.nonzero(as_tuple=True)
    row = owner[li] * t + ri                                   # val row
    src = q[li] * n_src + col[li] * t + ci                     # vector idx
    n_out = q_cnt * n_rows * t
    if mode in ("min", "max"):
        b = tb.reshape(-1, t, t)[tid][nz]
        del cnt_cells, nz
        red = "amin" if mode == "min" else "amax"
        if panel:
            nq = xv.shape[2]
            xrows = xv.reshape(-1, nq)
            rows_q = row[:, None].expand(-1, nq)

            def call():
                out = torch.full((n_out, nq), ident, device=dev)
                return out.scatter_reduce_(0, rows_q, b[:, None] + xrows[src],
                                           reduce=red)
            return call
        xflat = xv.reshape(-1)

        def call():
            out = torch.full((n_out,), ident, device=dev)
            return out.scatter_reduce_(0, row, b + xflat[src], reduce=red)
        return call
    n_x = q_cnt * n_src
    rows = [row, n_out + row]
    cols_ = [src, n_x + src]
    vals = [tv.reshape(-1, t, t)[tid][nz], cnt_cells[nz]]
    if mode == "add_b":
        rows.append(row)
        cols_.append(n_x + src)
        vals.append(tb.reshape(-1, t, t)[tid][nz])
    del cnt_cells, nz
    a = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols_)]), torch.cat(vals),
        (2 * n_out, 2 * n_x), check_invariants=False
    ).coalesce().to_sparse_csr()
    if panel:
        x = torch.cat([xv.reshape(n_x, -1), xc.reshape(n_x, -1)])
    else:
        x = torch.cat([xv.reshape(-1), xc.reshape(-1)])[:, None]
    return lambda: torch.sparse.mm(a, x)


def hold_against_plain(csr, args, kw, panel=False):
    """One combine call (the panel combine with ``panel``) against its
    plain version on the same inputs: has-message counts exact, min/max
    bit-equal, add/add_b within rtol 1e-5; with ``panel`` also every column
    against a solo launch on that column (bit-equal in every mode).
    Returns (max |diff| against the plain version, extra fields)."""
    import torch
    mode = kw["mode"]
    kernel = csr.block_csr_combine_mq if panel else csr.block_csr_combine
    plain = (csr.block_csr_combine_mq_ref if panel
             else csr.block_csr_combine_ref)
    val, hc = kernel(*args, **kw)
    torch.cuda.synchronize()
    rval, rhc = plain(*args, **kw)
    if not torch.equal(hc, rhc):
        raise AssertionError(f"{mode}: has-message counts differ")
    err = float((val - rval).abs().max()) if val.numel() else 0.0
    if mode in ("min", "max"):
        if not torch.equal(val.view(torch.int32), rval.view(torch.int32)):
            raise AssertionError(f"{mode}: kernel is not bit-equal to the "
                                 f"plain version (max |diff| {err})")
    else:
        tol = 1e-5 * rval.abs() + 1e-30
        if not bool(((val - rval).abs() <= tol).all()):
            raise AssertionError(f"{mode}: kernel differs from the plain "
                                 f"version beyond rtol 1e-5 ({err})")
    del rval, rhc
    extra = {}
    if panel:
        # every column against a solo launch on that column: bit-equal
        for j in range(val.shape[2]):
            solo = list(args)
            solo[7], solo[8] = (args[7][..., j].contiguous(),
                                args[8][..., j].contiguous())
            sv, sh = csr.block_csr_combine(*solo, **kw)
            if not (torch.equal(val[..., j].view(torch.int32),
                                sv.view(torch.int32))
                    and torch.equal(hc[..., j], sh)):
                raise AssertionError(f"{mode}: panel column {j} is not "
                                     "bit-equal to a solo launch")
            del sv, sh, solo
        extra = dict(columns=int(val.shape[2]),
                     columns_bit_equal_to_solo=True)
    return err, extra


def check_kernel(csr, args, kw, path, reps=10, panel=False):
    """Kernel vs plain version on the same inputs (one call of ``path``,
    LOCAL or OOC; :func:`hold_against_plain`), then timed beside the plain
    version, one library call and the bound.  Returns the table row fields
    (times in ms)."""
    mode = kw["mode"]
    kernel = csr.block_csr_combine_mq if panel else csr.block_csr_combine
    plain = (csr.block_csr_combine_mq_ref if panel
             else csr.block_csr_combine_ref)
    err, extra = hold_against_plain(csr, args, kw, panel)
    ms = cuda_ms(lambda: kernel(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), 2)
    lib = library_call(args, kw)
    library_ms = cuda_ms(lib, 5)
    del lib
    bound, bound_by, bytes_ = combine_bound_ms(args, mode)
    emit(phase="kernel_vs_plain", mode=mode, path=path, max_abs_err=err,
         kernel_ms=ms, ref_ms=plain_ms, library_ms=library_ms,
         bound_ms=bound, bound_by=bound_by, bytes=bytes_,
         live_tiles=live_slots(args[3]),
         longest_row_tiles=int(args[3].max()),
         dest_partitions=int(args[3].shape[0]),
         row_blocks=int(args[3].shape[1]), **extra)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# combine_balance: the combine on synthetic row layouts, built on the card
# ---------------------------------------------------------------------------

def balance_rows(kind, k, tiles, n_dest, n_rows, gen, dev):
    """Live tiles per row [n_dest, n_rows] (int32, on ``dev``) of a
    synthetic layout with ``tiles`` live tiles in all: ``even`` — every
    row alike (a); ``hub`` — one row per destination holds 25% of that
    destination's tiles, the rest spread over runs of 64 rows between runs
    of 64 empty rows (b); ``edges`` — rows of K - 1, K, K + 1, 1, 0 and
    3K + 2 tiles, rotated per destination (c); ``single`` — one tile in
    the call; ``empty`` — none."""
    import torch
    per_dest = tiles // n_dest
    cnt = torch.zeros((n_dest, n_rows), dtype=torch.int64, device=dev)
    if kind == "even":
        cnt += per_dest // n_rows
        cnt[:, :per_dest % n_rows] += 1
    elif kind == "hub":
        run = min(64, max(1, n_rows // 8))
        full = ((torch.arange(n_rows, device=dev) // run) % 2 == 0)
        n_full = int(full.sum())
        hub_tiles = per_dest // 4
        rest = per_dest - hub_tiles
        for q in range(n_dest):
            rows = full.nonzero()[:, 0]
            hub = int(rows[torch.randint(n_full, (1,), generator=gen,
                                         device=dev)])
            others = rows[rows != hub]
            cnt[q, others] = rest // others.numel()
            cnt[q, others[:rest % others.numel()]] += 1
            cnt[q, hub] = hub_tiles
    elif kind == "edges":
        pattern = torch.tensor([k - 1, k, k + 1, 1, 0, 0, k + 1, k - 1,
                                3 * k + 2, k], device=dev)
        row = pattern.repeat(-(-n_rows // pattern.numel()))[:n_rows]
        cnt = torch.stack([row.roll(q) for q in range(n_dest)])
    elif kind == "single":
        cnt[n_dest - 1, n_rows // 2] = 1
    elif kind != "empty":
        raise ValueError(kind)
    return cnt.to(torch.int32)


def balance_call(row_cnt, gen, dev, n_src):
    """One combine call's structure and tiles for ``row_cnt`` on the card:
    each row followed by one dead slot, each destination's live tiles a
    random permutation of its slots over random source blocks of
    ``n_src`` cells, ~10% of tile cells holding an edge.  Returns the
    structure (row_ptr, tile_idx, tile_col, row_cnt), the tile arrays
    (cnt; v; b for add_b; b for min, identity in empty cells) and a
    per-column vector maker."""
    import torch
    q_cnt, n_rows = row_cnt.shape
    t = 8
    big = float(torch.finfo(torch.float32).max)
    row_ptr = torch.zeros((q_cnt, n_rows + 1), dtype=torch.int64,
                          device=dev)
    row_ptr[:, 1:] = torch.cumsum(row_cnt.long() + 1, 1)
    n_slots = int(row_ptr[:, -1].max())
    counts = row_cnt.reshape(-1).long()
    owner = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                    counts)
    first = torch.cumsum(counts, 0) - counts
    q = owner // n_rows
    j = torch.arange(owner.numel(), device=dev) - first[owner]
    pos = row_ptr[:, :-1].reshape(-1)[owner] + j
    # rank of each live slot among its destination's live slots
    per_q = row_cnt.long().sum(1)
    rank = torch.arange(owner.numel(), device=dev) - (
        torch.cumsum(per_q, 0) - per_q)[q]
    perm = torch.rand((q_cnt, n_slots), generator=gen,
                      device=dev).argsort(dim=1)
    tile_idx = torch.zeros((q_cnt, n_slots), dtype=torch.int64, device=dev)
    tile_col = torch.zeros_like(tile_idx)
    tile_idx[q, pos] = perm[q, rank]
    tile_col[q, pos] = torch.randint(n_src // t, (owner.numel(),),
                                     generator=gen, device=dev)
    del perm
    shape = (q_cnt, n_slots, t, t)
    edge = torch.rand(shape, generator=gen, device=dev) < 0.1
    tiles = dict(
        cnt=edge.float(),
        v=torch.where(edge, torch.rand(shape, generator=gen, device=dev),
                      0.0),
        b_add=torch.where(edge, torch.rand(shape, generator=gen,
                                           device=dev), 0.0),
        b_min=torch.where(edge, torch.rand(shape, generator=gen,
                                           device=dev), big))
    del edge
    struct = (row_ptr.to(torch.int32), tile_idx.to(torch.int32),
              tile_col.to(torch.int32), row_cnt)

    def vectors(ident, nq=None):
        vec = (q_cnt, n_src) + (() if nq is None else (nq,))
        mask = torch.rand(vec, generator=gen, device=dev) < 0.5
        xv = torch.where(mask, torch.randn(vec, generator=gen, device=dev),
                         ident)
        return xv.contiguous(), mask.float().contiguous()

    return struct, tiles, vectors


def mode_args(struct, tiles, vectors, mode, nq=None):
    """(args, kw) of one combine call in ``mode`` on a balance layout; max
    mirrors the min inputs."""
    big = 3.4028234663852886e38
    ident = {"add": 0.0, "add_b": 0.0, "min": big, "max": -big}[mode]
    xv, xc = vectors(ident, nq)
    tv = tiles["v"] if mode in ("add", "add_b") else None
    tb = {"add": None, "add_b": tiles["b_add"], "min": tiles["b_min"],
          "max": None}[mode]
    if mode == "max":
        tb = -tiles["b_min"]
    return ((*struct, tv, tb, tiles["cnt"], xv, xc),
            dict(mode=mode, tile=8, identity=ident))


BALANCE_TILES, BALANCE_DEST, BALANCE_ROWS = 4_000_000, 8, 8192
BALANCE_EDGE_ROWS = 1024       # rows per destination of layout (c)
BALANCE_SRC = 2 ** 20          # source cells per destination


def run_combine_balance(cut):
    """The combine_balance phase: both combine entry points on synthetic
    layouts built on the card from a seed — (a) 4,000,000 live tiles over
    8 destinations x 8,192 rows, rows even; (b) the same total with one
    row per destination holding 25% of its tiles beside runs of empty
    rows; (c) rows of K - 1, K and K + 1 tiles (K the kernel's unit), one
    tile, none — the solo kernel in all four modes, the panel kernel in
    min and add at Q = 8 and 16, each held against its plain version
    (:func:`hold_against_plain`).  Times the solo add and min kernels on
    (a) and (b); the balance ratio is add's time on (b) over (a).
    ``cut`` shrinks the tiles and rows for a rehearsal."""
    import torch
    from repro_torch.kernels import csr_spmv
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    k = csr_spmv._library().block_csr_combine_unit_slots()
    tiles = max(4000, BALANCE_TILES >> cut)
    rows = max(64, BALANCE_ROWS >> cut)
    t0 = time.perf_counter()
    times = {}
    layouts = (("a", "even", rows, tiles), ("b", "hub", rows, tiles),
               ("c", "edges", max(64, BALANCE_EDGE_ROWS >> cut), 0),
               ("c", "single", rows, 0), ("c", "empty", rows, 0))
    for label, kind, n_rows, n_tiles in layouts:
        row_cnt = balance_rows(kind, k, n_tiles, BALANCE_DEST, n_rows, gen,
                               dev)
        struct, tile_arrays, vectors = balance_call(row_cnt, gen, dev,
                                                    BALANCE_SRC >> cut)
        errs, ms = {}, {}
        for mode in ("add", "add_b", "min", "max"):
            args, kw = mode_args(struct, tile_arrays, vectors, mode)
            errs[mode], _ = hold_against_plain(csr_spmv, args, kw)
            if label in ("a", "b") and mode in ("add", "min"):
                ms[mode] = cuda_ms(
                    lambda: csr_spmv.block_csr_combine(*args, **kw), 10)
                ms[mode + "_bound"] = combine_bound_ms(args, mode)[0]
            del args
        for nq in (8, 16):
            for mode in ("min", "add"):
                args, kw = mode_args(struct, tile_arrays, vectors, mode, nq)
                errs[f"{mode}_q{nq}"], _ = hold_against_plain(
                    csr_spmv, args, kw, panel=True)
                del args
        if ms:
            times[label] = ms
        emit(phase="combine_balance", layout=label, kind=kind,
             unit_slots=k, dest_partitions=BALANCE_DEST, row_blocks=n_rows,
             live_tiles=int(row_cnt.sum()),
             longest_row_tiles=int(row_cnt.max()),
             empty_rows=int((row_cnt == 0).sum()), max_abs_err=errs,
             kernel_ms=ms)
        del struct, tile_arrays, vectors, row_cnt
        gc.collect()
        torch.cuda.empty_cache()
    ratio = {m: times["b"][m] / times["a"][m] for m in ("add", "min")}
    emit(phase="combine_balance", balance_ratio_add=ratio["add"],
         balance_ratio_min=ratio["min"], seconds=time.perf_counter() - t0)
    return ratio


# ---------------------------------------------------------------------------
# OOC: the stores, the decode on the card, the varint kernels
# ---------------------------------------------------------------------------

def store_stats(store):
    """Bytes on disk, chunks, the largest chunk, and how many chunks'
    dst residues sum to 2**31 or more (the reference's int32 device
    restore wraps there; the port's must not)."""
    from repro_torch.core import REP_DCSR, codec
    nbytes = sum(os.path.getsize(os.path.join(store.root, f))
                 for f in os.listdir(store.root)
                 if os.path.isfile(os.path.join(store.root, f)))
    chunks = list(store.nonempty_chunks())
    largest, wraps, best = None, [], -1
    for q, p, k in chunks:
        lay = store._layout_of(q)
        n_e = int(lay.edges[p, k])
        _, payload, _ = store.read_chunk_bytes(q, p, k, REP_DCSR)
        res = codec.varint_decode(payload[:int(lay.dstv_nb[p, k])], n_e)
        total = int(res.astype("int64").sum())
        if total >= 2**31:
            wraps.append(dict(q=q, p=p, k=k, edges=n_e, residue_sum=total))
        if n_e > best:
            best, largest = n_e, (q, p, k)
    store.reset_io_counters()
    return dict(bytes=nbytes, chunks=len(chunks), largest_chunk=largest,
                largest_chunk_edges=best, residue_sum_wraps=len(wraps),
                wrapping_chunks=wraps)


def decode_check(store, device):
    """Every chunk in one of the representations it stores, taken in turn
    (cut from every representation to make room for lm_train_mesh): the
    decode on the card (the fused decode, one chunk an item) bit-equal to
    the host codec.
    Returns the number of decodes checked and the fused decode's
    launches."""
    import torch
    from repro_torch.core import REP_CSR, REP_DCSR, REP_DCSR_DELTA
    from repro_torch.kernels import chunk_decode, varint
    chunk_decode.reset_launches()
    varint.reset_launches()
    checked = 0
    for i, (q, p, k) in enumerate(store.nonempty_chunks()):
        lay = store._layout_of(q)
        reps = (REP_DCSR, REP_DCSR_DELTA) + (
            (REP_CSR,) if lay.has_csr[p, k] else ())
        for rep in (reps[i % len(reps)],):
            index, payload, _ = store.read_chunk_bytes(q, p, k, rep)
            host = store.decode_chunk(q, p, k, rep, index, payload)
            dev = store.decode_chunk_device(q, p, k, rep, index, payload,
                                            device=device)
            for name, h, d in zip(("src", "dst", "data"), host, dev):
                ht = torch.from_numpy(h).to(device)
                if ht.dtype != d.dtype or not torch.equal(ht, d):
                    raise AssertionError(
                        f"chunk (q={q}, p={p}, k={k}) rep {rep}: device "
                        f"decode of {name} differs from the host codec")
            checked += 1
    torch.cuda.synchronize()
    store.reset_io_counters()
    launches = chunk_decode.decode_item.launches
    if not 0 < launches <= 2 * checked or varint.byte_stencil.launches \
            or varint.blocked_scan.launches:
        raise AssertionError(f"decode check: {launches} fused decode "
                             f"launches for {checked} chunks, or the "
                             "per-chunk chain ran")
    return checked, launches


@contextlib.contextmanager
def recorded_decode(device):
    """Record the largest item (most edges) the fused decode takes inside
    the block: its staged bytes in page-locked host memory and its plan,
    for a replay at the main path's shapes."""
    import torch
    from repro_torch.kernels import chunk_decode
    real = chunk_decode.decode_item
    seen = {}

    def recording(staged, plan):
        if not seen or plan.n_edges > seen["plan"].n_edges:
            host = torch.empty(plan.nbytes, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(staged[:plan.nbytes])   # zero status: not yet run
            seen.update(host=host, plan=plan)
        return real(staged, plan)

    # decode_item counts through its module's global name, which is the
    # recording wrapper inside the block: the counts go there and back
    for attr in ("launches", "calls"):
        setattr(recording, attr, getattr(real, attr))
    chunk_decode.decode_item = recording
    try:
        yield seen
    finally:
        chunk_decode.decode_item = real
        for attr in ("launches", "calls"):
            setattr(real, attr, getattr(recording, attr))


def check_decode_item(host, plan, device, reps=20):
    """The fused decode on one recorded item against its plain version on
    the card (bit-equal), and its times: the call (CUDA events around the
    copy from page-locked memory and the two launches), the kernels alone
    and the whole call on the card (``torch.profiler``; None where it
    records nothing), the plain version; beside the byte bound (the staged
    bytes read once, 16 B per edge written once)."""
    import torch
    from repro_torch.kernels import chunk_decode
    staged = torch.empty(plan.nbytes, dtype=torch.uint8, device=device)

    def call():
        staged.copy_(host, non_blocking=True)
        return chunk_decode.decode_item(staged, plan)

    out = call()
    ref = chunk_decode.decode_item_ref(host.to(device), plan)
    torch.cuda.synchronize()
    for name, o, r in zip(("src", "part", "dst", "data"), out, ref):
        if o.dtype != r.dtype or not torch.equal(o, r):
            raise AssertionError(f"fused decode: {name} differs from the "
                                 "plain version")
    del out, ref
    ms = cuda_ms(call, reps)
    card_ms, card_ops, split = device_ms(
        call, reps, split=("sections_kernel", "edges_kernel"))
    by_kernel = {name: ms for name, (ms, _) in split.items()}
    kernels = sum(n for _, n in split.values())
    kernel_ms = (sum(ms for ms, _ in split.values() if ms is not None)
                 if kernels else None)          # None: not measured
    plain_ms = cuda_ms(lambda: chunk_decode.decode_item_ref(staged, plan), 3)
    bytes_ = plan.nbytes + 16 * plan.n_edges
    bound_ms, bound_by = bound(bytes_, 0.0)
    return dict(edges=plan.n_edges, chunks=plan.n_chunks,
                tiles=plan.n_tiles, staged_bytes=plan.nbytes,
                max_abs_err=0.0, ms=ms, device_ms=kernel_ms,
                kernels_per_call=kernels, device_ms_by_kernel=by_kernel,
                card_ms=card_ms,
                card_ops_per_call=card_ops, plain_ms=plain_ms,
                library_ms=None, library="none: no single PyTorch call "
                "decodes LEB128", bound_ms=bound_ms, bound_by=bound_by,
                bytes=bytes_)


def varint_inputs(store, largest, device):
    """The stencil and scan inputs of two streams: the largest chunk's and
    partition 1's whole dst-residue section.  For each: the residue bytes
    (stencil), their decoded values (scan add, wrapping where the sums
    pass 2**31) and a forward-fill stream of positions (scan max: the
    chunk's run heads; the long stream's varint terminators)."""
    import numpy as np
    import torch
    from repro_torch.core import REP_DCSR, codec
    q, p, k = largest
    lay = store._layout_of(q)
    index, payload, _ = store.read_chunk_bytes(q, p, k, REP_DCSR)
    vnb, n_e = int(lay.dstv_nb[p, k]), int(lay.edges[p, k])
    heads = np.zeros(n_e, np.int32)
    heads[np.frombuffer(index, "<i4")[1::2]] = 1
    chunk_bytes = np.frombuffer(payload[:vnb], np.uint8)
    chunk_res = codec.varint_decode(chunk_bytes, n_e).astype(np.int32)
    pos = np.arange(n_e, dtype=np.int32)
    parts = []
    for qq, pp, kk in store.nonempty_chunks():
        if qq != 1:
            continue
        lay1 = store._layout_of(1)
        _, pay, _ = store.read_chunk_bytes(1, pp, kk, REP_DCSR)
        parts.append(np.frombuffer(pay[:int(lay1.dstv_nb[pp, kk])],
                                   np.uint8))
    long_bytes = np.concatenate(parts)
    long_res = codec.varint_decode(
        long_bytes, int(((long_bytes & 0x80) == 0).sum())).astype(np.int32)
    lpos = np.arange(long_bytes.size, dtype=np.int32)
    long_heads = np.where((long_bytes & 0x80) == 0, lpos, 0).astype(np.int32)
    store.reset_io_counters()
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return {
        "largest_chunk": dict(stencil=t(chunk_bytes), add=t(chunk_res),
                              max=t(np.where(heads > 0, pos, 0).astype(np.int32))),
        "partition_1": dict(stencil=t(long_bytes), add=t(long_res),
                            max=t(long_heads)),
    }


def check_varint_kernel(vk, name, x):
    """Kernel vs plain version (bit-equal) on ``x``; times the kernel, the
    plain version and the library call, beside the byte bound (scan: 8 B
    per element, stencil: 9 B per byte, at the card's memory rate), and
    the kernel's and the library's device time alone (:func:`device_ms`,
    with the device operations per call; None where not measured)."""
    import torch
    if name == "stencil":
        kern = lambda: vk.byte_stencil(x)
        plain = lambda: vk.byte_stencil_ref(x)
        library = None
        per_elem = 9
    else:
        kern = lambda: vk.blocked_scan(x, mode=name)
        plain = lambda: vk.blocked_scan_ref(x, mode=name)
        library = ((lambda: torch.cumsum(x, 0, dtype=torch.int32))
                   if name == "add" else (lambda: torch.cummax(x, 0)))
        per_elem = 8
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        if o.dtype != r.dtype or not torch.equal(o, r):
            raise AssertionError(f"varint {name}: the kernel is not "
                                 "bit-equal to its plain version")
    if library is not None and name == "add":
        if not torch.equal(library(), out):
            raise AssertionError("scan add differs from torch.cumsum")
    ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(plain, 5)
    library_ms = None if library is None else cuda_ms(library, 20)
    dev_ms, dev_ops, _ = device_ms(kern)
    lib_dev_ms = (None if library is None
                  else device_ms(library)[0])
    bytes_ = x.numel() * per_elem
    bound_ms, bound_by = bound(bytes_, 0.0)
    return dict(elements=x.numel(), max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                device_ms=dev_ms, device_ops_per_call=dev_ops,
                library_device_ms=lib_dev_ms,
                library=LIBRARY_CALLS[name] or "none: no single PyTorch "
                "call decodes LEB128",
                bound_ms=bound_ms, bound_by=bound_by,
                bytes=bytes_, gb_per_s=bytes_ / ms / 1e6)


SCAN_SWEEP = (2**10, 2**16, 2**20, 2**24)


def scan_sweep(vk, device):
    """Both scan modes at each length of ``SCAN_SWEEP`` on seeded int32
    inputs whose sums wrap: bit-equal to the plain version (add also to
    ``torch.cumsum``), timed beside ``torch.cumsum`` / ``torch.cummax`` and
    the byte bound (8 B per element), per call and on the card alone
    (:func:`device_ms`; None where the profiler records nothing).  One JSON
    line per length and mode."""
    import torch
    gen = torch.Generator(device=device).manual_seed(0)
    for n in SCAN_SWEEP:
        x = torch.randint(-50, 2**30, (n,), generator=gen, device=device,
                          dtype=torch.int32)
        for mode in ("add", "max"):
            out = vk.blocked_scan(x, mode=mode)
            if not torch.equal(out, vk.blocked_scan_ref(x, mode=mode)):
                raise AssertionError(f"scan sweep {mode} n={n}: the kernel "
                                     "is not bit-equal to its plain version")
            library = ((lambda: torch.cumsum(x, 0, dtype=torch.int32))
                       if mode == "add" else (lambda: torch.cummax(x, 0)))
            if mode == "add" and not torch.equal(library(), out):
                raise AssertionError(f"scan sweep add n={n}: differs from "
                                     "torch.cumsum")
            kern = lambda: vk.blocked_scan(x, mode=mode)
            ms = cuda_ms(kern, 20)
            library_ms = cuda_ms(library, 20)
            dev_ms, dev_ops, _ = device_ms(kern)
            bound_ms, bound_by = bound(8 * n, 0.0)
            emit(phase="scan_sweep", mode=mode, elements=n,
                 tiles=-(-n // vk._SCAN_TILE), ms=ms, library_ms=library_ms,
                 device_ms=dev_ms, device_ops_per_call=dev_ops,
                 library_device_ms=device_ms(library)[0],
                 library=LIBRARY_CALLS[mode], bound_ms=bound_ms,
                 bound_by=bound_by, gb_per_s=8 * n / ms / 1e6)
        del x, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="R-MAT scale (2**scale vertices); 21 by default")
    opts = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src_dir = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src_dir, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src_dir)
    # torch.compile's caches in the kernels' build directory: the library
    # calls of kernel_ops find there what a spawned process compiled
    build_dir = os.path.join(src_dir, "repro_torch", "kernels", "_build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build_dir, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(build_dir, "triton"))
    tmp_root = os.path.join(REPO, ".smoke_tmp")
    os.makedirs(tmp_root, exist_ok=True)
    from repro_torch.core import (
        Engine, EngineConfig, build_dist_graph, build_formats, make_spec,
        phases,
    )
    from repro_torch.core import algorithms as alg
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import (
        build, chunk_decode, csr_spmv, flash_attention, gla_chunk, varint,
    )

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # the numpy oracles of the LOCAL phase, on the host meanwhile
    oracles = start_oracles(opts.scale, tmp_root)

    # -- 2. kernel build: one nvcc per source, all started together -------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.load_library, SOURCES))
    csr_spmv._library()
    csr_spmv._spmv_library()
    varint._library()
    chunk_decode._library()
    flash_attention._library()
    gla_chunk._library()
    ptxas = {}
    for src_name in SOURCES:
        log = build.library_path(src_name).with_suffix(".log")
        ptxas[src_name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Performance Loss" in ln]
    def sass_counts(source, ops):
        sass = subprocess.run(
            [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
             "-sass", str(build.library_path(source))],
            capture_output=True, text=True, check=True,
            timeout=300).stdout.splitlines()
        counts = {op: sum(op in ln for ln in sass) for op in ops}
        if not all(counts.values()):
            raise AssertionError(f"{source}: its SASS lacks tensor-core or "
                                 f"TMA instructions ({counts})")
        return counts

    # the tensor-core attention route must compile to wgmma fed by TMA, the
    # GLA route to mma.sync
    attention_sass = sass_counts("flash_attention.cu", ("HGMMA", "UTMALDG"))
    gla_sass = sass_counts("gla_chunk.cu", ("HMMA",))
    emit(phase="kernel_build", seconds=time.perf_counter() - t0,
         sources=list(SOURCES), ptxas=ptxas,
         flash_attention_sass=attention_sass, gla_chunk_sass=gla_sass)

    # -- 2b. the combine on balanced and unbalanced synthetic rows --------
    run_combine_balance(max(0, 21 - opts.scale))
    # torch.compile of the library calls kernel_ops times, on the host
    # while the graph is built
    flex_warm = start_flex_warm(max(0, 21 - opts.scale))

    # -- 3. the graph ------------------------------------------------------
    t0 = time.perf_counter()
    g = rmat_graph(opts.scale, 16, seed=0, weighted=True)
    spec = make_spec(g, num_partitions=8)
    dg = build_dist_graph(g, spec)
    fm = build_formats(dg)
    n = g.num_vertices
    source = int(np.argmax(g.out_degrees()))
    emit(phase="graph", scale=opts.scale, edge_factor=16, seed=0,
         vertices=n, edges=g.num_edges, partitions=spec.num_partitions,
         batch_size=spec.batch_size, batches=spec.num_batches,
         v_max=spec.v_max, e_max=dg.e_max, source=source,
         host_seconds=time.perf_counter() - t0)

    blk_cfg = EngineConfig(compute_backend="block_csr", block_tile=8)
    seg_cfg = EngineConfig(compute_backend="segment")
    kernel_rows = {}
    local_results = {}

    def run_algorithm(name, make_engines, drive, check_values, path_mode,
                      check_modes=()):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        blk, seg = make_engines(blk_cfg), make_engines(seg_cfg)
        setup_s = time.perf_counter() - t0
        csr_spmv.block_csr_combine.launches = 0
        t0 = time.perf_counter()
        with recorded_combine(phases) as first:
            vals, stats = drive(blk)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = csr_spmv.block_csr_combine.launches
        if launches < 1:
            raise AssertionError(f"{name}: the block_csr path launched no "
                                 "kernel")
        if first["kw"]["mode"] != path_mode:
            raise AssertionError(f"{name}: ran mode {first['kw']['mode']}, "
                                 f"expected {path_mode}")
        t0 = time.perf_counter()
        drive(blk)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svals, sstats = drive(seg)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        check_values(vals)
        check_values(svals)
        same = bool(np.array_equal(vals, svals))
        if path_mode == "min" and not same:
            raise AssertionError(f"{name}: block_csr values differ from the "
                                 "segment backend's (a MIN fold is exact)")
        if stats.iterations != sstats.iterations:
            raise AssertionError(f"{name}: {stats.iterations} iterations, "
                                 f"segment backend {sstats.iterations}")
        for k, v in sstats.counters.items():
            if abs(stats.counters[k] - v) >= 1e-3:
                raise AssertionError(f"{name}: counter {k} = "
                                     f"{stats.counters[k]}, segment {v}")
        edges = stats.counters["edges_touched"]
        emit(phase="main_path", algorithm=name, iterations=stats.iterations,
             launches=launches, engine_setup_s=setup_s, cold_s=cold_s,
             warm_s=warm_s, segment_s=seg_s, edges_touched=edges,
             edges_per_s=edges / warm_s,
             segment_edges_per_s=edges / seg_s,
             same_values_as_segment=same,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        for mode in check_modes:
            args, kw = list(first["args"]), dict(first["kw"])
            if mode == "add_b":        # a second value tile array
                args[5] = args[4]
            if mode == "max":          # the min inputs, mirrored
                args[5], args[7] = -args[5], -args[7]
                kw["identity"] = -kw["identity"]
            kw["mode"] = mode
            kernel_rows[mode] = check_kernel(csr_spmv, tuple(args), kw,
                                             "local")
            del args
        # the next algorithm lowers its own slot: free these value tiles,
        # as a fresh engine would have
        for e in (blk if isinstance(blk, tuple) else (blk,)):
            e.free_value_tiles()
        del blk, seg, first
        gc.collect()
        torch.cuda.empty_cache()
        local_results[name] = (vals, stats)
        return launches

    # One engine per backend over the forward graph serves the four
    # algorithms (WCC adds the reversed graph's): its block tiles are built
    # once, in PageRank's cold run.
    fwd = {}

    def fwd_engines(cfg):
        if cfg.compute_backend not in fwd:
            fwd[cfg.compute_backend] = Engine(dg, fm, cfg)
        return fwd[cfg.compute_backend]

    def close(ref, rtol, atol):
        def check(v):
            np.testing.assert_allclose(v, ref, rtol=rtol, atol=atol)
        return check

    def exact(ref):
        def check(v):
            np.testing.assert_array_equal(v, ref)
        return check

    # -- 4. LOCAL, one algorithm at a time ----------------------------------
    ref = finish_oracles(oracles, source)
    checks = {
        "pagerank": close(ref["pagerank"], 1e-4, 1e-7),
        "bfs": exact(ref["bfs"]),
        "sssp": close(ref["sssp"], 1e-5, 1e-5),
        "wcc": exact(ref["wcc"].astype(np.float32)),
    }
    drives = {
        "pagerank": lambda e: alg.pagerank(e, PR_ITERS),
        "bfs": lambda e: alg.bfs(e, source),
        "sssp": lambda e: alg.sssp(e, source),
        "wcc": lambda pair: alg.wcc(*pair),
    }
    launches = {}
    launches["pagerank"] = run_algorithm(
        "pagerank", fwd_engines, drives["pagerank"], checks["pagerank"],
        "add", ("add", "add_b"))
    launches["bfs"] = run_algorithm(
        "bfs", fwd_engines, drives["bfs"], checks["bfs"], "min")
    launches["sssp"] = run_algorithm(
        "sssp", fwd_engines, drives["sssp"], checks["sssp"], "min")
    dg_rev = build_dist_graph(g.reversed(), spec)
    fm_rev = build_formats(dg_rev)

    def wcc_engines(cfg):
        return fwd_engines(cfg), Engine(dg_rev, fm_rev, cfg)

    launches["wcc"] = run_algorithm(
        "wcc", wcc_engines, drives["wcc"], checks["wcc"], "min",
        ("min", "max"))
    fwd.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4b. the Chaos- and GridGraph-like baselines against LOCAL ---------
    run_baselines_path(g, source=source, checks=checks,
                       local_results=local_results)

    tmp = tempfile.mkdtemp(prefix="stores-", dir=tmp_root)
    try:
        ooc = run_ooc(tmp, g=g, source=source, dg=dg, fm=fm, dg_rev=dg_rev,
                      fm_rev=fm_rev, checks=checks, drives=drives,
                      local_results=local_results)
        dist = run_dist_ooc(tmp, dg=dg, fm=fm, source=source, checks=checks,
                            drives=drives, local_results=local_results,
                            ooc_results=ooc.pop("results"))
        proc = run_proc_path(tmp, dg=dg, fm=fm, store=dist["store"],
                             source=source, scale=opts.scale,
                             dist=dist)
        dist_serve = run_dist_serve(dist.pop("store"), dg=dg, fm=fm,
                                    serving=ooc["serving"])
        mesh = run_mesh_path(tmp, dg=dg, fm=fm, source=source,
                             first=ooc["serving"]["sources"][:SERVE_Q],
                             local_results=local_results)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 10. the kernel entry point at full width, on a card freed of the
    # graph phases' memory ---------------------------------------------------
    del g, dg, fm, dg_rev, fm_rev, local_results, checks, drives
    gc.collect()
    torch.cuda.empty_cache()
    # the dry runs use the host's CPU, not the card: started here, joined
    # after the training phases they are held against
    dry = start_dryrun(tmp_root)
    ops_rows = run_kernel_ops(opts.scale, flex_warm)

    # -- 10b. the LM serving path at full width, on a freed card -----------
    gc.collect()
    torch.cuda.empty_cache()
    run_lm_serve()

    # -- 10c. LM training at full width and depth, on one card and on a
    # device mesh of 4 ranks sharing it -----------------------------------
    lm_train = run_lm_train(smi, tmp_root)
    lm_mesh = run_lm_train_mesh(smi, tmp_root)

    # -- 10d. the dry run's predictions against those two phases -----------
    finish_dryrun(dry, lm_train, lm_mesh, smi)

    # -- 11. the kernel table: combine rows per mode and path, each measured
    # on one call of that path and beside that path's launches only ------
    table = []
    for path, rows, counts in (
            ("LOCAL", kernel_rows, launches),
            ("OOC", ooc["combine_rows"],
             {a: v["combine"] for a, v in ooc["launches"].items()}),
            ("DIST_OOC", dist["combine_rows"],
             {a: v["combine"] for a, v in dist["launches"].items()})):
        for mode, algos in (("add", ("pagerank",)),
                            ("min", ("bfs", "sssp", "wcc"))):
            table.append(kernel_row(
                f"block_csr_combine[{mode}] {path}", KERNEL_SOURCE,
                TPU_KERNEL, sum(counts.get(a, 0) for a in algos),
                rows[mode]))
    serving = ooc["serving"]
    for mode in ("add", "min"):
        table.append(kernel_row(
            f"block_csr_combine_mq[{mode}] OOC", KERNEL_SOURCE,
            TPU_KERNEL_MQ, serving["launches"][mode]["combine_mq"],
            serving["rows"][mode]))
    # DIST_OOC multi-query: the panel combine per mode, the stencil and the
    # add scan on the wire's gap streams, the fused decode's largest item
    dlaunch = dist_serve["launches"]
    for mode in ("add", "min"):
        table.append(kernel_row(
            f"block_csr_combine_mq[{mode}] DIST_OOC", KERNEL_SOURCE,
            TPU_KERNEL_MQ,
            sum(v["combine_mq"] for v in dlaunch.values()
                if v["mode"] == mode), dist_serve["combine_rows"][mode]))
    for name, key, source_line in (
            ("blocked_scan[add] DIST_OOC multi-query wire", "add", TPU_SCAN),
            ("varint_stencil DIST_OOC multi-query wire", "stencil",
             TPU_STENCIL)):
        table.append(kernel_row(
            name, VARINT_SOURCE, source_line,
            sum(v[key] for v in dlaunch.values()),
            dist_serve["wire_rows"][key]))
    drow = dist_serve["decode_row"]
    table.append(kernel_row(
        f"chunk_decode DIST_OOC multi-query largest item ({drow['edges']} "
        "edges)", DECODE_SOURCE, TPU_STENCIL,
        sum(v["decode"] for v in dlaunch.values()), drow))
    # process mode: the DIST_OOC kernels in each of the OS ranks, launches
    # summed over the ranks of the failure-free runs, rank 0's replays
    plaunch = proc["launches"]
    for mode, run in (("add", "pagerank"), ("min", "bfs")):
        table.append(kernel_row(
            f"block_csr_combine[{mode}] DIST_OOC process mode "
            f"({PROC_RANKS} ranks)", KERNEL_SOURCE, TPU_KERNEL,
            plaunch[run]["combine"], proc["rows"]["combine", mode]))
    for name, key, source_file, source_line in (
            ("blocked_scan[add] DIST_OOC process-mode wire", "add",
             VARINT_SOURCE, TPU_SCAN),
            ("varint_stencil DIST_OOC process-mode wire", "stencil",
             VARINT_SOURCE, TPU_STENCIL),
            ("chunk_decode DIST_OOC process mode largest item", "decode",
             DECODE_SOURCE, TPU_STENCIL)):
        table.append(kernel_row(
            name, source_file, source_line,
            sum(v[key] for v in plaunch.values()), proc["rows"][key]))
    # the mesh: one solo combine launch per rank per ProcessEdges
    for mode in ("add", "min"):
        table.append(kernel_row(
            f"block_csr_combine[{mode}] mesh ({MESH_RANKS} ranks)",
            KERNEL_SOURCE, TPU_KERNEL, mesh["launches"][mode],
            mesh["combine_rows"][mode]))
    for name, key, source_line in (
            ("blocked_scan[add]", "add", TPU_SCAN),
            ("blocked_scan[max]", "max", TPU_SCAN),
            ("varint_stencil", "stencil", TPU_STENCIL)):
        table.append(kernel_row(
            name, VARINT_SOURCE, source_line,
            sum(v[key] for v in ooc["launches"].values()),
            ooc["kernel_rows"][key]))
    # the wire's gap streams on DIST_OOC: the stencil and the add scan
    for name, key, source_line in (
            ("blocked_scan[add] DIST_OOC wire", "add", TPU_SCAN),
            ("varint_stencil DIST_OOC wire", "stencil", TPU_STENCIL)):
        table.append(kernel_row(
            name, VARINT_SOURCE, source_line,
            sum(v[key] for v in dist["launches"].values()),
            dist["wire_rows"][key]))
    # the fused decode: the largest item of the OOC and of the DIST runs
    for path, res in (("OOC", ooc), ("DIST_OOC", dist)):
        biggest = max(res["decode_rows"].values(), key=lambda r: r["edges"])
        table.append(kernel_row(
            f"chunk_decode {path} largest item ({biggest['edges']} edges)",
            DECODE_SOURCE, TPU_STENCIL,
            sum(v["decode"] for v in res["launches"].values()), biggest))
    table.extend(ops_rows)
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _oracle_job(scale, out_path):
    """The LOCAL phase's numpy oracles (``ref_pagerank`` at ``PR_ITERS``,
    ``ref_bfs``, ``ref_sssp`` from the largest out-degree, ``ref_wcc``) on
    :func:`main`'s graph, made anew from its seed, saved to ``out_path``."""
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import algorithms as alg
    from repro_torch.data.graphs import rmat_graph
    g = rmat_graph(scale, 16, seed=0, weighted=True)
    n = g.num_vertices
    source = int(np.argmax(g.out_degrees()))
    np.savez(out_path, source=source,
             pagerank=alg.ref_pagerank(n, g.src, g.dst, PR_ITERS),
             bfs=alg.ref_bfs(n, g.src, g.dst, source),
             sssp=alg.ref_sssp(n, g.src, g.dst, g.data, source),
             wcc=alg.ref_wcc(n, g.src, g.dst))


def start_oracles(scale, tmp_root):
    """:func:`_oracle_job` in a spawned process: the host computes the
    oracles while the kernels build and the graph is partitioned."""
    import multiprocessing
    path = os.path.join(tempfile.mkdtemp(prefix="oracles-", dir=tmp_root),
                        "oracles.npz")
    proc = multiprocessing.get_context("spawn").Process(
        target=_oracle_job, args=(scale, path), daemon=True)
    proc.start()
    return proc, path, time.perf_counter()


def finish_oracles(started, source):
    """The oracles of :func:`start_oracles`, for the graph whose source
    vertex is ``source``."""
    import numpy as np
    proc, path, t0 = started
    t_wait = time.perf_counter()
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"the oracle process failed (exit "
                             f"{proc.exitcode})")
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    if int(ref.pop("source")) != source:
        raise AssertionError("the oracle process made another graph")
    emit(phase="oracles", wall_s=time.perf_counter() - t0,
         wait_s=time.perf_counter() - t_wait)
    return ref


def run_ooc(tmp, *, g, source, dg, fm, dg_rev, fm_rev, checks, drives,
            local_results):
    """The OOC phases (5–8) of :func:`main` on its graphs (forward and
    reversed), held against its oracle ``checks`` and LOCAL results, then
    the serving phase (9) on the forward store; the stores live under
    ``tmp``.  Returns the per-algorithm launch counts, the kernel rows and
    the serving results."""
    import numpy as np
    import torch
    from repro_torch.core import ChunkStore, Engine, EngineConfig, executor
    from repro_torch.core.chunkstore import StagingRing
    from repro_torch.core.engine import COUNTER_KEYS, MEASURED_PAIRS
    from repro_torch.kernels import chunk_decode, csr_spmv, varint
    dev = torch.device(DEVICE)

    # -- 5. the stores -------------------------------------------------------
    stores = {}
    for name, (gg, ff) in (("fwd", (dg, fm)), ("rev", (dg_rev, fm_rev))):
        t0 = time.perf_counter()
        stores[name] = ChunkStore.build(gg, ff, os.path.join(tmp, name))
        build_s = time.perf_counter() - t0
        st = store_stats(stores[name])
        emit(phase="ooc_store", store=name, build_s=build_s, **st)
        if name == "fwd":
            largest = st["largest_chunk"]

    # -- 6. every chunk of the forward store decoded on the card == the host
    # codec (the reversed store's too before PR 23; its chunks still decode
    # on the card in OOC WCC, against LOCAL's labels) ------------------------
    t0 = time.perf_counter()
    checked, decode_launches = decode_check(stores["fwd"], dev)
    emit(phase="decode_check", store="fwd", decodes_checked=checked,
         fused_decode_launches=decode_launches,
         seconds=time.perf_counter() - t0)

    # -- 7. the varint kernels against their plain versions ------------------
    kernel_rows = {}
    inputs = varint_inputs(stores["fwd"], largest, dev)
    for stream, xs in inputs.items():
        for key in ("add", "max", "stencil"):
            row = check_varint_kernel(varint, key, xs[key])
            emit(phase="kernel_vs_plain", kernel=key, input=stream, **row)
            if stream == "largest_chunk":
                kernel_rows[key] = row
    del inputs
    scan_sweep(varint, dev)
    varint.reset_launches()

    # -- 8. the OOC path, one algorithm at a time ----------------------------
    cfg = EngineConfig(executor="ooc", compute_backend="block_csr")
    results, launches, combine_rows, decode_rows = {}, {}, {}, {}
    for name in ("pagerank", "bfs", "sssp", "wcc"):
        engines = [Engine(dg, fm, cfg, store=stores["fwd"])]
        if name == "wcc":
            engines.append(Engine(dg_rev, fm_rev, cfg,
                                  store=stores["rev"]))
        if not all(e.device_decode for e in engines):
            raise AssertionError("device_decode is not on by default on "
                                 "the card")
        arg = tuple(engines) if name == "wcc" else engines[0]
        torch.cuda.reset_peak_memory_stats()
        varint.reset_launches()
        chunk_decode.reset_launches()
        csr_spmv.block_csr_combine.launches = 0
        copies = StagingRing.copies
        t0 = time.perf_counter()
        with recorded_combine(executor, largest=True) as largest_call, \
                recorded_decode(dev) as largest_item:
            vals, stats = drives[name](arg)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = decode_counts(combine=csr_spmv.block_csr_combine.launches)
        counts["pinned_copies"] = StagingRing.copies - copies
        launches[name] = counts
        check_decode_counts(counts, f"ooc {name}", "combine")
        peak = torch.cuda.max_memory_allocated()
        c = stats.counters
        if c["measured_chunks_device_decoded"] != c["measured_chunks_read"]:
            raise AssertionError(f"ooc {name}: not every chunk read was "
                                 "decoded on the card")
        for mk, ak in MEASURED_PAIRS:
            if abs(c[mk] - c[ak]) > 0.5:
                raise AssertionError(f"ooc {name}: {mk} {c[mk]} != {ak} "
                                     f"{c[ak]}")
        checks[name](vals)
        lvals, lstats = local_results[name]
        if name == "pagerank":
            np.testing.assert_allclose(vals, lvals, rtol=1e-5, atol=1e-5)
        elif not np.array_equal(vals.view(np.int32), lvals.view(np.int32)):
            raise AssertionError(f"ooc {name}: values differ from LOCAL's")
        if stats.iterations != lstats.iterations:
            raise AssertionError(f"ooc {name}: {stats.iterations} "
                                 f"iterations, LOCAL {lstats.iterations}")
        for k in COUNTER_KEYS:
            a, b = c[k], lstats.counters[k]
            if abs(a - b) > 1e-3 + 1e-5 * abs(b):
                raise AssertionError(f"ooc {name}: counter {k} = {a}, "
                                     f"LOCAL {b}")
        # the kernel against its plain version on OOC's own inputs: the
        # streamed batch with the most tiles (all-active first iteration)
        mode = largest_call["kw"]["mode"]
        if mode != ("add" if name == "pagerank" else "min"):
            raise AssertionError(f"ooc {name}: ran combine mode {mode}")
        if name in ("pagerank", "wcc"):
            combine_rows[mode] = check_kernel(
                csr_spmv, largest_call["args"], largest_call["kw"], "ooc")
        del largest_call
        decode_rows[name] = check_decode_item(largest_item["host"],
                                              largest_item["plan"], dev)
        emit(phase="kernel_vs_plain", kernel="chunk_decode",
             input=f"ooc {name} largest item", **decode_rows[name])
        del largest_item
        # cold runs only (the smoke's time limit): the split is the cold
        # run's host wall per iteration
        split = {k: sum(e.ooc_wall[k] for e in engines) / stats.iterations
                 for k in engines[0].ooc_wall}
        edges = c["edges_touched"]
        disk = (c["measured_edge_read_bytes"]
                + c["measured_vertex_read_bytes"]
                + c["measured_vertex_write_bytes"])
        emit(phase="ooc_path", algorithm=name, iterations=stats.iterations,
             launches=counts, cold_s=cold_s, edges_touched=edges,
             edges_per_s=edges / cold_s, split_of="cold",
             chunks_read=c["measured_chunks_read"],
             chunks_device_decoded=c["measured_chunks_device_decoded"],
             measured_edge_read_bytes=c["measured_edge_read_bytes"],
             measured_disk_bytes=disk, max_memory_allocated=peak,
             split_per_iteration_s=split)
        results[name] = (vals, stats)
        del engines, arg
        gc.collect()
        torch.cuda.empty_cache()

    serving = run_serving(stores["fwd"], g=g, source=source, dg=dg, fm=fm,
                          bfs_oracle=checks["bfs"])
    return dict(launches=launches, kernel_rows=kernel_rows,
                combine_rows=combine_rows, decode_rows=decode_rows,
                serving=serving, results=results)


def decode_counts(**extra):
    """The decode's launch counts since they were last set to 0: the fused
    decode's launches and calls (items), the stencil's and the scans'."""
    from repro_torch.kernels import chunk_decode, varint
    return dict(extra, decode=chunk_decode.decode_item.launches,
                decode_items=chunk_decode.decode_item.calls,
                stencil=varint.byte_stencil.launches,
                add=varint.blocked_scan.launches_by_mode["add"],
                max=varint.blocked_scan.launches_by_mode["max"])


def check_decode_counts(counts, path, combine):
    """The path's combine and fused decode ran, at most two decode
    launches an item, and the per-chunk chain (stencil, scans) not at
    all."""
    if counts[combine] < 1 or counts["decode"] < 1:
        raise AssertionError(f"{path}: the combine or the fused decode was "
                             f"never launched ({counts})")
    if counts["decode"] > 2 * counts["decode_items"]:
        raise AssertionError(f"{path}: more than two decode launches an "
                             f"item ({counts})")
    if counts["stencil"] or counts["add"] or counts["max"]:
        raise AssertionError(f"{path}: the per-chunk decode chain ran "
                             f"({counts})")


# ---------------------------------------------------------------------------
# DIST_OOC: W workers over a sharded store, the wire's gap streams on the card
# ---------------------------------------------------------------------------

DIST_WORKERS = 4
DIST_ALGOS = ("pagerank", "bfs")


@contextlib.contextmanager
def recorded_gap_streams():
    """Count the wire gap streams decoded on the card inside the block
    (each one stencil and one add scan launch) and record the largest
    one's bytes and varint count, for a replay at the wire's shapes; the
    multi-query panels' union streams are also counted and recorded apart
    (``panel_streams``, ``largest_panel``).  The takes that decode them
    run under the executor's compute token, one at a time."""
    from repro_torch.core import exchange
    real, real_panel = exchange._gap_decode, exchange.mq_decode_panel
    seen = {"streams": 0, "largest": None, "panel_streams": 0,
            "largest_panel": None}
    in_panel = threading.local()

    def recording(stream, count, device=None):
        if device is not None and count:
            keys = ["largest"]
            seen["streams"] += 1
            if getattr(in_panel, "on", False):
                seen["panel_streams"] += 1
                keys.append("largest_panel")
            for key in keys:
                if seen[key] is None or len(stream) > len(seen[key][0]):
                    seen[key] = (stream, count)
        return real(stream, count, device)

    def panel(*args, **kw):
        in_panel.on = True
        try:
            return real_panel(*args, **kw)
        finally:
            in_panel.on = False

    exchange._gap_decode = recording
    exchange.mq_decode_panel = panel
    try:
        yield seen
    finally:
        exchange._gap_decode = real
        exchange.mq_decode_panel = real_panel


def reset_dist_counts():
    """Set the DIST path's launch counts to 0; returns the page-locked
    copy count to measure from."""
    from repro_torch.core.chunkstore import StagingRing
    from repro_torch.kernels import chunk_decode, csr_spmv, varint
    varint.reset_launches()
    chunk_decode.reset_launches()
    csr_spmv.block_csr_combine.launches = 0
    return StagingRing.copies


def dist_counts(gaps, copies0):
    """The DIST path's launch counts since :func:`reset_dist_counts`,
    beside the number of gap streams the wire decoded on the card."""
    from repro_torch.core.chunkstore import StagingRing
    from repro_torch.kernels import csr_spmv
    counts = decode_counts(combine=csr_spmv.block_csr_combine.launches)
    counts["pinned_copies"] = StagingRing.copies - copies0
    counts["gap_streams"] = gaps["streams"]
    return counts


def check_dist_counts(counts, path, wire_streams_expected,
                      combine="combine"):
    """The combine (``counts[combine]``) and the fused decode ran (at most
    two decode launches an item, one page-locked copy an item), the
    stencil and the add scan once per gap stream decoded on the card, the
    max scan never."""
    if counts[combine] < 1 or counts["decode"] < 1:
        raise AssertionError(f"{path}: the combine or the fused decode was "
                             f"never launched ({counts})")
    if counts["decode"] > 2 * counts["decode_items"] or \
            counts["pinned_copies"] != counts["decode_items"]:
        raise AssertionError(f"{path}: decode launches or page-locked "
                             f"copies do not fit the items ({counts})")
    if not (counts["stencil"] == counts["add"] == counts["gap_streams"]) \
            or counts["max"]:
        raise AssertionError(f"{path}: the wire's stencil / scan launches "
                             f"do not match its gap streams ({counts})")
    if wire_streams_expected and counts["gap_streams"] < 1:
        raise AssertionError(f"{path}: no wire gap stream was decoded on "
                             f"the card ({counts})")


def check_wire_stream(stream, count, device, reps=20):
    """The wire's largest gap stream: the stencil and the add scan (on the
    stencil's terminator flags, as ``varint_decode`` runs it) against their
    plain versions bit for bit, timed (:func:`check_varint_kernel`); and
    the whole gap decode as the wire runs it — a copy to the card, the two
    launches, the gaps back — against the host codec, bit for bit, timed
    on the host clock.  Returns (stencil row, add row, round trip).

    This replay comes late in a long process, in which the profiler has
    been recording a falling share of the device's operations (2.0 of the
    fused decode's 2 kernels a call early on, 1.0 in the DIST replays):
    where it records none, the card-alone time is reported as not
    measured (None); the CUDA-event times stand."""
    import numpy as np
    import torch
    from repro_torch.core import exchange
    from repro_torch.kernels import varint
    buf = torch.from_numpy(np.frombuffer(stream, np.uint8).copy()).to(device)
    rows = {"stencil": check_varint_kernel(varint, "stencil", buf)}
    term, _ = varint.byte_stencil(buf)
    rows["add"] = check_varint_kernel(varint, "add", term)
    want = exchange._gap_decode(stream, count)
    got = exchange._gap_decode(stream, count, device)
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError("wire gap decode on the card differs from the "
                             "host codec")

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    trip = dict(bytes=len(stream), varints=count,
                card_round_trip_ms=host_ms(
                    lambda: exchange._gap_decode(stream, count, device)),
                host_codec_ms=host_ms(
                    lambda: exchange._gap_decode(stream, count)))
    return rows["stencil"], rows["add"], trip


def run_dist_ooc(tmp, *, dg, fm, source, checks, drives, local_results,
                 ooc_results):
    """The DIST_OOC phase (9b) of :func:`main`: a W = 4 sharded store of
    the forward graph under ``tmp``, PageRank and BFS each cold
    sequential, then once with ``parallel_workers``; held against LOCAL,
    OOC, the oracles and themselves.  Returns the launch counts, the
    combine and decode rows and the wire's stencil / scan rows."""
    import numpy as np
    import torch
    from repro_torch.core import ChunkStore, Engine, EngineConfig, executor
    from repro_torch.core.engine import COUNTER_KEYS, DIST_MEASURED_PAIRS
    from repro_torch.kernels import csr_spmv
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    store = ChunkStore.build_sharded(dg, fm, os.path.join(tmp, "dist"),
                                     DIST_WORKERS)
    emit(phase="dist_store", workers=DIST_WORKERS,
         partitions_per_worker=[list(s.partitions) for s in store.shards],
         build_s=time.perf_counter() - t0,
         bytes=sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(store.root) for f in fs))

    def engine(parallel):
        return Engine(dg, fm, EngineConfig(
            executor="dist_ooc", num_workers=DIST_WORKERS,
            compute_backend="block_csr", verify_io=True,
            parallel_workers=parallel), store=store)

    launches, combine_rows, decode_rows, largest_stream = {}, {}, {}, None
    results = {}
    for name in DIST_ALGOS:
        eng = engine(False)
        if not eng.device_decode:
            raise AssertionError("dist_ooc: device_decode is not on by "
                                 "default on the card")
        torch.cuda.reset_peak_memory_stats()
        copies0 = reset_dist_counts()
        t0 = time.perf_counter()
        with recorded_combine(executor, largest=True) as largest_call, \
                recorded_decode(dev) as largest_item, \
                recorded_gap_streams() as gaps:
            vals, stats = drives[name](eng)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = dist_counts(gaps, copies0)
        launches[name] = counts
        check_dist_counts(counts, f"dist_ooc {name}", name == "bfs")
        peak = torch.cuda.max_memory_allocated()
        totals = [dict(t) for t in eng.worker_totals]
        c = stats.counters
        for mk, ak in DIST_MEASURED_PAIRS:
            if abs(c[mk] - c[ak]) > 0.5:
                raise AssertionError(f"dist_ooc {name}: {mk} {c[mk]} != "
                                     f"{ak} {c[ak]}")
        if c["measured_chunks_device_decoded"] != c["measured_chunks_read"]:
            raise AssertionError(f"dist_ooc {name}: not every chunk read "
                                 "was decoded on the card")
        checks[name](vals)
        lvals, lstats = local_results[name]
        ovals, ostats = ooc_results[name]
        if name == "pagerank":
            np.testing.assert_allclose(vals, lvals, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-5)
        elif not (np.array_equal(vals.view(np.int32), lvals.view(np.int32))
                  and np.array_equal(vals.view(np.int32),
                                     ovals.view(np.int32))):
            raise AssertionError(f"dist_ooc {name}: values differ from "
                                 "LOCAL's or OOC's")
        if not stats.iterations == lstats.iterations == ostats.iterations:
            raise AssertionError(f"dist_ooc {name}: {stats.iterations} "
                                 f"iterations, LOCAL {lstats.iterations}, "
                                 f"OOC {ostats.iterations}")
        # every counter but the wire's (W = 4 workers cross fewer node
        # boundaries than P = 8 partitions) against LOCAL's (rtol 1e-5:
        # LOCAL sums its counters in float32) and OOC's (both price on the
        # host in float64: equal, seek_cost's float32 terms within 1e-9)
        for k in COUNTER_KEYS:
            if k in ("net_bytes", "net_bytes_raw"):
                continue
            a, b, o = c[k], lstats.counters[k], ostats.counters[k]
            if abs(a - b) > 1e-3 + 1e-5 * abs(b) or (
                    a != o and abs(a - o) > 1e-9 * abs(o)):
                raise AssertionError(f"dist_ooc {name}: counter {k} = {a}, "
                                     f"LOCAL {b}, OOC {o}")
        mode = largest_call["kw"]["mode"]
        if mode != ("add" if name == "pagerank" else "min"):
            raise AssertionError(f"dist_ooc {name}: ran combine mode {mode}")
        combine_rows[mode] = check_kernel(
            csr_spmv, largest_call["args"], largest_call["kw"], "dist_ooc")
        del largest_call
        decode_rows[name] = check_decode_item(largest_item["host"],
                                              largest_item["plan"], dev)
        emit(phase="kernel_vs_plain", kernel="chunk_decode",
             input=f"dist_ooc {name} largest item", **decode_rows[name])
        del largest_item
        if gaps["largest"] is not None and (
                largest_stream is None
                or len(gaps["largest"][0]) > len(largest_stream[0])):
            largest_stream = gaps["largest"]

        results[name] = dict(values=vals, stats=stats, totals=totals,
                             cold_s=cold_s)
        # the cold run's per-worker host split (the smoke's time limit
        # leaves no warm run)
        times = [dict(t) for t in eng.worker_times]
        it = stats.iterations
        split = {k: sum(t[k] for t in times) / it
                 for k in executor.DIST_WALL_KEYS}
        del eng
        gc.collect()

        # parallel workers: bit-identical to the sequential cold run
        par = engine(True)
        copies0 = reset_dist_counts()
        t0 = time.perf_counter()
        with recorded_gap_streams() as pgaps:
            pvals, pstats = drives[name](par)
        torch.cuda.synchronize()
        par_s = time.perf_counter() - t0
        pcounts = dist_counts(pgaps, copies0)
        check_dist_counts(pcounts, f"dist_ooc {name} parallel",
                          name == "bfs")
        if not np.array_equal(pvals.view(np.int32), vals.view(np.int32)) \
                or pstats.iterations != stats.iterations \
                or pstats.per_iter_return != stats.per_iter_return \
                or pstats.counters != stats.counters \
                or par.worker_totals != totals:
            raise AssertionError(f"dist_ooc {name}: the parallel run is not "
                                 "bit-identical to the sequential one")
        par_times = [dict(t) for t in par.worker_times]
        del par
        gc.collect()
        torch.cuda.empty_cache()
        edges = c["edges_touched"]
        emit(phase="dist_ooc_path", algorithm=name, workers=DIST_WORKERS,
             iterations=it, launches=counts, parallel_launches=pcounts,
             cold_s=cold_s, parallel_s=par_s,
             edges_touched=edges, edges_per_s=edges / cold_s,
             chunks_read=c["measured_chunks_read"],
             chunks_device_decoded=c["measured_chunks_device_decoded"],
             measured_disk_bytes=(c["measured_edge_read_bytes"]
                                  + c["measured_vertex_read_bytes"]
                                  + c["measured_vertex_write_bytes"]),
             measured_net_bytes=c["measured_net_bytes"],
             net_bytes_model=c["net_bytes"],
             batches={f: c[f"net_{f}_batches"]
                      for f in ("pair", "vpair", "slab", "uval")},
             worker_totals=totals, worker_times_cold=times,
             worker_times_parallel=par_times,
             split_per_iteration_s=split,
             wire_s_per_iteration=split["post_s"] + split["take_s"],
             max_memory_allocated=peak, parallel_bit_identical=True)

    if largest_stream is None:
        raise AssertionError("dist_ooc: no wire gap stream was recorded")
    stencil_row, add_row, trip = check_wire_stream(*largest_stream, dev)
    for key, row in (("stencil", stencil_row), ("add", add_row)):
        emit(phase="kernel_vs_plain", kernel=key,
             input="dist_ooc largest wire gap stream", **row)
    emit(phase="dist_wire_round_trip", **trip)
    return dict(launches=launches, combine_rows=combine_rows,
                decode_rows=decode_rows,
                wire_rows={"stencil": stencil_row, "add": add_row},
                store=store, results=results)


def expected_waits(iters, slots):
    """The wait iterations of queries submitted in order to a
    ``GraphServeSession`` of ``slots`` slots, each converging after its
    solo iteration count ``iters[k]``: a step admits pending queries into
    free slots in order, runs every occupied slot once and frees those
    that reached their count; every query still pending then waits one
    more iteration."""
    pending, running, waits = list(range(len(iters))), {}, [0] * len(iters)
    while pending or running:
        while pending and len(running) < slots:
            running[pending.pop(0)] = 0
        for k in list(running):
            running[k] += 1
            if running[k] >= iters[k]:
                del running[k]
        for k in pending:
            waits[k] += 1
    return waits


def check_session(results, sources, solo, path):
    """A drained session answered every source once, each result bit-equal
    to its solo BFS, its run iterations the solo count and its wait
    iterations those the solo counts imply (:func:`expected_waits`)."""
    import numpy as np
    if sorted(r.source for r in results) != sorted(sources):
        raise AssertionError(f"{path}: not every query was answered")
    waits = dict(zip(sources, expected_waits(
        [solo[s][1].iterations for s in sources], SERVE_Q)))
    for r in results:
        lv, st = solo[r.source]
        if not np.array_equal(r.levels.view(np.int32), lv.view(np.int32)):
            raise AssertionError(f"{path}: query from {r.source} differs "
                                 "from its solo BFS")
        if (r.wait_iters, r.run_iters) != (waits[r.source], st.iterations):
            raise AssertionError(
                f"{path}: query from {r.source} waited / ran "
                f"{(r.wait_iters, r.run_iters)}, expected "
                f"{(waits[r.source], st.iterations)}")


def check_session_counters(c, sources, solo, path):
    """A session's logical counters equal the sum of its queries' solo
    runs' (rtol 1e-5: the solo runs sum in float32) and its shared-stream
    counters are at most that sum.  Returns the sum."""
    from repro_torch.core import accumulate_counters
    solo_sum = {}
    for s in sources:
        solo_sum = accumulate_counters(solo_sum, solo[s][1].counters)
    for k in ("msgs_generated", "msgs_sent", "edges_touched",
              "vertex_read_bytes", "vertex_write_bytes"):
        if abs(c[k] - solo_sum[k]) > 1e-3 + 1e-5 * abs(solo_sum[k]):
            raise AssertionError(f"{path}: logical counter {k} = {c[k]}, "
                                 f"sum of the solo runs {solo_sum[k]}")
    for k in ("chunks_read", "seek_cost", "edge_read_bytes", "net_bytes"):
        if c[k] > solo_sum[k] * (1 + 1e-5) + 1e-3:
            raise AssertionError(f"{path}: shared-stream counter {k} = "
                                 f"{c[k]} exceeds the solo runs' sum "
                                 f"{solo_sum[k]}")
    return solo_sum


@contextlib.contextmanager
def recorded_mq_posts():
    """Count the multi-query batches the wire carries inside the block, by
    the entry each :meth:`Exchange.post_mq` files: worker-local hand-offs,
    shared-index panels, and legacy batches (with their solo-format
    items)."""
    from repro_torch.core import exchange
    real = exchange.Exchange._put_entry
    seen = {"local": 0, "panel": 0, "legacy": 0, "legacy_items": 0}
    lock = threading.Lock()
    kinds = {"local_mq": "local", "wire_mq_panel": "panel",
             "wire_mq_legacy": "legacy"}

    def recording(self, src_worker, dst_worker, q, p, entry):
        with lock:
            seen[kinds[entry[0]]] += 1
            if entry[0] == "wire_mq_legacy":
                seen["legacy_items"] += len(entry[1])
        return real(self, src_worker, dst_worker, q, p, entry)

    exchange.Exchange._put_entry = recording
    try:
        yield seen
    finally:
        exchange.Exchange._put_entry = real


def run_dist_serve(store, *, dg, fm, serving):
    """The DIST_OOC serving phase (9c) of :func:`main`, on the W = 4
    sharded store of :func:`run_dist_ooc` with fresh Q = 8 spills:
    (a) a ``GraphServeSession`` of 8 slots over the OOC session's
    ``SESSION_SOURCES`` sources, workers in sequence
    (:func:`check_session`, :func:`check_session_counters`, and every
    counter but the network's equal to the OOC session's over the steps
    before the first query joins); (b) ``multi_bfs`` of sources 0–7 for
    ``DIST_MQ_ITERS`` iterations, sequential and then with
    ``parallel_workers``,
    bit-identical; (c) ``personalized_pagerank`` of sources 0–7 within
    1e-5 of LOCAL serving's, every counter but the network's within rtol
    1e-5 of LOCAL's.  Every run checks measured == model for disk and
    wire, every chunk decoded on the card, and its launches.  Then the
    largest panel-combine call of (a) (min) and of (c) (add), the largest
    panel gap stream and the largest streamed item are replayed against
    their plain versions and timed.  Returns the launch counts per run
    and the kernel rows."""
    import numpy as np
    import torch
    from repro_torch.core import (
        Engine, EngineConfig, GraphServeSession, multiquery,
    )
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import (
        COUNTER_KEYS, DIST_MEASURED_PAIRS, MEASURED_KEYS,
    )
    from repro_torch.kernels import csr_spmv
    dev = torch.device(DEVICE)
    net_keys = ("net_bytes", "net_bytes_raw")
    sources, solo = serving["sources"], serving["solo"]
    first = sources[:SERVE_Q]
    for shard in store.shards:                 # fresh Q = 8 spills
        shutil.rmtree(os.path.join(shard.root, "vertex"), ignore_errors=True)

    def engine(parallel):
        return Engine(dg, fm, EngineConfig(
            executor="dist_ooc", num_workers=DIST_WORKERS,
            compute_backend="block_csr", num_queries=SERVE_Q,
            verify_io=True, parallel_workers=parallel), store=store)

    def reset():
        copies0 = reset_dist_counts()
        csr_spmv.block_csr_combine_mq.launches = 0
        torch.cuda.reset_peak_memory_stats()
        return copies0

    def read_counts(gaps, copies0, path, mode):
        counts = dist_counts(gaps, copies0)
        counts["combine_mq"] = csr_spmv.block_csr_combine_mq.launches
        counts["mode"] = mode
        if counts["combine"]:
            raise AssertionError(f"{path}: the solo combine ran ({counts})")
        check_dist_counts(counts, path, True, combine="combine_mq")
        return counts

    def check_io(c, path):
        if c["measured_chunks_device_decoded"] != c["measured_chunks_read"]:
            raise AssertionError(f"{path}: not every chunk read was decoded "
                                 "on the card")
        for mk, ak in DIST_MEASURED_PAIRS:
            if abs(c[mk] - c[ak]) > 0.5:
                raise AssertionError(f"{path}: {mk} {c[mk]} != {ak} {c[ak]}")

    def close_counters(got, want, path, keys):
        for k in keys:
            if k in net_keys:
                continue
            a, b = got[k], want[k]
            if abs(a - b) > 1e-3 + 1e-5 * abs(b):
                raise AssertionError(f"{path}: counter {k} = {a}, "
                                     f"expected {b}")

    eng = engine(False)
    if not eng.device_decode:
        raise AssertionError("dist_ooc serving: device_decode is not on by "
                             "default on the card")
    launches = {}

    # -- (a) the session: 8 slots, the OOC session's SESSION_SOURCES sources
    sources = sources[:SESSION_SOURCES]
    sess = GraphServeSession(eng)
    for s in sources:
        sess.submit(s)
    copies0 = reset()
    results, step_s, step_workers, step_counters = [], [], [], []
    t0 = time.perf_counter()
    with recorded_combine(multiquery, largest=True,
                          name="block_csr_combine_mq") as big_min, \
            recorded_decode(dev) as big_item, \
            recorded_gap_streams() as gaps, recorded_mq_posts() as posts:
        while sess.in_flight:
            before = [dict(t) for t in eng.worker_times]
            t1 = time.perf_counter()
            results.extend(sess.step())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            step_counters.append(dict(sess.counters))
            step_workers.append([
                {k: t[k] - b[k] for k in ("send_s", "recv_s", "post_s",
                                          "take_s")}
                for t, b in zip(eng.worker_times, before)])
    drain_s = time.perf_counter() - t0
    launches["session"] = read_counts(gaps, copies0, "dist session", "min")
    if not gaps["panel_streams"] or not posts["panel"]:
        raise AssertionError(f"dist session: no panel crossed the wire "
                             f"({gaps['panel_streams']}, {posts})")
    if big_min["kw"]["mode"] != "min":
        raise AssertionError(f"dist session ran combine mode {big_min['kw']}")
    peak = torch.cuda.max_memory_allocated()
    check_session(results, sources, solo, "dist session")
    for r in results:
        if r.source in serving["session_iters"] and \
                (r.wait_iters, r.run_iters) != \
                serving["session_iters"][r.source]:
            raise AssertionError(
                f"dist session: query from {r.source} waited / ran "
                f"{(r.wait_iters, r.run_iters)}, OOC session "
                f"{serving['session_iters'][r.source]}")
    c = sess.counters
    check_io(c, "dist session")
    check_session_counters(c, sources, solo, "dist session")
    # Until its first admission after the start (none, with no more queries
    # than slots), the session runs the same queries as the OOC session
    # (the first SESSION_SOURCES sources, all admitted at once): their
    # counters to that step agree but for the network's.
    first_join = min([r.wait_iters for r in results if r.wait_iters]
                     or [sess.steps])
    ooc_steps = serving["session_step_counters"]
    shared = min(first_join, len(ooc_steps))
    close_counters(step_counters[shared - 1], ooc_steps[shared - 1],
                   f"dist session, first {shared} steps",
                   COUNTER_KEYS + MEASURED_KEYS)
    disk = (c["measured_edge_read_bytes"] + c["measured_vertex_read_bytes"]
            + c["measured_vertex_write_bytes"])
    walls = np.array([r.wall_s for r in results])
    emit(phase="dist_ooc_serve_session", queries=len(sources),
         slots=SERVE_Q, workers=DIST_WORKERS, steps=sess.steps,
         drain_s=drain_s, queries_per_s=len(sources) / drain_s,
         p50_wall_s=float(np.median(walls)), max_wall_s=float(walls.max()),
         wait_iters=[r.wait_iters for r in results],
         run_iters=[r.run_iters for r in results], step_s=step_s,
         worker_s_per_step=step_workers, launches=launches["session"],
         measured_disk_bytes=disk,
         measured_net_bytes=c["measured_net_bytes"],
         net_bytes_model=c["net_bytes"],
         bytes_per_query=(disk + c["measured_net_bytes"]) / len(sources),
         steps_equal_to_ooc_session=shared,
         batches=posts, solo_format_batches={
             f: c[f"net_{f}_batches"] for f in ("pair", "vpair", "slab",
                                               "uval")},
         panel_gap_streams=gaps["panel_streams"],
         worker_totals=[dict(t) for t in eng.worker_totals],
         chunks_read=c["measured_chunks_read"],
         chunks_device_decoded=c["measured_chunks_device_decoded"],
         max_memory_allocated=peak)
    largest_panel = gaps["largest_panel"]
    del sess, results

    # -- (b) multi_bfs, DIST_MQ_ITERS: sequential, then parallel -----------
    runs = {}
    for parallel in (False, True):
        e = eng if not parallel else engine(True)
        e.reset_worker_totals()
        copies0 = reset()
        t0 = time.perf_counter()
        with recorded_gap_streams() as bgaps:
            levels, st = alg.multi_bfs(e, first, max_iters=DIST_MQ_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        name = "multi_bfs_parallel" if parallel else "multi_bfs"
        launches[name] = read_counts(bgaps, copies0, f"dist {name}", "min")
        check_io(st.counters, f"dist {name}")
        runs[parallel] = (levels, st, [dict(t) for t in e.worker_totals],
                          secs, torch.cuda.max_memory_allocated())
        if parallel:
            del e
    (lv, st, tot, seq_s, seq_peak), (plv, pst, ptot, par_s, par_peak) = \
        runs[False], runs[True]
    same_returns = len(st.per_iter_return) == len(pst.per_iter_return) and \
        all(np.array_equal(a, b) for a, b in zip(st.per_iter_return,
                                                 pst.per_iter_return))
    if not (np.array_equal(lv.view(np.int32), plv.view(np.int32))
            and st.iterations == pst.iterations and same_returns
            and st.counters == pst.counters and tot == ptot):
        raise AssertionError("dist multi_bfs: the parallel run is not "
                             "bit-identical to the sequential one")
    for j, s in enumerate(first):
        want_it = min(DIST_MQ_ITERS, solo[s][1].iterations)
        if st.iterations[j] != want_it:
            raise AssertionError(f"dist multi_bfs: query {j} ran "
                                 f"{st.iterations[j]} iterations, want "
                                 f"{want_it}")
    emit(phase="dist_ooc_serve_multi_bfs", queries=SERVE_Q,
         max_iters=DIST_MQ_ITERS,
         iterations=st.iterations, sequential_s=seq_s, parallel_s=par_s,
         launches=launches["multi_bfs"],
         parallel_launches=launches["multi_bfs_parallel"],
         worker_totals=tot, parallel_bit_identical=True,
         max_memory_allocated=max(seq_peak, par_peak))
    del runs, lv, plv

    # -- (c) personalized PageRank of sources 0-7 --------------------------
    eng.reset_worker_totals()
    copies0 = reset()
    t0 = time.perf_counter()
    with recorded_combine(multiquery, largest=True,
                          name="block_csr_combine_mq") as big_add, \
            recorded_gap_streams() as pgaps, recorded_mq_posts() as pposts:
        ppr, pstats = alg.personalized_pagerank(eng, first, PPR_ITERS)
    torch.cuda.synchronize()
    ppr_s = time.perf_counter() - t0
    launches["ppr"] = read_counts(pgaps, copies0, "dist ppr", "add")
    if big_add["kw"]["mode"] != "add":
        raise AssertionError(f"dist ppr ran combine mode {big_add['kw']}")
    check_io(pstats.counters, "dist ppr")
    np.testing.assert_allclose(ppr, serving["ppr_local"], rtol=0, atol=1e-5)
    close_counters(pstats.counters, serving["ppr_local_counters"],
                   "dist ppr", COUNTER_KEYS)
    times = [dict(t) for t in eng.worker_times]
    emit(phase="dist_ooc_serve_ppr", queries=SERVE_Q, iterations=PPR_ITERS,
         seconds=ppr_s, max_abs_diff_vs_local=float(
             np.abs(ppr - serving["ppr_local"]).max()),
         launches=launches["ppr"], batches=pposts,
         panel_gap_streams=pgaps["panel_streams"],
         measured_net_bytes=pstats.counters["measured_net_bytes"],
         measured_edge_read_bytes=pstats.counters[
             "measured_edge_read_bytes"],
         worker_times=times,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if pgaps["largest_panel"] is not None and (
            largest_panel is None
            or len(pgaps["largest_panel"][0]) > len(largest_panel[0])):
        largest_panel = pgaps["largest_panel"]
    del eng, ppr
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) the path's kernels replayed on its own inputs -----------------
    rows = {}
    for mode, call in (("min", big_min), ("add", big_add)):
        rows[mode] = check_kernel(csr_spmv, call["args"], call["kw"],
                                  "dist_ooc serving", reps=5, panel=True)
    del big_min, big_add
    stencil_row, add_row, trip = check_wire_stream(*largest_panel, dev)
    for key, row in (("stencil", stencil_row), ("add", add_row)):
        emit(phase="kernel_vs_plain", kernel=key,
             input="dist_ooc serving largest panel gap stream", **row)
    emit(phase="dist_serve_wire_round_trip", **trip)
    decode_row = check_decode_item(big_item["host"], big_item["plan"], dev)
    emit(phase="kernel_vs_plain", kernel="chunk_decode",
         input="dist_ooc session largest item", **decode_row)
    return dict(launches=launches, combine_rows=rows,
                wire_rows={"stencil": stencil_row, "add": add_row},
                decode_row=decode_row)


def run_serving(store, *, g, source, dg, fm, bfs_oracle):
    """The serving phase (9) of :func:`main`: solo references, LOCAL
    serving and OOC serving of the highest out-degree sources on the
    forward ``store`` (its vertex spill is replaced by a fresh Q = 8 one).
    Returns the panel-combine launch counts per mode and its kernel rows."""
    import numpy as np
    import torch
    from repro_torch.core import (
        Engine, EngineConfig, GraphServeSession, multiquery,
    )
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import COUNTER_KEYS, MEASURED_PAIRS
    from repro_torch.kernels import chunk_decode, csr_spmv, varint
    n = g.num_vertices
    f32_max = np.float32(np.finfo(np.float32).max)
    sources = [int(v) for v in np.argsort(-g.out_degrees(),
                                          kind="stable")[:SERVE_SOURCES]]
    if sources[0] != source:
        raise AssertionError("serving: query 0 is not the BFS source")
    first = sources[:SERVE_Q]

    # -- 9a. solo references: LOCAL segment BFS from every source ----------
    t0 = time.perf_counter()
    seg = Engine(dg, fm, EngineConfig(compute_backend="segment"))
    solo = {s: alg.bfs(seg, s) for s in sources}
    torch.cuda.synchronize()
    bfs_oracle(solo[source][0])
    emit(phase="serve_solo", sources=sources,
         iterations=[solo[s][1].iterations for s in sources],
         seconds=time.perf_counter() - t0)
    del seg

    # -- 9b. LOCAL serving (segment, Q = 8) --------------------------------
    local = Engine(dg, fm, EngineConfig(num_queries=SERVE_Q))
    t0 = time.perf_counter()
    levels, mstats = alg.multi_bfs(local, first)
    torch.cuda.synchronize()
    bfs_s = time.perf_counter() - t0
    for j, s in enumerate(first):
        lv, st = solo[s]
        if not np.array_equal(levels[:, j].view(np.int32), lv.view(np.int32)):
            raise AssertionError(f"local multi_bfs: column {j} differs from "
                                 "its solo BFS")
        if mstats.iterations[j] != st.iterations:
            raise AssertionError(f"local multi_bfs: query {j} ran "
                                 f"{mstats.iterations[j]} iterations, solo "
                                 f"{st.iterations}")
    pairs = [(first[k], first[(k + 1) % SERVE_Q]) for k in range(SERVE_Q)]
    reach, _ = alg.pairwise_reachability(local, pairs)
    want = [bool(solo[s][0][d] < f32_max) for s, d in pairs]
    if [bool(r) for r in reach] != want:
        raise AssertionError(f"pairwise_reachability {list(reach)} != {want}")
    t0 = time.perf_counter()
    ppr_local, ppr_lstats = alg.personalized_pagerank(local, first,
                                                      PPR_ITERS)
    torch.cuda.synchronize()
    ppr_s = time.perf_counter() - t0
    np.testing.assert_allclose(
        ppr_local[:, 0], alg.ref_ppr(n, g.src, g.dst, source, PPR_ITERS),
        rtol=1e-4, atol=1e-7)
    emit(phase="serve_local", queries=SERVE_Q, multi_bfs_s=bfs_s,
         multi_bfs_iterations=mstats.iterations, reachable=want,
         ppr_iterations=PPR_ITERS, ppr_s=ppr_s,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del local
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9c. OOC serving: a session of 8 slots takes the first sources ----
    shutil.rmtree(os.path.join(store.root, "vertex"))  # fresh Q = 8 spill
    eng = Engine(dg, fm, EngineConfig(executor="ooc",
                                      compute_backend="block_csr",
                                      num_queries=SERVE_Q), store=store)
    if not eng.device_decode:
        raise AssertionError("device_decode is not on by default on the card")

    def reset():
        varint.reset_launches()
        chunk_decode.reset_launches()
        csr_spmv.block_csr_combine_mq.launches = 0
        eng.ooc_wall = dict.fromkeys(eng.ooc_wall, 0.0)
        torch.cuda.reset_peak_memory_stats()

    def read_counts(path):
        counts = decode_counts(
            combine_mq=csr_spmv.block_csr_combine_mq.launches)
        check_decode_counts(counts, f"serving {path}", "combine_mq")
        return counts

    def check_io(c, path):
        if c["measured_chunks_device_decoded"] != c["measured_chunks_read"]:
            raise AssertionError(f"serving {path}: not every chunk read was "
                                 "decoded on the card")
        for mk, ak in MEASURED_PAIRS:
            if abs(c[mk] - c[ak]) > 0.5:
                raise AssertionError(f"serving {path}: {mk} {c[mk]} != {ak} "
                                     f"{c[ak]}")

    session_sources = sources[:SESSION_SOURCES]
    sess = GraphServeSession(eng)
    for s in session_sources:
        sess.submit(s)
    reset()
    results, step_s, step_counters = [], [], []
    t0 = time.perf_counter()
    with recorded_combine(multiquery, largest=True,
                          name="block_csr_combine_mq") as big_min:
        while sess.in_flight:
            t1 = time.perf_counter()
            results.extend(sess.step())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            step_counters.append(dict(sess.counters))
    drain_s = time.perf_counter() - t0
    launches = {"min": read_counts("session")}
    if big_min["kw"]["mode"] != "min":
        raise AssertionError(f"session ran combine mode {big_min['kw']}")
    split = {k: v / sess.steps for k, v in eng.ooc_wall.items()}
    peak = torch.cuda.max_memory_allocated()
    check_session(results, session_sources, solo, "ooc session")
    session_iters = {r.source: (r.wait_iters, r.run_iters) for r in results}
    c = sess.counters
    check_io(c, "session")
    solo_sum = check_session_counters(c, session_sources, solo,
                                      "ooc session")
    disk = (c["measured_edge_read_bytes"] + c["measured_vertex_read_bytes"]
            + c["measured_vertex_write_bytes"])
    walls = np.array([r.wall_s for r in results])
    emit(phase="serve_ooc_session", queries=len(session_sources),
         slots=SERVE_Q, steps=sess.steps, drain_s=drain_s,
         queries_per_s=len(session_sources) / drain_s,
         p50_wall_s=float(np.median(walls)), max_wall_s=float(walls.max()),
         wait_iters=[r.wait_iters for r in results],
         run_iters=[r.run_iters for r in results],
         step_s=step_s, split_per_step_s=split, launches=launches["min"],
         measured_disk_bytes=disk, net_bytes=c["net_bytes"],
         bytes_per_query=(disk + c["net_bytes"]) / len(session_sources),
         solo_disk_bytes=solo_sum["edge_read_bytes"]
         + solo_sum["vertex_read_bytes"] + solo_sum["vertex_write_bytes"],
         solo_net_bytes=solo_sum["net_bytes"],
         shared_over_solo={k: c[k] / solo_sum[k] for k in (
             "chunks_read", "seek_cost", "edge_read_bytes", "net_bytes")
             if solo_sum[k]},
         chunks_read=c["measured_chunks_read"],
         chunks_device_decoded=c["measured_chunks_device_decoded"],
         max_memory_allocated=peak)
    del sess, results

    # -- 9d. OOC personalized PageRank of sources 0-7 -----------------------
    reset()
    t0 = time.perf_counter()
    with recorded_combine(multiquery, largest=True,
                          name="block_csr_combine_mq") as big_add:
        ppr_ooc, ppr_ostats = alg.personalized_pagerank(eng, first,
                                                        PPR_ITERS)
    torch.cuda.synchronize()
    ppr_ooc_s = time.perf_counter() - t0
    launches["add"] = read_counts("ppr")
    if big_add["kw"]["mode"] != "add":
        raise AssertionError(f"ooc ppr ran combine mode {big_add['kw']}")
    check_io(ppr_ostats.counters, "ppr")
    np.testing.assert_allclose(ppr_ooc, ppr_local, rtol=0, atol=1e-5)
    for k in COUNTER_KEYS:
        a, b = ppr_ostats.counters[k], ppr_lstats.counters[k]
        if abs(a - b) > 1e-3 + 1e-5 * abs(b):
            raise AssertionError(f"ooc ppr: counter {k} = {a}, LOCAL {b}")
    emit(phase="serve_ooc_ppr", queries=SERVE_Q, iterations=PPR_ITERS,
         seconds=ppr_ooc_s,
         max_abs_diff_vs_local=float(np.abs(ppr_ooc - ppr_local).max()),
         launches=launches["add"],
         split_per_iteration_s={k: v / PPR_ITERS
                                for k, v in eng.ooc_wall.items()},
         measured_edge_read_bytes=ppr_ostats.counters[
             "measured_edge_read_bytes"],
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9e. the panel kernel replayed on the serving path's own inputs ----
    rows = {}
    for mode, call in (("min", big_min), ("add", big_add)):
        rows[mode] = check_kernel(csr_spmv, call["args"], call["kw"], "ooc",
                                  reps=5, panel=True)
    return dict(launches=launches, rows=rows, sources=sources, solo=solo,
                session_iters=session_iters,
                session_step_counters=step_counters,
                ppr_local=ppr_local, ppr_local_counters=ppr_lstats.counters)


# ---------------------------------------------------------------------------
# baselines_path: the Chaos- and GridGraph-like engines on the smoke's graph
# ---------------------------------------------------------------------------

BASELINE_NODES = 4             # Chaos: benchmarks/table45_engines.py's nodes
BASELINE_GRID = 8              # Grid: table45's grid
BASELINE_COUNTERS = ("edge_read_bytes", "vertex_read_bytes",
                     "vertex_write_bytes", "net_bytes", "updates_generated",
                     "messages_sent")


def recorded_actives(engine):
    """Wrap ``engine._step`` to keep a copy of each step's active mask on
    the card (one 1-byte-per-vertex device copy a step, no host sync);
    returns the list it fills, copied to the host after the timed run."""
    masks = []
    step = engine._step

    def rec(values, active, *args):
        masks.append(active.clone())
        return step(values, active, *args)
    engine._step = rec
    return masks


def baseline_tables(g):
    """Per-vertex tables of the smoke's graph for :func:`baseline_counts`:
    out-degrees, out-edges whose update crosses Chaos's nodes, Grid's edges
    per block and the destination blocks each vertex has an edge into."""
    import numpy as np
    n, e = g.num_vertices, g.num_edges
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    cross = ((np.arange(e, dtype=np.int64) * BASELINE_NODES) // e
             != dst % BASELINE_NODES)
    q = BASELINE_GRID
    rng = -(-n // q)
    into = np.zeros((n, q), bool)
    into[src, dst // rng] = True
    return dict(n=n, e=e, outdeg=np.bincount(src, minlength=n),
                cross_deg=np.bincount(src[cross], minlength=n),
                sizes=np.bincount(src // rng * q + dst // rng,
                                  minlength=q * q),
                into=into, v_blk=np.arange(n) // rng, win=rng * 4)


def baseline_counts(tab, masks, engine, budget=None):
    """The exact counters a Chaos-like (``engine="chaos"``) or Grid-like
    run (under ``budget``) must report for the active masks it recorded,
    counted with numpy from :func:`baseline_tables` (integers; the engines
    must match them exactly)."""
    import numpy as np
    n, e, win, q = tab["n"], tab["e"], tab["win"], BASELINE_GRID
    out = dict.fromkeys(BASELINE_COUNTERS, 0)
    for a in masks:
        if engine == "chaos":
            upd = int(tab["outdeg"][a].sum())
            out["edge_read_bytes"] += e * 8
            out["updates_generated"] += upd
            out["messages_sent"] += upd
            out["net_bytes"] += int(tab["cross_deg"][a].sum()) * 12
            out["vertex_read_bytes"] += n * 4
            out["vertex_write_bytes"] += n * 4
            continue
        cells = (tab["v_blk"][a][:, None] * q
                 + np.arange(q))[tab["into"][a]]
        blk = np.bincount(cells, minlength=q * q) > 0
        out["edge_read_bytes"] += int(tab["sizes"][blk].sum()) * 8
        b2 = blk.reshape(q, q)
        if 2 * win <= budget:
            cols, rows = int(b2.any(0).sum()), int(b2.any(1).sum())
            out["vertex_read_bytes"] += (rows + cols) * win
            out["vertex_write_bytes"] += cols * win
        else:
            out["vertex_read_bytes"] += 2 * int(blk.sum()) * win
            out["vertex_write_bytes"] += int(blk.sum()) * win
    return out


def run_baselines_path(g, *, source, checks, local_results):
    """Phase ``baselines_path``: Chaos (4 nodes) PageRank (2), BFS and SSSP
    and Grid (8 x 8) PageRank (2) and SSSP, unbounded and under a budget
    below two vertex windows, on the card; values against LOCAL's (BFS and
    SSSP bit-equal, PageRank within 1e-5) and the oracles, iterations
    against LOCAL's, every counter against an exact numpy count of the
    active masks each step recorded."""
    import numpy as np
    import torch
    from repro_torch.core.baselines import ChaosLikeEngine, GridLikeEngine
    t_phase = time.perf_counter()
    n = g.num_vertices
    win = -(-n // BASELINE_GRID) * 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chaos = ChaosLikeEngine(g, BASELINE_NODES)
    torch.cuda.synchronize()
    chaos_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = GridLikeEngine(g, BASELINE_GRID)
    torch.cuda.synchronize()
    grid_setup = time.perf_counter() - t0
    thrash = 2 * win - 1                 # below two vertex windows
    emit(phase="baselines_setup", chaos_nodes=BASELINE_NODES,
         grid=BASELINE_GRID, chaos_setup_s=chaos_setup,
         grid_setup_s=grid_setup, thrash_budget_bytes=thrash,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    tab = baseline_tables(g)
    tables_s = time.perf_counter() - t0

    runs = [("chaos", "pagerank", chaos, None), ("chaos", "bfs", chaos, None),
            ("chaos", "sssp", chaos, None)]
    for name, budget in (("unbounded", float("inf")), ("thrash", thrash)):
        runs += [(f"grid[{name}]", "pagerank", grid, budget),
                 (f"grid[{name}]", "sssp", grid, budget)]
    out = {}
    for engine_name, algo, eng, budget in runs:
        if budget is not None:
            eng.memory_budget = budget
        masks = recorded_actives(eng)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if algo == "pagerank":
            vals, c = eng.run_pagerank(PR_ITERS)
            iters = PR_ITERS
        else:
            vals, c, iters = getattr(eng, f"run_{algo}")(source)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del eng._step                    # back to the class's method
        masks = [m.cpu().numpy() for m in masks]
        local_vals, local_stats = local_results[algo]
        checks[algo](vals)
        if algo == "pagerank":
            np.testing.assert_allclose(vals, local_vals, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(vals, local_vals)
        if iters != local_stats.iterations or len(masks) != iters:
            raise AssertionError(
                f"{engine_name} {algo}: {iters} iterations ({len(masks)} "
                f"steps recorded), LOCAL {local_stats.iterations}")
        t0 = time.perf_counter()
        want = baseline_counts(tab, masks, engine_name[:5], budget)
        count_s = time.perf_counter() - t0
        got = c.as_dict()
        if got != {k: float(v) for k, v in want.items()}:
            raise AssertionError(f"{engine_name} {algo}: counters {got}, "
                                 f"numpy count {want}")
        lc = local_stats.counters
        emit(phase="baselines_path", engine=engine_name, algorithm=algo,
             iterations=iters, seconds=seconds, counters=got,
             numpy_count_s=count_s, numpy_tables_s=tables_s,
             exact_count_over_2_24=any(v > 2 ** 24 for v in want.values()),
             max_abs_diff_vs_local=float(np.abs(vals - local_vals).max()),
             dfograph_local=dict(
                 edge_read_bytes=lc["edge_read_bytes"],
                 vertex_read_bytes=lc["vertex_read_bytes"],
                 vertex_write_bytes=lc["vertex_write_bytes"],
                 msgs_sent=lc["msgs_sent"], net_bytes=lc["net_bytes"]),
             dfograph_over_baseline={
                 k: lc[k] / got[b] for k, b in (
                     ("edge_read_bytes", "edge_read_bytes"),
                     ("msgs_sent", "messages_sent"),
                     ("net_bytes", "net_bytes")) if got[b]},
             max_memory_allocated=peak)
        out[engine_name, algo] = dict(seconds=seconds, iterations=iters)
    del chaos, grid, tab
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="baselines_total", seconds=time.perf_counter() - t_phase)
    return out


# ---------------------------------------------------------------------------
# lm_serve: the LM stack's serving path at full width
# ---------------------------------------------------------------------------

LM_MODELS = ("gemma2-9b", "zamba2-1.2b")
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 32, 16
LM_PARITY_LAYERS = {"gemma2-9b": 2,      # one local / global cycle
                    "zamba2-1.2b": 6}    # one Mamba2 cycle + the shared block
LM_PARITY_BATCH, LM_PARITY_SEQ = 2, 64
# Gemma2's local window (4,096) cut below LM_PARITY_SEQ in the parity check
# only, so that its local layer decodes through the ring buffer past the
# wrap and the forward applies the window mask, at full width
LM_PARITY_WINDOW = {"gemma2-9b": 16}
LM_PARITY_TOL = 1e-3
LM_PROFILE_STEPS = 3           # profiled decode steps after the session


def decode_profile(step, reps=LM_PROFILE_STEPS, top=6):
    """(device ms per call of ``step``, device operations per call, the
    ``top`` kernels by device ms per call) from one ``torch.profiler``
    session over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (sum(by_name.values()) / reps / 1e3, len(ops) / reps,
            [[name[:80], us / reps / 1e3] for name, us in heavy])


def run_lm_serve():
    """Phase ``lm_serve``: Gemma2-9B and Zamba2-1.2B at full width and
    depth in bf16, weights drawn on the card from a seeded generator, each
    serving a ``ServeSession`` (batch 4, prompt 32, 16 greedy steps); then
    each cut to its first cycle in float32 (TF32 off; Gemma2's local
    window to 16, below the 64 positions), cached decode held against the
    teacher-forced forward at every position."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import make_model
    from repro_torch.serve.engine import ServeSession
    from repro_torch.sharding.rules import make_rules
    from repro_torch.utils import tree_bytes, tree_params
    t_phase = time.perf_counter()
    rules = make_rules(None)
    out = {}
    for arch in LM_MODELS:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = make_model(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = tree_params(params)
        session = ServeSession(model, params, rules, batch=LM_BATCH,
                               cache_len=LM_PROMPT + LM_STEPS + 1)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
        t0 = time.perf_counter()
        toks = session.generate(prompts, LM_STEPS)
        gen_s = time.perf_counter() - t0
        steps = LM_PROMPT + LM_STEPS - 1
        if toks.shape != (LM_BATCH, LM_STEPS) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{arch}: tokens {toks.shape} out of range")
        last = {"tokens": torch.as_tensor(toks[:, -1:], device="cuda"),
                "pos": torch.full((LM_BATCH,), steps, dtype=torch.int32,
                                  device="cuda")}
        with torch.inference_mode():     # one more step: the logits
            logits, _ = model.decode_step(params, session.cache, last, rules)
            def step():
                model.decode_step(params, session.cache, last, rules)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LM_PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
            steady_ms = (time.perf_counter() - t0) / LM_PROFILE_STEPS * 1e3
            busy_ms, launches, top = decode_profile(step)
        if logits.shape != (LM_BATCH, padded_vocab(cfg)) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)} "
                                 "not finite")
        emit(phase="lm_serve", arch=arch, dtype=cfg.dtype,
             layers=cfg.num_layers, d_model=cfg.d_model, params=n_params,
             param_bytes=tree_bytes(params), init_s=init_s,
             batch=LM_BATCH, prompt=LM_PROMPT, generated=LM_STEPS,
             decode_steps=steps, generate_s=gen_s, steps_per_s=steps / gen_s,
             tokens_per_s=LM_BATCH * steps / gen_s,
             steady_ms_per_step=steady_ms,
             device_ms_per_step=busy_ms, launches_per_step=launches,
             device_idle_share=1 - busy_ms / steady_ms,
             top_device_ops_ms_per_step=top,
             weight_bytes_bound_ms=tree_bytes(params) / HBM_BYTES_PER_S * 1e3,
             first_tokens=toks[0].tolist(),
             max_memory_allocated=torch.cuda.max_memory_allocated())
        out[arch] = dict(params=n_params, init_s=init_s, generate_s=gen_s)
        del model, params, session, logits
        gc.collect()
        torch.cuda.empty_cache()

    # cache parity in float32, TF32 off, on the first cycle of each model
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in LM_MODELS:
            cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                      num_layers=LM_PARITY_LAYERS[arch])
            if arch in LM_PARITY_WINDOW:
                cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
                    cfg.attn, window=LM_PARITY_WINDOW[arch]))
            model = make_model(cfg)
            params = model.init(torch.Generator(device="cuda").manual_seed(1))
            b, s = LM_PARITY_BATCH, LM_PARITY_SEQ
            toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(2))
            t0 = time.perf_counter()
            with torch.inference_mode():
                full, _ = model.apply(params, {"tokens": toks}, rules)
                cache = model.init_cache(b, s)
                slots = sorted({c["self"]["k"].shape[2]
                                for st in cache
                                for c in (st if isinstance(st, list)
                                          else st[0] + [st[1]])
                                if "self" in c})
                if arch in LM_PARITY_WINDOW and slots != sorted(
                        {cfg.attn.window, s}):
                    raise AssertionError(
                        f"{arch}: cache slots {slots}, expected a ring "
                        f"buffer of {cfg.attn.window} beside {s}")
                worst = 0.0
                for i in range(s):
                    logits, cache = model.decode_step(params, cache, {
                        "tokens": toks[:, i:i + 1],
                        "pos": torch.full((b,), i, dtype=torch.int32,
                                          device="cuda")}, rules)
                    want = full[:, i]
                    diff = (logits - want).abs()
                    worst = max(worst, float(diff.max()))
                    if not bool((diff <= LM_PARITY_TOL
                                 + LM_PARITY_TOL * want.abs()).all()):
                        raise AssertionError(
                            f"{arch}: cached decode differs from the forward "
                            f"at position {i} by {float(diff.max())}")
            torch.cuda.synchronize()
            emit(phase="lm_parity", arch=arch, layers=cfg.num_layers,
                 stages=[(len(st.cycle), st.n, st.shared_attn)
                         for st in model.stages],
                 dtype="float32", tf32=False, batch=b, positions=s,
                 window=cfg.attn.window, cache_slots=slots,
                 rtol=LM_PARITY_TOL, atol=LM_PARITY_TOL,
                 max_abs_diff=worst, seconds=time.perf_counter() - t0)
            out[arch]["parity_max_abs_diff"] = worst
            del model, params, full, cache
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.set_float32_matmul_precision(prev)
    emit(phase="lm_total", seconds=time.perf_counter() - t_phase)
    return out


# ---------------------------------------------------------------------------
# lm_train: single-card LM training at full width and depth
# ---------------------------------------------------------------------------

LM_TRAIN_ARCH = "zamba2-1.2b"
LM_TRAIN_SEQ = 4096            # the train_4k cell's sequence
LM_TRAIN_BATCH = 8             # train_4k's global batch 256, cut to 8 ...
LM_TRAIN_MICRO = 4             # ... as 4 microbatches of 2
LM_TRAIN_STEPS = 2             # cut from 3 to make room for lm_train_mesh
LM_TRAIN_CUT_LAYERS = 6        # resume and accumulation checks: the first
                               # Mamba2 cycle and the shared block
LM_RESUME_BATCH, LM_RESUME_MICRO = 4, 2   # the resume check's batch, cut
                               # from 8 as 4 x 2 (room for lm_train_mesh)
LM_ACCUM_BATCH, LM_ACCUM_SEQ = 4, 1024
LM_ACCUM_RTOL = 1e-5           # tests/test_torch_train_loop.py's


@contextlib.contextmanager
def mamba_terms():
    """Keeps, for each Mamba2 layer a train step runs, the per-token terms
    whose sums over the tokens are its ``A_log`` and ``dt_bias``
    gradients: dL/d(decay) x decay (decay = -exp(A_log) dt) and
    dL/d(softplus input).  Yields ``{"A_log": [...], "dt_bias": [...]}``,
    one ``[B, T, H]`` tensor a layer call, in call order."""
    import torch.nn.functional as F
    from repro_torch.models import mamba2
    calls = {"A_log": [], "dt_bias": []}

    def keep(kind, x, term):
        slot = len(calls[kind])
        calls[kind].append(None)

        def hook(g):
            calls[kind][slot] = term(g).detach()
        x.register_hook(hook)

    def chunked_gla(q, k, v, w, **kw):             # w: [B, H, T, 1]
        # the hook must not hold ``w`` itself: a tensor whose own hook
        # refers to it is a cycle through autograd that gc never frees,
        # and it would keep the step's whole graph on the card
        decay = w.detach()
        keep("A_log", w, lambda g: (g * decay)[..., 0].transpose(1, 2))
        return gla(q, k, v, w, **kw)

    class Functional:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def softplus(x, *args, **kw):
            keep("dt_bias", x, lambda g: g)
            return F.softplus(x, *args, **kw)

    gla = mamba2.chunked_gla
    mamba2.chunked_gla, mamba2.F = chunked_gla, Functional()
    try:
        yield calls
    finally:
        mamba2.chunked_gla, mamba2.F = gla, F


def mamba_term_stats(model, names, mu1, calls):
    """For each ``A_log`` and ``dt_bias`` leaf, from the terms ``mamba_terms``
    kept over a step at one microbatch and then one at two: its
    ``conditioning`` (|the sum of |terms| over the tokens| / |their sum|,
    the first step's), ``term_rel_diff`` (sum |term difference| / sum
    |term|, the two steps' terms of each token), ``bound`` (|the sum of
    |term differences|| / |the sum|: the largest relative difference the
    leaves can show from the terms alone) and ``witness_rel`` (the sum's
    direction against the first moment's, which checks the mapping)."""
    import torch
    order = [(si, c) for si, st in enumerate(model.stages)
             for _ in range(st.n) for c in range(len(st.cycle))]
    n = len(order)
    out = {}
    for kind, kept in calls.items():
        if len(kept) != 3 * n or any(t is None for t in kept):
            raise AssertionError(f"lm_train accumulation: {len(kept)} "
                                 f"{kind} term calls for {n} layers x 3")
        for si, st in enumerate(model.stages):
            for c in range(len(st.cycle)):
                js = [j for j, o in enumerate(order) if o == (si, c)]
                one = torch.stack([kept[j].double() for j in js])
                two = torch.stack([torch.cat([kept[n + j], kept[2 * n + j]])
                                   .double() / 2 for j in js])
                total = one.sum(dim=(1, 2))               # [n, H]
                size = float(torch.linalg.vector_norm(total))
                name = f"stages/{si}/{c}/{kind}"
                mu = mu1[name].double()
                out[name] = dict(
                    conditioning=float(torch.linalg.vector_norm(
                        one.abs().sum(dim=(1, 2)))) / size,
                    term_rel_diff=float((one - two).abs().sum()
                                        / one.abs().sum()),
                    bound=float(torch.linalg.vector_norm(
                        (one - two).abs().sum(dim=(1, 2)))) / size,
                    witness_rel=float(torch.linalg.vector_norm(
                        total / size - mu / torch.linalg.vector_norm(mu))))
                if out[name]["witness_rel"] > 1e-4:
                    raise AssertionError(f"lm_train accumulation: the terms "
                                         f"of {name} do not sum to its "
                                         f"gradient ({out[name]})")
    if set(out) - set(names):
        raise AssertionError(f"lm_train accumulation: no leaves "
                             f"{sorted(set(out) - set(names))}")
    return out


def run_lm_train(smi, tmp_root):
    """Phase ``lm_train``: ``LM_TRAIN_ARCH`` at full width and depth in
    bf16 with remat, weights from a seed, ``LM_TRAIN_STEPS`` AdamW steps
    of ``LM_TRAIN_BATCH`` sequences of ``LM_TRAIN_SEQ`` tokens as
    ``LM_TRAIN_MICRO`` microbatches (``TokenPipeline`` batches, warmup
    1); then at ``LM_TRAIN_CUT_LAYERS`` layers (the first cycle and the
    shared block, full width): resume through ``CheckpointManager`` after
    step 2 into a fresh state, bit-equal to the uninterrupted step 3, and
    in float32 with TF32 off two microbatches equal to one batch."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model import make_model
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.loop import (
        checkpoint_template, init_train_state, make_train_step,
    )
    from repro_torch.train.optimizer import OptConfig, flatten
    from repro_torch.utils import tree_params
    t_phase = time.perf_counter()
    arch, seq, batch = LM_TRAIN_ARCH, LM_TRAIN_SEQ, LM_TRAIN_BATCH
    micro, steps, cut_layers = LM_TRAIN_MICRO, LM_TRAIN_STEPS, \
        LM_TRAIN_CUT_LAYERS
    device = DEVICE
    rules = make_rules(None)
    opt_cfg = OptConfig(warmup_steps=1)
    cfg = get_config(arch)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=0)

    def batch_at(i, p=pipe):
        toks, tgt = p.batch_at(i)
        return {"tokens": torch.from_numpy(toks).to(device),
                "targets": torch.from_numpy(tgt).to(device)}

    # -- full width and depth, bf16, remat --------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_model(cfg, remat=True, device=device)
    t0 = time.perf_counter()
    state = init_train_state(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tree_params(state["params"])
    params0 = state["params"]
    step = make_train_step(model, opt_cfg, rules, microbatches=micro)
    step_s, losses, gnorms = [], [], []
    for i in range(steps):
        b = batch_at(i)
        torch.cuda.synchronize()
        if i == 0:     # step 1's own peak, above its arguments (the dryrun)
            init_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))     # syncs with the device
        step_s.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
        if i == 0:
            step1_peak = torch.cuda.max_memory_allocated()
    peak = max(init_peak, torch.cuda.max_memory_allocated())
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"lm_train: loss {losses}, grad norm {gnorms}")
    leaves = flatten(state["params"])
    if not all(bool(torch.isfinite(x).all()) for x in leaves):
        raise AssertionError("lm_train: a parameter leaf holds NaN or inf")
    moved = sum(not torch.equal(a.to(b.dtype), b)
                for a, b in zip(flatten(params0), leaves))
    if moved == 0 or int(state["step"]) != steps:
        raise AssertionError(f"lm_train: {moved} leaves moved, step "
                             f"{int(state['step'])}")
    tokens = batch * seq
    steady = step_s[1:] or step_s
    steady_s = sum(steady) / len(steady)
    emit(phase="lm_train", arch=arch, dtype=cfg.dtype, remat=True,
         layers=cfg.num_layers, d_model=cfg.d_model, params=n_params,
         seq=seq, global_batch=batch, microbatches=micro, steps=steps,
         opt=dataclasses.asdict(opt_cfg), init_s=init_s,
         first_step_s=step_s[0], steady_s_per_step=steady_s,
         step_s=step_s, tokens_per_step=tokens,
         tokens_per_s=tokens / steady_s, losses=losses, grad_norms=gnorms,
         leaves_moved=moved, leaves=len(leaves),
         model_flops_per_s_estimate=6 * n_params * tokens / steady_s,
         max_memory_allocated=peak, max_memory_gb=peak / 1e9,
         step1_max_memory_allocated=step1_peak, nvidia_smi=smi)
    print(f"lm_train {arch}: {steady_s:.3f} s/step after a first step of "
          f"{step_s[0]:.3f} s, {tokens / steady_s:.0f} tokens/s, peak "
          f"{peak / 1e9:.1f} GB, losses {losses}, model FLOP/s (estimate, "
          f"6 N tokens / step) {6 * n_params * tokens / steady_s:.3e} "
          f"[{smi}]", flush=True)
    del model, state, params0, step, leaves, m, b
    gc.collect()
    torch.cuda.empty_cache()

    # -- resume at the cut depth: save after step 2, restore into a fresh
    # state, step 3 bit-equal to the uninterrupted run's ------------------
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, num_layers=cut_layers)
    model = make_model(cut, remat=True, device=device)
    step = make_train_step(model, opt_cfg, rules,
                           microbatches=LM_RESUME_MICRO)
    resume_pipe = TokenPipeline(cfg.vocab_size, seq, LM_RESUME_BATCH, seed=0)

    def batch_at(i, p=resume_pipe):
        toks, tgt = p.batch_at(i)
        return {"tokens": torch.from_numpy(toks).to(device),
                "targets": torch.from_numpy(tgt).to(device)}
    state = init_train_state(model, seed=0)
    for i in range(2):
        state, _ = step(state, batch_at(i))
    ckpt = tempfile.mkdtemp(prefix="lm-ckpt-", dir=tmp_root)
    try:
        mgr = CheckpointManager(ckpt)
        t1 = time.perf_counter()
        saved = mgr.save(state, step=2)
        save_s = time.perf_counter() - t1
        whole, m3 = step(state, batch_at(2))
        del state
        fresh = init_train_state(model, seed=1)
        t1 = time.perf_counter()
        got_step, restored = mgr.restore_into(checkpoint_template(fresh,
                                                                  model))
        restore_s = time.perf_counter() - t1
        del fresh
        again, m3b = step(restored, batch_at(2))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    loss_equal = bool(torch.equal(m3["loss"], m3b["loss"]))
    fw, fa = flatten(whole), flatten(again)
    state_equal = len(fw) == len(fa) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(fw, fa))
    if got_step != 2 or not loss_equal or not state_equal:
        raise AssertionError(
            f"lm_train resume: step {got_step}, loss {float(m3['loss'])} vs "
            f"{float(m3b['loss'])}, states equal {state_equal}")
    # where a step's time goes, at the cut depth: the wall time of one
    # step beside the card's busy time in a profiled one
    b3 = batch_at(2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step(whole, b3)
    torch.cuda.synchronize()
    cut_step_s = time.perf_counter() - t1
    busy_ms, ops, top = decode_profile(lambda: step(whole, b3), reps=1)
    emit(phase="lm_train_resume", arch=arch, layers=cut_layers,
         batch=LM_RESUME_BATCH, microbatches=LM_RESUME_MICRO,
         stages=[(len(st.cycle), st.n, st.shared_attn)
                 for st in model.stages], params=tree_params(whole["params"]),
         checkpoint_bytes=saved["bytes_written"],
         blocks_written=saved["blocks_written"], save_s=save_s,
         restore_s=restore_s, step3_loss=float(m3["loss"]),
         loss_bit_equal=loss_equal, state_bit_equal=state_equal,
         step_s=cut_step_s, device_ms_per_step=busy_ms,
         device_ops_per_step=ops, device_idle_share=1 - busy_ms / 1e3
         / cut_step_s, top_device_ops_ms_per_step=top,
         seconds=time.perf_counter() - t0)
    del model, step, whole, again, restored, m3, m3b, b3
    gc.collect()
    torch.cuda.empty_cache()

    run_lm_train_accum(cut, opt_cfg, rules, device)
    emit(phase="lm_train_total", seconds=time.perf_counter() - t_phase)
    return {"step1_peak": step1_peak}


def run_lm_train_accum(cut, opt_cfg, rules, device):
    """``lm_train``'s accumulation check: ``cut`` in float32 with TF32
    off, one step of ``LM_ACCUM_BATCH`` x ``LM_ACCUM_SEQ`` tokens as two
    microbatches against the same step as one; loss, ce and grad norm
    within ``LM_ACCUM_RTOL``, each first-moment leaf within it (Mamba2's
    ``A_log`` and ``dt_bias`` within it times their conditioning, measured
    by ``mamba_terms``), the parameters within the reference test's
    5e-2 / 5e-3."""
    import dataclasses
    import torch
    from repro_torch.ckpt.blockstore import _leaves_with_paths
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model import make_model
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import flatten
    t0 = time.perf_counter()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = make_model(dataclasses.replace(cut, dtype="float32"),
                           device=device)
        state = init_train_state(model, seed=2)
        toks, tgt = TokenPipeline(cut.vocab_size, LM_ACCUM_SEQ,
                                  LM_ACCUM_BATCH, seed=3).batch_at(0)
        b = {"tokens": torch.from_numpy(toks).to(device),
             "targets": torch.from_numpy(tgt).to(device)}
        with mamba_terms() as term_calls:
            out = [make_train_step(model, opt_cfg, rules, microbatches=n)(
                state, b) for n in (1, 2)]
    finally:
        torch.set_float32_matmul_precision(prev)
    (s1, m1), (s2, m2) = out
    worst = {}
    for k in ("loss", "ce", "grad_norm"):
        a, c = float(m1[k]), float(m2[k])
        worst[k] = abs(a - c) / max(abs(a), 1e-30)
        if worst[k] > LM_ACCUM_RTOL:
            raise AssertionError(f"lm_train accumulation: {k} {a} vs {c}")
    # the first moments are (1 - b1) x the clipped gradients, each leaf
    # within rtol; a leaf whose gradient is a sum over tokens that cancels
    # (Mamba2's A_log and dt_bias) within rtol x its measured conditioning
    names = [k for k, _ in _leaves_with_paths(s1["opt"]["mu"])]
    mu1 = dict(zip(names, flatten(s1["opt"]["mu"])))
    mu2 = dict(zip(names, flatten(s2["opt"]["mu"])))
    terms = mamba_term_stats(model, names, mu1, term_calls)
    leaf_diff, bad = {}, []
    for name in names:
        a, c = mu1[name].double(), mu2[name].double()
        d = float(torch.linalg.vector_norm(a - c)
                  / max(float(torch.linalg.vector_norm(a)), 1e-30))
        leaf_diff[name] = d
        tol = LM_ACCUM_RTOL * terms.get(name, {}).get("conditioning", 1.0)
        if d > tol:
            bad.append((name, d, tol))
        if name in terms:
            terms[name]["mu_rel_diff"], terms[name]["tol"] = d, tol
    if bad:
        raise AssertionError(f"lm_train accumulation: first moments differ "
                             f"(leaf, relative difference, tolerance): "
                             f"{bad[:8]}")
    plain = {k: v for k, v in leaf_diff.items() if k not in terms}
    worst_plain = max(plain, key=plain.get)
    # parameters to accumulation-order tolerance (the reference's test's)
    for a, c in zip(flatten(s1["params"]), flatten(s2["params"])):
        if not torch.allclose(a, c, rtol=5e-2, atol=5e-3):
            raise AssertionError("lm_train accumulation: parameters differ")
    emit(phase="lm_train_accum", arch=cut.name, layers=cut.num_layers,
         dtype="float32", tf32=False, batch=LM_ACCUM_BATCH,
         seq=LM_ACCUM_SEQ,
         microbatches=[1, 2], rtol=LM_ACCUM_RTOL, rel_diff=worst,
         mu_leaves=len(names),
         mu_worst_plain_leaf=[worst_plain, plain[worst_plain]],
         mamba_terms=terms, seconds=time.perf_counter() - t0)
    del model, state, out, s1, s2, mu1, mu2, term_calls
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# lm_train_mesh: LM training on a ('data', 'model') mesh of 4 ranks sharing
# the card
# ---------------------------------------------------------------------------

LM_MESH_SHAPE = (2, 2)         # ('data', 'model'): 4 gloo ranks on one card
LM_MESH_SEQ = 1024
LM_MESH_BATCH = 4              # global batch: 2 sequences a data shard
LM_MESH_STEPS = 2
LM_MESH_LOSS_RTOL = 1e-2       # bf16 step-1 loss against the one-card one
LM_MESH_TIMEOUT_S = 900        # the rank job's deadline (and gloo's timeout)
LM_MESH_LEAVES = ("embed/table", "stages/0/0/in_proj", "stages/0/0/A_log",
                  "stages/0/0/out_proj", "shared_attn/attn/wq",
                  "shared_attn/mlp/wi_gate", "shared_attn/mlp/wo")
LM_MESH_PARAM_TOL = (5e-2, 5e-3)   # the reference test's accumulation order


def mamba_conditioning(model, calls):
    """Per ``A_log`` / ``dt_bias`` leaf, from the per-token terms
    ``mamba_terms`` kept over one step: |the sum of |terms| over the tokens|
    / |their sum| — how far the leaf's gradient cancels, so how much a
    change of summation order can move it relative to its size."""
    import torch
    order = [(si, c) for si, st in enumerate(model.stages)
             for _ in range(st.n) for c in range(len(st.cycle))]
    out = {}
    for kind, kept in calls.items():
        if len(kept) != len(order) or any(t is None for t in kept):
            raise AssertionError(f"lm_train_mesh: {len(kept)} {kind} term "
                                 f"calls for {len(order)} layers")
        for si, st in enumerate(model.stages):
            for c in range(len(st.cycle)):
                one = torch.stack([kept[j].double() for j, o
                                   in enumerate(order) if o == (si, c)])
                out[f"stages/{si}/{c}/{kind}"] = float(
                    torch.linalg.vector_norm(one.abs().sum(dim=(1, 2)))
                    / torch.linalg.vector_norm(one.sum(dim=(1, 2))))
    return out


def compare_states(name, a, b, cond, rtol=LM_ACCUM_RTOL):
    """``a`` and ``b``: {"metrics", "mu", "params"} of one step (tensors by
    leaf path).  Loss and ce within ``rtol``; each first-moment
    leaf within ``rtol`` relative in its norm, times its conditioning for
    the leaves in ``cond``; the grad norm within the bound those leaf
    tolerances imply (|sum over leaves of (tolerance x |mu|)^2|^(1/2) /
    |mu|, at least ``rtol``: the first moments are the clipped gradients
    times 0.1); parameters within the reference test's
    accumulation-order tolerance.  Returns the differences (largest per
    leaf class, the five leaves that move the most) and ``failures``."""
    import math
    import torch
    failures, rel, classes, moved = [], {}, {}, []
    implied = total = 0.0
    for leaf, x in a["mu"].items():
        y = b["mu"][leaf]
        size = float(torch.linalg.vector_norm(x.double()))
        diff = float(torch.linalg.vector_norm((x - y).double()))
        d = diff / max(size, 1e-30)
        tol = rtol * cond.get(leaf, 1.0)
        implied += (tol * size) ** 2
        total += size ** 2
        if d > tol:
            failures.append(f"first moment {leaf}: {d} > {tol}")
        kind = leaf.rsplit("/", 1)[-1]
        if leaf in cond:
            kind += " (x conditioning)"
        classes[kind] = max(classes.get(kind, 0.0), d)
        moved.append((diff, leaf, d))
    gn_tol = max(rtol, math.sqrt(implied / max(total, 1e-300)))
    for k, tol in (("loss", rtol), ("ce", rtol), ("grad_norm", gn_tol)):
        x, y = a["metrics"][k], b["metrics"][k]
        rel[k] = abs(x - y) / max(abs(x), 1e-30)
        if rel[k] > tol:
            failures.append(f"{k}: {x} vs {y} ({rel[k]} > {tol})")
    p_abs = 0.0
    for leaf, x in a["params"].items():
        y = b["params"][leaf]
        if not torch.allclose(x, y, rtol=LM_MESH_PARAM_TOL[0],
                              atol=LM_MESH_PARAM_TOL[1]):
            failures.append(f"parameter {leaf}")
        p_abs = max(p_abs, float((x - y).abs().max()))
    return dict(name=name, metrics_rel=rel, grad_norm_tol=gn_tol,
                mu_rel_by_leaf_class=classes,
                mu_most_moved=[[leaf, d] for _, leaf, d in
                               sorted(moved, reverse=True)[:5]],
                params_max_abs=p_abs, failures=failures)


def _lm_mesh_rank(pm, ckpt_dir, single_loss):
    """One rank of ``lm_train_mesh`` (:func:`_lm_mesh_train`), then, with
    the training state freed, of ``lm_long_decode``
    (:func:`_lm_long_decode_rank`) on the same mesh: one spawn for both."""
    import torch
    out, mesh = _lm_mesh_train(pm, ckpt_dir, single_loss)
    gc.collect()
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    out["long"] = _lm_long_decode_rank(mesh)
    return out


def _lm_mesh_train(pm, ckpt_dir, single_loss):
    """One rank of ``lm_train_mesh``: (1) ``LM_TRAIN_ARCH`` at full width
    and depth, bf16, remat, ``LM_MESH_STEPS`` steps on the
    ``LM_MESH_SHAPE`` mesh under ``plan_for(cfg, "train", mesh)``; (2) at
    ``LM_TRAIN_CUT_LAYERS`` layers in float32, TF32 off: step 1, saved
    logically unsharded, step 2; (3) ``elastic_restart`` of the step-1
    checkpoint onto a (1, 2) mesh (ranks 2 and 3 idle) and step 2 there;
    (4) rank 0 alone runs step 1 on one card (with ``mamba_terms``) and
    holds the mesh's step 1 against it, and the elastic step 2 against the
    uninterrupted one.  Returns per step seconds, losses and the wire
    (calls, bytes, seconds), peak memory, placements and the checks, and
    the mesh."""
    entered = time.time()
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ckpt.blockstore import _leaves_with_paths
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.model import make_model
    from repro_torch.runtime.elastic import elastic_restart
    from repro_torch.sharding import wire
    from repro_torch.sharding.rules import full, make_rules
    from repro_torch.sharding.strategy import plan_for
    from repro_torch.train.loop import (
        init_train_state, make_train_step, save_checkpoint, state_specs,
    )
    from repro_torch.train.optimizer import OptConfig, flatten
    rank = dist.get_rank()
    device = "cpu" if DEVICE == "cpu" else None
    cuda = DEVICE != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    mesh = make_device_mesh(LM_MESH_SHAPE, ("data", "model"), device=device)
    out = dict(rank=rank, entered=entered,
               mesh_s=time.time() - entered)
    cfg = get_config(LM_TRAIN_ARCH)
    opt_cfg = OptConfig(warmup_steps=1)

    def batch_at(pipe, i):
        toks, tgt = pipe.batch_at(i)
        dev = pm.device
        return {"tokens": torch.from_numpy(toks).to(dev),
                "targets": torch.from_numpy(tgt).to(dev)}

    # -- (1) full width and depth, bf16, remat ------------------------------
    plan = plan_for(cfg, "train", mesh)
    model = make_model(cfg, remat=True, device=device)
    t0 = time.perf_counter()
    state = init_train_state(model, seed=0, rules=plan.rules)
    sync()
    out["init_s"] = time.perf_counter() - t0
    named = dict(_leaves_with_paths(state["params"]))
    out["placements"] = {
        k: [str(tuple(named[k].placements)), list(named[k].shape),
            list(named[k].to_local().shape)] for k in LM_MESH_LEAVES}
    out["notes"] = list(plan.notes)
    step = make_train_step(model, opt_cfg, plan.rules)
    pipe = TokenPipeline(cfg.vocab_size, LM_MESH_SEQ, LM_MESH_BATCH, seed=0)
    steps = []
    for i in range(LM_MESH_STEPS):
        b = batch_at(pipe, i)
        sync()
        dist.barrier()
        if i == 0 and cuda:   # step 1's own peak, above its arguments
            out["init_peak"] = peak()
            torch.cuda.reset_peak_memory_stats()
        wire.WIRE.reset()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])             # syncs with the device
        steps.append(dict(s=time.perf_counter() - t0, loss=loss,
                          grad_norm=float(m["grad_norm"]),
                          wire=wire.WIRE.snapshot(), peak=peak()))
        if rank == 0:
            print(f"lm_train_mesh rank 0 step {i + 1}: {steps[-1]['s']:.3f} "
                  f"s, loss {loss}", flush=True)
    out["steps"] = steps
    out["peak"] = max(out.get("init_peak", 0), peak())
    local = [x.to_local() for x in flatten(state["params"])]
    out["local_params"] = sum(x.numel() for x in local)
    out["finite"] = all(bool(torch.isfinite(x).all()) for x in local)
    if abs(steps[0]["loss"] - single_loss) > LM_MESH_LOSS_RTOL * abs(
            single_loss) or not out["finite"]:
        raise AssertionError(f"lm_train_mesh: step-1 loss {steps[0]['loss']} "
                             f"vs one card {single_loss}; finite "
                             f"{out['finite']}")
    del model, state, step, local, named, m, b
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- (2) the cut depth in float32, TF32 off: step 1, save, step 2 ------
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    cut = dataclasses.replace(cfg, num_layers=LM_TRAIN_CUT_LAYERS,
                              dtype="float32")
    model = make_model(cut, device=device)
    rules = plan_for(cut, "train", mesh).rules
    step = make_train_step(model, opt_cfg, rules)
    pipe = TokenPipeline(cut.vocab_size, LM_MESH_SEQ, LM_MESH_BATCH, seed=3)
    b0, b1 = batch_at(pipe, 0), batch_at(pipe, 1)

    gather_s = []

    def kept(st, m):
        """The step's metrics, first moments and params, whole on rank 0
        (every rank of the state's mesh takes part)."""
        t0 = time.perf_counter()
        got = {"metrics": {k: float(v) for k, v in m.items()}}
        for tree in ("mu", "params"):
            node = st["opt"]["mu"] if tree == "mu" else st["params"]
            got[tree] = {}
            for k, x in _leaves_with_paths(node):
                whole = full(x)
                if rank == 0:
                    got[tree][k] = whole
                del whole
        gather_s.append(time.perf_counter() - t0)
        return got

    t0 = time.perf_counter()
    s1 = init_train_state(model, seed=2, rules=rules)
    s1, m1 = step(s1, b0)
    mesh1 = kept(s1, m1)
    t1 = time.perf_counter()
    save_checkpoint(CheckpointManager(ckpt_dir), s1, 1)
    out["cut_save_s"] = time.perf_counter() - t1
    s2, m2 = step(s1, b1)
    mesh2 = kept(s2, m2)
    del s2
    out["cut_s"] = time.perf_counter() - t0

    # -- (3) elastic restart onto (1, 2): ranks 2 and 3 idle ----------------
    t0 = time.perf_counter()

    def factory(new_mesh):
        r = plan_for(cut, "train", new_mesh).rules
        return r, r.tree_shardings(state_specs(model))

    got_step, el_state, el_mesh, el_plan = elastic_restart(
        ckpt_dir, s1, available=2, model_axis=2, rules_factory=factory,
        device=device)
    del s1
    out["elastic"] = dict(step=got_step, shape=list(el_plan.shape),
                          idle=el_plan.idle_devices,
                          notes=list(el_plan.notes),
                          active=el_state is not None)
    elastic2 = None
    if el_state is not None:
        el_step = make_train_step(model, opt_cfg, factory(el_mesh)[0])
        s2e, m2e = el_step(el_state, b1)
        elastic2 = kept(s2e, m2e)
        del s2e, el_state
    out["elastic"]["s"] = time.perf_counter() - t0
    out["gather_s"] = gather_s
    dist.barrier()

    # -- (4) rank 0: the one-card step 1 and both comparisons ---------------
    if rank == 0:
        t0 = time.perf_counter()
        st = init_train_state(model, seed=2)
        with mamba_terms() as calls:
            ss1, sm1 = make_train_step(model, opt_cfg, make_rules(None))(
                st, b0)
        cond = mamba_conditioning(model, calls)
        single1 = {"metrics": {k: float(v) for k, v in sm1.items()},
                   "mu": dict(_leaves_with_paths(ss1["opt"]["mu"])),
                   "params": dict(_leaves_with_paths(ss1["params"]))}
        del st, ss1, sm1, calls
        out["parity"] = compare_states("mesh step 1 vs one card", single1,
                                       mesh1, cond)
        out["elastic"]["check"] = compare_states(
            "elastic step 2 on (1, 2) vs (2, 2)", mesh2, elastic2, cond)
        out["conditioning"] = cond
        out["check_s"] = time.perf_counter() - t0
    dist.barrier()
    out["peak_total"] = peak()
    out["wire_total"] = wire.WIRE.snapshot()
    return out, mesh


def run_lm_train_mesh(smi, tmp_root):
    """Phase ``lm_train_mesh``: LM training on a ``LM_MESH_SHAPE``
    ('data', 'model') mesh of gloo ranks sharing the card
    (:func:`_lm_mesh_rank`).  Before the ranks start, the one-card loss of
    the full model's seed-0 weights on the mesh run's first batch (a
    forward pass), so two copies of the state never share the card.  The
    same ranks then run ``lm_long_decode``, whose one-card half runs here
    after they exit (:func:`run_lm_long_decode`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import run_mesh
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model import make_model
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.loop import loss_fn
    from repro_torch.utils import tree_params
    t_phase = time.perf_counter()
    cfg = get_config(LM_TRAIN_ARCH)
    toks, tgt = TokenPipeline(cfg.vocab_size, LM_MESH_SEQ, LM_MESH_BATCH,
                              seed=0).batch_at(0)
    model = make_model(cfg, device=DEVICE)
    params = model.init(seed=0)
    n_params = tree_params(params)
    with torch.no_grad():
        loss, _ = loss_fn(model, params, {
            "tokens": torch.from_numpy(toks).to(DEVICE),
            "targets": torch.from_numpy(tgt).to(DEVICE)}, make_rules(None))
    single_loss = float(loss)
    del model, params, loss
    gc.collect()
    torch.cuda.empty_cache()
    single_s = time.perf_counter() - t_phase
    ckpt = tempfile.mkdtemp(prefix="lm-mesh-ckpt-", dir=tmp_root)
    world = int(np.prod(LM_MESH_SHAPE))
    try:
        t_spawn, t0 = time.time(), time.perf_counter()
        ranks = run_mesh(_lm_mesh_rank, world, timeout_s=LM_MESH_TIMEOUT_S,
                         device="cpu" if DEVICE == "cpu" else None,
                         args=(ckpt, single_loss))
        job_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    r0 = ranks[0]
    tokens = LM_MESH_BATCH * LM_MESH_SEQ
    step_s = [max(r["steps"][i]["s"] for r in ranks)
              for i in range(LM_MESH_STEPS)]
    steady = step_s[1:] or step_s
    steady_s = sum(steady) / len(steady)
    losses = [s["loss"] for s in r0["steps"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lm_train_mesh: losses {losses}")
    wire_by_rank = [[dict(s["wire"], step=i + 1) for i, s in
                     enumerate(r["steps"])] for r in ranks]
    emit(phase="lm_train_mesh", arch=LM_TRAIN_ARCH, dtype=cfg.dtype,
         remat=True, layers=cfg.num_layers, params=n_params,
         mesh=dict(zip(("data", "model"), LM_MESH_SHAPE)), ranks=world,
         backend="gloo", plan_notes=r0["notes"], seq=LM_MESH_SEQ,
         global_batch=LM_MESH_BATCH, microbatches=1, steps=LM_MESH_STEPS,
         single_card_loss=single_loss, single_card_forward_s=single_s,
         losses=losses, grad_norms=[s["grad_norm"] for s in r0["steps"]],
         step1_loss_rel_diff=abs(losses[0] - single_loss) / abs(single_loss),
         step_s=step_s, first_step_s=step_s[0], steady_s_per_step=steady_s,
         tokens_per_step=tokens, tokens_per_s=tokens / steady_s,
         model_flops_per_s_estimate=6 * n_params * tokens / steady_s,
         peak_bytes_by_rank=[r["peak"] for r in ranks],
         local_params_by_rank=[r["local_params"] for r in ranks],
         wire_by_rank=wire_by_rank, placements=r0["placements"],
         init_s=max(r["init_s"] for r in ranks),
         spawn_s=max(r["entered"] for r in ranks) - t_spawn,
         job_s=job_s, nvidia_smi=smi)
    emit(phase="lm_train_mesh_checks", layers=LM_TRAIN_CUT_LAYERS,
         dtype="float32", tf32=False, rtol=LM_ACCUM_RTOL,
         param_tol=LM_MESH_PARAM_TOL, parity=r0["parity"],
         elastic=r0["elastic"], conditioning=r0["conditioning"],
         elastic_idle_ranks=[r["rank"] for r in ranks
                             if not r["elastic"]["active"]],
         cut_s=max(r["cut_s"] for r in ranks),
         cut_save_s=max(r["cut_save_s"] for r in ranks),
         elastic_s=max(r["elastic"]["s"] for r in ranks),
         gather_s=r0["gather_s"],
         check_s=r0["check_s"],
         peak_bytes_by_rank=[r["peak_total"] for r in ranks],
         wire_total_by_rank=[r["wire_total"] for r in ranks])
    print(f"lm_train_mesh {LM_TRAIN_ARCH} on {LM_MESH_SHAPE} ('data', "
          f"'model'), {world} ranks: {steady_s:.3f} s/step after a first "
          f"step of {step_s[0]:.3f} s, {tokens / steady_s:.0f} tokens/s, "
          f"losses {losses} (one card {single_loss}), peak "
          f"{max(r['peak'] for r in ranks) / 1e9:.1f} GB a rank, wire "
          f"{[round(s['wire']['seconds'], 2) for s in r0['steps']]} s on "
          f"rank 0 [{smi}]", flush=True)
    emit(phase="lm_train_mesh_total", seconds=time.perf_counter() - t_phase)
    failures = r0["parity"]["failures"] + r0["elastic"]["check"]["failures"]
    if failures:
        raise AssertionError(f"lm_train_mesh checks: {failures[:8]}")
    return {"step1_wire": r0["steps"][0]["wire"],
            "step1_peak": r0["steps"][0]["peak"],
            "long": run_lm_long_decode(ranks, smi)}


# ---------------------------------------------------------------------------
# lm_long_decode: context-parallel decode over the long_500k cell's cache on
# lm_train_mesh's ranks, held against one card's decode of the same cache
# ---------------------------------------------------------------------------

LM_LONG_SLOTS = 524_288        # the long_500k cell's cache
LM_LONG_STEPS = 4              # greedy steps: the last writes the last slot
LM_LONG_BLOCK = 4_096          # cache slots one seeded draw fills: the same
                               # values on one card and on any mesh
LM_LONG_SEED = 11
LM_LONG_NOISE = 3.0            # bf16, mesh against one card: at most this
                               # times one card's own bf16 error against
                               # float32 (two independent roundings of the
                               # same size: ~1.4)
LM_LONG_CUT_LAYERS = 6         # the float32 cut: one shared-block invocation
LM_LONG_CUT_SLOTS = 65_536
LM_LONG_F32_RTOL = 1e-4        # float32 logits, mesh against one card
LM_LONG_RWKV = "rwkv6-1.6b"    # the one-token shard fix without attention
LM_LONG_RWKV_LAYERS = 4
LM_LONG_PEAK_RANGE = (0.9, 1.1)    # the dry run's predicted peak over the
                                   # measured step's


def compact(x):
    """``x`` with its local shard in a storage of its own: a shard cut from
    a whole tensor is a view, which keeps the whole alive."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    loc = x.to_local()
    if loc.untyped_storage().nbytes() == loc.numel() * loc.element_size():
        return x
    return DTensor.from_local(loc.clone(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _slot_leaf(meta, spec, rules, seed, dtype=None):
    """A ``cache_seq`` leaf ``[n, B, S, KV, HD]``: this rank's shard drawn
    block by block (``LM_LONG_BLOCK`` slots, all KV heads, from a generator
    seeded by ``seed``, the layer and the block) in the leaf's dtype, kept
    in ``dtype`` (the leaf's by default), and placed."""
    import torch
    from torch.distributed.tensor import DTensor
    n, b, slots, kv, hd = meta.shape
    if rules.logical_size(spec[1]) != 1:
        raise AssertionError(f"lm_long_decode: the batch of {spec} is cut")
    s0, sn = rules.shard_range("cache_seq", slots)
    h0, hn = rules.shard_range("kv_heads", kv)
    dev = torch.device(DEVICE)
    local = torch.empty((n, b, sn, hn, hd), dtype=dtype or meta.dtype,
                        device=dev)
    gen = torch.Generator(dev)
    blk = LM_LONG_BLOCK
    for layer in range(n):
        for j in range(s0 // blk, -(-(s0 + sn) // blk)):
            gen.manual_seed(seed + 1_000_003 * layer + j)
            block = torch.randn((b, blk, kv, hd), generator=gen, device=dev,
                                dtype=meta.dtype)
            a, z = max(j * blk, s0), min((j + 1) * blk, s0 + sn)
            local[layer, :, a - s0:z - s0] = block[:, a - j * blk:z - j * blk,
                                                   h0:h0 + hn]
    if rules.mesh is None:
        return local
    return DTensor.from_local(local, rules.mesh,
                              rules.placements(*spec, shape=meta.shape),
                              run_check=False)


def long_cache(model, rules, slots, seed, dtype=None):
    """``model``'s decode caches at ``slots`` slots, seeded and placed as
    ``rules`` say, each rank drawing only what it keeps of a ``cache_seq``
    leaf (:func:`_slot_leaf`); the other leaves (Mamba2's conv and state,
    RWKV6's) are drawn whole from a generator seeded by ``seed`` and the
    leaf, then placed, each shard in its own storage.  With ``dtype`` the
    same draws are kept in that dtype."""
    import torch
    dev = torch.device(DEVICE)
    count = iter(range(1 << 30))

    def build(meta, spec):
        if isinstance(meta, dict):
            return {k: build(meta[k], spec[k]) for k in meta}
        if isinstance(meta, (list, tuple)):
            return type(meta)(build(m, s) for m, s in zip(meta, spec))
        leaf_seed = seed + 7_919 * next(count)
        if "cache_seq" in spec:
            return _slot_leaf(meta, spec, rules, leaf_seed, dtype)
        gen = torch.Generator(dev).manual_seed(leaf_seed)
        whole = torch.randn(meta.shape, generator=gen, device=dev,
                            dtype=meta.dtype).to(dtype or meta.dtype)
        return compact(rules.shard(whole, *spec))

    return build(model.init_cache(1, slots, device="meta"),
                 model.cache_logical_specs())


@contextlib.contextmanager
def recorded_logits():
    """The logits each serve step samples its token from, whole (the
    serving engine's ``greedy_sample`` wrapped while inside)."""
    from repro_torch.serve import engine
    from repro_torch.sharding.rules import full
    kept = []
    sample = engine.greedy_sample

    def recording(logits, vocab_size):
        kept.append(full(logits).detach().float().clone())
        return sample(logits, vocab_size)

    engine.greedy_sample = recording
    try:
        yield kept
    finally:
        engine.greedy_sample = sample


def long_decode(cfg, rules, slots, barrier=None, feed=None, upcast=False):
    """``LM_LONG_STEPS`` greedy steps of ``make_serve_step`` for ``cfg``
    (weights from ``LM_LONG_SEED``) over a cache of ``slots`` slots
    (:func:`long_cache`), from a seeded token at position ``slots -
    LM_LONG_STEPS``: the last step writes the last slot.  Each step feeds
    the token the step before chose, or with ``feed`` the one ``feed``
    holds for it (another run's).  With ``upcast`` the same weights and
    caches, drawn in ``cfg``'s dtype, are cast to float32 and decoded by
    the float32 model (the reference for ``cfg``'s rounding).  On a mesh
    (``barrier`` its ``dist.barrier``) every rank calls it.  Returns the
    tokens, the logits (CPU), each step's seconds, collectives
    (``sharding.wire``) and peak memory, and the local bytes of the
    weights and the caches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.costing import local_bytes
    from repro_torch.models.model import make_model
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.sharding import wire
    from repro_torch.train.optimizer import tree_map
    cuda = DEVICE != "cpu"
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    model = make_model(cfg, device=DEVICE)
    params = tree_map(compact, rules.tree_shard(model.init(seed=LM_LONG_SEED),
                                                model.param_specs()))
    cache = long_cache(model, rules, slots, LM_LONG_SEED + 1,
                       torch.float32 if upcast else None)
    if upcast:
        model = make_model(dataclasses.replace(cfg, dtype="float32"),
                           device=DEVICE)
        params = tree_map(lambda x: x.float(), params)
    step = make_serve_step(model, rules)
    if cuda:
        torch.cuda.synchronize()
    out = dict(setup_s=time.perf_counter() - t0,
               param_bytes=local_bytes(params),
               cache_bytes=local_bytes(cache), steps=[])
    first = int(np.random.default_rng(LM_LONG_SEED).integers(cfg.vocab_size))
    tok = torch.full((1, 1), first, dtype=torch.int32, device=dev)
    with recorded_logits() as logits, torch.no_grad():
        for i in range(LM_LONG_STEPS):
            pos = torch.full((1,), slots - LM_LONG_STEPS + i,
                             dtype=torch.int32, device=dev)
            if cuda:
                torch.cuda.synchronize()
            if barrier is not None:
                barrier()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            wire.WIRE.reset()
            t0 = time.perf_counter()
            nxt, cache = step(params, cache, {"tokens": tok, "pos": pos})
            token = int(nxt[0])                   # syncs with the device
            out["steps"].append(dict(
                s=time.perf_counter() - t0, token=token,
                wire=wire.WIRE.snapshot(),
                peak=torch.cuda.max_memory_allocated() if cuda else 0))
            tok = nxt[:, None] if feed is None else torch.full(
                (1, 1), feed[i], dtype=torch.int32, device=dev)
    out["tokens"] = [s["token"] for s in out["steps"]]
    out["logits"] = torch.cat(logits).cpu().numpy()   # numpy: across ranks
    return out


def long_runs():
    """``lm_long_decode``'s runs, ``(name, cfg, slots, upcast)``: ``full``,
    ``LM_TRAIN_ARCH`` at full width and depth in bf16 over
    ``LM_LONG_SLOTS`` cached tokens; ``full_f32``, the same draws decoded
    in float32 (:func:`long_decode` with ``upcast``); ``cut``, its first
    ``LM_LONG_CUT_LAYERS`` layers in float32 over ``LM_LONG_CUT_SLOTS``;
    ``rwkv``, ``LM_LONG_RWKV`` at ``LM_LONG_RWKV_LAYERS`` layers in bf16."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(LM_TRAIN_ARCH)
    return (("full", cfg, LM_LONG_SLOTS, False),
            ("full_f32", cfg, LM_LONG_SLOTS, True),
            ("cut", dataclasses.replace(cfg, num_layers=LM_LONG_CUT_LAYERS,
                                        dtype="float32"),
             LM_LONG_CUT_SLOTS, False),
            ("rwkv", dataclasses.replace(get_config(LM_LONG_RWKV),
                                         num_layers=LM_LONG_RWKV_LAYERS),
             LM_LONG_SLOTS, False))


def _lm_long_decode_rank(mesh):
    """One rank of ``lm_long_decode``: each of :func:`long_runs` under
    ``plan_for(cfg, "long_decode", mesh)`` (:func:`long_decode`), each rank
    holding its quarter of the shared block's caches (``cache_seq`` over
    'data', ``kv_heads`` over 'model').  Returns each run's tokens, logits
    (rank 0), per step seconds, wire and peak, local bytes and plan
    notes."""
    import torch
    import torch.distributed as dist
    from repro_torch.sharding.strategy import plan_for
    rank = dist.get_rank()
    torch.set_float32_matmul_precision("highest")      # float32: TF32 off
    out = {}
    t_all = time.perf_counter()
    for name, c, slots, upcast in long_runs():
        plan = plan_for(c, "long_decode", mesh)
        got = long_decode(c, plan.rules, slots, barrier=dist.barrier,
                          upcast=upcast)
        got["notes"] = list(plan.notes)
        if rank:
            del got["logits"]
        out[name] = got
        gc.collect()
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_all
    return out


def run_lm_long_decode(ranks, smi):
    """Phase ``lm_long_decode``, the parent's half, after the ranks of
    ``lm_train_mesh`` exited (``ranks``: their results): each of
    :func:`long_runs` decoded on one card (:func:`long_decode` with the
    one-card rules, fed rank 0's tokens, so that each step reads the same
    input) and rank 0's held against it, relative in the logits' norm:
      * a float32 run (``full_f32``, ``cut``): the tokens equal and the
        logits within ``LM_LONG_F32_RTOL`` at every step;
      * a bf16 run (``full``, ``rwkv``): the logits over the steps within
        ``LM_LONG_NOISE`` times the one card's own bf16 error (its logits
        against the same draws decoded in float32 on one card, fed the
        same tokens).  Random weights and seeded states amplify rounding
        over the layers and the steps, so that error is the model's own,
        and the mesh rounds on another path (bf16 partial sums over
        'model').  The tokens equal, but at a step where the one card's
        top two logits lie within ``LM_LONG_NOISE`` times the largest
        change bf16 rounding itself makes to a logit there (a near tie,
        reported: rounding alone can swap them).
    Prints and emits per rank the caches' and weights' local bytes, peak
    memory, seconds a step and the collectives a step by kind (calls,
    bytes, seconds).  Returns rank 0's last bf16 full-depth step's wire and
    peak and the local bytes, for the dry run."""
    import numpy as np
    import torch
    from repro_torch.sharding.rules import make_rules
    t0 = time.perf_counter()
    runs = long_runs()
    r0 = ranks[0]["long"]
    checks, failures, done = {}, [], {}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def one_card(c, slots, tokens, upcast):
        """The one-card decode fed ``tokens``; a float32 one is kept, as
        ``full`` and ``full_f32`` may need the same."""
        key = (c.name, c.num_layers, c.dtype, slots, tuple(tokens), upcast)
        got = done.get(key) or long_decode(c, make_rules(None), slots,
                                           feed=tokens, upcast=upcast)
        if upcast:
            done[key] = got
        gc.collect()
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
        return got

    for name, c, slots, upcast in runs:
        mesh = r0[name]
        one = one_card(c, slots, mesh["tokens"], upcast)
        f32 = upcast or c.dtype == "float32"
        steps = range(LM_LONG_STEPS)
        err = rel(mesh["logits"], one["logits"])
        top2 = np.sort(one["logits"][:, :c.vocab_size], axis=-1)[:, -2:]
        gap = (top2[:, 1] - top2[:, 0]).tolist()
        if f32:
            own = own_by_step = own_max = None
            rtol, ties = LM_LONG_F32_RTOL, []
        else:
            ref = one_card(c, slots, mesh["tokens"], True)["logits"]
            own = rel(one["logits"], ref)
            own_by_step = [rel(o, f) for o, f in zip(one["logits"], ref)]
            own_max = np.abs(one["logits"] - ref).max(axis=-1).tolist()
            rtol = LM_LONG_NOISE * own
            ties = [i for i in steps if gap[i] <= LM_LONG_NOISE * own_max[i]]
        by_step = [rel(m, o) for m, o in zip(mesh["logits"], one["logits"])]
        differ = [i for i in steps if mesh["tokens"][i] != one["tokens"][i]]
        checks[name] = dict(
            layers=c.num_layers, dtype="float32" if f32 else c.dtype,
            slots=slots, tokens=mesh["tokens"], one_card_tokens=one["tokens"],
            logits_rel=err, rtol=rtol, logits_rel_by_step=by_step,
            one_card_bf16_rel=own, one_card_bf16_rel_by_step=own_by_step,
            one_card_bf16_max_abs_by_step=own_max,
            logits_max_abs_diff=np.abs(mesh["logits"] - one["logits"]).max(
                axis=-1).tolist(),
            one_card_top2_gap=gap, near_ties=ties,
            one_card_step_s=[s["s"] for s in one["steps"]],
            one_card_peak=max(s["peak"] for s in one["steps"]),
            one_card_cache_bytes=one["cache_bytes"])
        if set(differ) - set(ties):
            failures.append(f"{name}: tokens {mesh['tokens']} against one "
                            f"card's {one['tokens']} (near ties {ties})")
        # a float32 run at every step, a bf16 run over its steps
        worst = max(by_step) if f32 else err
        if not worst <= rtol:
            failures.append(f"{name}: logits {worst} relative > {rtol}")
    done.clear()
    names = [r[0] for r in runs]
    per_rank = [{name: dict(
        cache_bytes=r["long"][name]["cache_bytes"],
        param_bytes=r["long"][name]["param_bytes"],
        setup_s=r["long"][name]["setup_s"],
        step_s=[s["s"] for s in r["long"][name]["steps"]],
        peak=[s["peak"] for s in r["long"][name]["steps"]],
        wire=[s["wire"] for s in r["long"][name]["steps"]])
        for name in names} for r in ranks]
    full, cfg = r0["full"], runs[0][1]
    emit(phase="lm_long_decode", arch=LM_TRAIN_ARCH, dtype=cfg.dtype,
         layers=cfg.num_layers, slots=LM_LONG_SLOTS, steps=LM_LONG_STEPS,
         first_pos=LM_LONG_SLOTS - LM_LONG_STEPS,
         mesh=dict(zip(("data", "model"), LM_MESH_SHAPE)),
         ranks=len(ranks), plan_notes=full["notes"], checks=checks,
         per_rank=per_rank, ranks_s=max(r["long"]["s"] for r in ranks),
         one_card_s=time.perf_counter() - t0, nvidia_smi=smi)
    steady = [max(r["long"]["full"]["steps"][i]["s"] for r in ranks)
              for i in range(LM_LONG_STEPS)]
    fc = checks["full"]
    print(f"lm_long_decode {LM_TRAIN_ARCH} over {LM_LONG_SLOTS} cached "
          f"tokens on {LM_MESH_SHAPE} ('data', 'model'): cache "
          f"{full['cache_bytes'] / 1e9:.3f} GB a rank (one card "
          f"{fc['one_card_cache_bytes'] / 1e9:.3f}), steps "
          f"{[round(s, 3) for s in steady]} s (one card "
          f"{[round(s, 3) for s in fc['one_card_step_s']]}), "
          f"peak {full['steps'][-1]['peak'] / 1e9:.3f} GB "
          f"on rank 0, tokens {full['tokens']} (one card "
          f"{fc['one_card_tokens']}), logits {fc['logits_rel']:.3e} relative, "
          f"by step {[f'{e:.3e}' for e in fc['logits_rel_by_step']]} (one "
          f"card's own bf16 error {fc['one_card_bf16_rel']:.3e}, by step "
          f"{[f'{e:.3e}' for e in fc['one_card_bf16_rel_by_step']]}); "
          f"float32 full depth "
          f"{max(checks['full_f32']['logits_rel_by_step']):.3e}, cut "
          f"{max(checks['cut']['logits_rel_by_step']):.3e}; RWKV6 tokens "
          f"{checks['rwkv']['tokens']} [{smi}]", flush=True)
    emit(phase="lm_long_decode_total",
         seconds=max(r["long"]["s"] for r in ranks)
         + time.perf_counter() - t0)
    if failures:
        raise AssertionError(f"lm_long_decode checks: {failures}")
    last = full["steps"][-1]
    return {"step_wire": last["wire"], "step_peak": last["peak"],
            "arguments": full["param_bytes"] + full["cache_bytes"]}


# ---------------------------------------------------------------------------
# dryrun: the LM dry run (launch/dryrun.py) against the training phases
# ---------------------------------------------------------------------------

DRYRUN_JOBS = ("one_card", "mesh", "long_decode", "production")
DRYRUN_PRODUCTION = ("gemma2-9b", "train_4k")   # on pod16x16, 256 fake ranks
DRYRUN_PEAK_RANGE = (0.75, 1.25)   # predicted over measured step-1 peak
DRYRUN_TIMEOUT_S = 900


def _dryrun_job(job, out_path):
    """One dry run in a spawned process (``run_cell`` under
    ``FakeTensorMode`` on a fake process group, the card's device type,
    nothing allocated), its record written to ``out_path``: ``one_card``
    is ``lm_train``'s step (``LM_TRAIN_ARCH`` unsharded, ``LM_TRAIN_BATCH``
    x ``LM_TRAIN_SEQ`` as ``LM_TRAIN_MICRO`` microbatches through the
    ``TRAIN_MICROBATCHES`` flag), ``mesh`` is ``lm_train_mesh``'s
    (``LM_MESH_SHAPE``, ``LM_MESH_BATCH`` x ``LM_MESH_SEQ``),
    ``long_decode`` is ``lm_long_decode``'s step at full width and depth
    (``LM_MESH_SHAPE``, one token over ``LM_LONG_SLOTS`` cached), and
    ``production`` the ``DRYRUN_PRODUCTION`` cell on the 256-rank
    production mesh, whose artifact (its FLOPs by operation included)
    lands in ``artifacts/dryrun_torch/``."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import flags
    device = "cpu" if DEVICE == "cpu" else None
    out_dir = os.path.join(REPO, dryrun.DEFAULT_OUT)
    if job == "one_card":
        flags.set_flag("TRAIN_MICROBATCHES", str(LM_TRAIN_MICRO))
        rec = dryrun.run_cell(
            LM_TRAIN_ARCH, ShapeSpec("lm_train", "train", LM_TRAIN_SEQ,
                                     LM_TRAIN_BATCH),
            multi_pod=False, out_dir=out_dir,
            device=device, mesh_shape=())
    elif job == "mesh":
        rec = dryrun.run_cell(
            LM_TRAIN_ARCH, ShapeSpec("lm_train_mesh", "train", LM_MESH_SEQ,
                                     LM_MESH_BATCH),
            multi_pod=False, out_dir=out_dir,
            device=device, mesh_shape=LM_MESH_SHAPE)
    elif job == "long_decode":
        rec = dryrun.run_cell(
            LM_TRAIN_ARCH, ShapeSpec("lm_long_decode", "long_decode",
                                     LM_LONG_SLOTS, 1),
            multi_pod=False, out_dir=out_dir,
            device=device, mesh_shape=LM_MESH_SHAPE)
    else:
        rec = dryrun.run_cell(*DRYRUN_PRODUCTION, multi_pod=False,
                              out_dir=out_dir, device=device)
    with open(out_path, "w") as f:
        json.dump(rec, f)


def start_dryrun(tmp_root):
    """Phase ``dryrun``, first half: the three dry runs of
    :func:`_dryrun_job` started in spawned processes, one each.  They need
    the host's CPU and no card memory, so they run while the kernel and
    LM phases use the card; :func:`finish_dryrun` joins them."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out = tempfile.mkdtemp(prefix="dryrun-", dir=tmp_root)
    jobs = {}
    for job in DRYRUN_JOBS:
        path = os.path.join(out, job + ".json")
        proc = ctx.Process(target=_dryrun_job, args=(job, path), daemon=True)
        proc.start()
        jobs[job] = (proc, path)
    return {"jobs": jobs, "dir": out, "t0": time.perf_counter()}


def finish_dryrun(started, lm_train, lm_mesh, smi):
    """Phase ``dryrun``, second half: joins the dry runs, then
      * one card: the predicted peak (rank 0's arguments plus the peak of
        live bytes the step created) within ``DRYRUN_PEAK_RANGE`` of
        ``lm_train``'s measured step-1 peak;
      * the (2, 2) mesh: rank 0's collective calls and operand bytes by
        kind equal to those ``lm_train_mesh``'s rank 0 measured in step 1
        (``sharding.wire``), and its predicted peak within the range of
        rank 0's measured step-1 peak;
      * the long-context decode step on that mesh: rank 0's collectives by
        kind equal to those of ``lm_long_decode``'s last full-depth step
        on rank 0, call for call and byte for byte, and its predicted peak
        within ``LM_LONG_PEAK_RANGE`` of that step's measured peak;
      * the production cell finished; prints its per-rank memory, FLOPs,
        bytes, transcendentals and collectives.
    Prints each job's trace seconds; raises on any miss."""
    from repro_torch.launch.dryrun import collective_bytes_from_wire
    t_wait = time.perf_counter()
    recs = {}
    try:
        for job, (proc, path) in started["jobs"].items():
            proc.join(max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter()
                                                   - started["t0"])))
            if proc.is_alive() or proc.exitcode != 0 or not os.path.exists(
                    path):
                raise AssertionError(f"dryrun {job}: the job ended with "
                                     f"{proc.exitcode} (alive "
                                     f"{proc.is_alive()})")
            with open(path) as f:
                recs[job] = json.load(f)
            if not recs[job].get("ok"):
                raise AssertionError(f"dryrun {job}: {recs[job].get('error')}"
                                     f"\n{recs[job].get('traceback')}")
    finally:
        for proc, _ in started["jobs"].values():
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(started["dir"], ignore_errors=True)
    wait_s = time.perf_counter() - t_wait

    def predicted(rec):
        m = rec["memory_analysis"]
        return m["argument_size_in_bytes"] + m["temp_size_in_bytes"]

    checks = {}
    for job, measured in (("one_card", lm_train["step1_peak"]),
                          ("mesh", lm_mesh["step1_peak"])):
        ratio = predicted(recs[job]) / measured if measured else None
        checks[job] = dict(predicted_peak=predicted(recs[job]),
                           measured_step1_peak=measured, ratio=ratio,
                           memory=recs[job]["memory_analysis"],
                           flops=recs[job]["cost_analysis"]["flops"],
                           trace_s=recs[job]["trace_s"])
    real = collective_bytes_from_wire(lm_mesh["step1_wire"])
    dry = recs["mesh"]["collectives"]
    wire_equal = (real["counts"] == dry["counts"]
                  and real["by_op"] == dry["by_op"])
    long = lm_mesh["long"]
    long_rec = recs["long_decode"]
    long_real = collective_bytes_from_wire(long["step_wire"])
    long_dry = long_rec["collectives"]
    long_equal = (long_real["counts"] == long_dry["counts"]
                  and long_real["by_op"] == long_dry["by_op"])
    long_ratio = (predicted(long_rec) / long["step_peak"]
                  if long["step_peak"] else None)
    checks["long_decode"] = dict(
        predicted_peak=predicted(long_rec),
        measured_step_peak=long["step_peak"], ratio=long_ratio,
        measured_arguments=long["arguments"],
        memory=long_rec["memory_analysis"],
        flops=long_rec["cost_analysis"]["flops"],
        trace_s=long_rec["trace_s"], collectives_dry=long_dry,
        collectives_measured=long_real, wire_equal=long_equal)
    prod = recs["production"]
    emit(phase="dryrun", **{f"{job}_check": c for job, c in checks.items()},
         mesh_collectives_dry=dry, mesh_collectives_measured=real,
         mesh_wire_equal=wire_equal, production=dict(
             arch=prod["arch"], shape=prod["shape"], mesh=prod["mesh"],
             chips=prod["chips"], rank=prod["rank"],
             memory=prod["memory_analysis"], cost=prod["cost_analysis"],
             collectives=prod["collectives"], plan_notes=prod["plan_notes"],
             trace_s=prod["trace_s"], flops_by_op=prod["flops_by_op"][:8]),
         trace_s={job: r["trace_s"] for job, r in recs.items()},
         wall_s=time.perf_counter() - started["t0"], wait_s=wait_s,
         nvidia_smi=smi)
    for job, c in checks.items():
        measured = c.get("measured_step1_peak", c.get("measured_step_peak"))
        print(f"dryrun {job}: predicted peak {c['predicted_peak'] / 1e9:.3f} "
              f"GB (arguments {c['memory']['argument_size_in_bytes'] / 1e9:.3f}"
              f" + temp {c['memory']['temp_size_in_bytes'] / 1e9:.3f}) vs "
              f"measured step peak {(measured or 0) / 1e9:.3f}"
              f" GB, ratio {c['ratio']}; trace {c['trace_s']} s [{smi}]",
              flush=True)
    print(f"dryrun long_decode {LM_MESH_SHAPE}: rank 0 collectives "
          f"{long_dry['counts']} {long_dry['by_op']} B; lm_long_decode rank "
          f"0 {long_real['counts']} {long_real['by_op']} B; equal "
          f"{long_equal}; arguments "
          f"{long_rec['memory_analysis']['argument_size_in_bytes']} B "
          f"predicted, {long['arguments']} B of weights and caches held",
          flush=True)
    print(f"dryrun mesh {LM_MESH_SHAPE}: rank 0 collectives {dry['counts']} "
          f"{dry['by_op']} B; lm_train_mesh rank 0 step 1 {real['counts']} "
          f"{real['by_op']} B; equal {wire_equal}", flush=True)
    pm = prod["memory_analysis"]
    print(f"dryrun {prod['arch']} {prod['shape']} {prod['mesh']} rank 0: "
          f"arguments {pm['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
          f"{pm['temp_size_in_bytes'] / 1e9:.3f} GB, outputs "
          f"{pm['output_size_in_bytes'] / 1e9:.3f} GB; matmul FLOPs "
          f"{prod['cost_analysis']['flops']:.4e}, bytes accessed "
          f"{prod['cost_analysis']['bytes_accessed']:.4e}, transcendentals "
          f"{prod['cost_analysis']['transcendentals']:.4e}; collectives "
          f"{prod['collectives']['counts']} "
          f"{prod['collectives']['total_operand_bytes']} B; trace "
          f"{prod['trace_s']} s", flush=True)
    if not wire_equal:
        raise AssertionError(f"dryrun mesh: rank 0's collectives {dry} differ "
                             f"from the measured {real}")
    if not long_equal:
        raise AssertionError(f"dryrun long_decode: rank 0's collectives "
                             f"{long_dry} differ from the measured "
                             f"{long_real}")
    for job, c in checks.items():
        lo, hi = (LM_LONG_PEAK_RANGE if job == "long_decode"
                  else DRYRUN_PEAK_RANGE)
        if c["ratio"] is None or not lo <= c["ratio"] <= hi:
            raise AssertionError(f"dryrun {job}: predicted peak over measured "
                                 f"{c['ratio']}, outside {(lo, hi)}")


# ---------------------------------------------------------------------------
# The kernel entry point (repro_torch.kernels.ops) at full width
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# mesh_path: the SHARD_MAP executor, 8 gloo ranks sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 8                 # one rank per partition
MESH_MQ_ITERS = 2              # multi_bfs depth on the mesh
MESH_TIMEOUT_S = 600           # the mesh job's deadline (and gloo's timeout)
MESH_DENSE_BFS_ITERS = 3       # (c)'s depth
# the counters tests/test_distributed_engine.py holds SHARD_MAP to
MESH_PR_COUNTERS = ("msgs_generated", "msgs_sent", "net_bytes",
                    "net_bytes_raw", "edge_read_bytes", "edge_read_bytes_raw",
                    "chunks_read_csr", "chunks_read_dcsr",
                    "chunks_read_dcsr_delta")
MESH_WIRE_KEYS = ("net_payload_elems", "net_payload_elems_dense",
                  "measured_net_payload_elems", "exchange_compacted_iters",
                  "exchange_dense_iters")


def save_structures(root, dg, fm):
    """Write every tensor field of the graph and its formats as one ``.npy``
    file under ``root``, and their other fields as JSON: the ranks map
    them instead of rebuilding or copying the graph."""
    import dataclasses
    import numpy as np
    os.makedirs(root, exist_ok=True)
    statics = {}
    for kind, obj in (("dg", dg), ("fm", fm)):
        statics[kind] = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if hasattr(v, "numpy"):
                np.save(os.path.join(root, f"{kind}.{f.name}.npy"),
                        v.cpu().numpy())
            elif dataclasses.is_dataclass(v):
                statics[kind][f.name] = dataclasses.asdict(v)
            else:
                statics[kind][f.name] = v
    with open(os.path.join(root, "statics.json"), "w") as f:
        json.dump(statics, f)


_STRUCTURES = {}


def structures(tmp, dg, fm):
    """(root, write seconds, bytes) of the graph's structures saved under
    ``tmp`` (:func:`save_structures`), written on the first call only:
    the process-mode ranks and the mesh ranks map the same files."""
    if tmp not in _STRUCTURES:
        root = os.path.join(tmp, "structures")
        t0 = time.perf_counter()
        save_structures(root, dg, fm)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for f in os.listdir(root))
        _STRUCTURES[tmp] = (root, write_s, nbytes)
    return _STRUCTURES[tmp]


def load_structures(root):
    """(DistGraph, ChunkFormats) on the host over read-only maps of the
    files :func:`save_structures` wrote: no copy is made (the engine only
    reads the host graph and moves its own rows to the device)."""
    import dataclasses
    import warnings
    import numpy as np
    import torch
    from repro_torch.core.formats import ChunkFormats
    from repro_torch.core.partition import DistGraph, TwoLevelSpec
    with open(os.path.join(root, "statics.json")) as f:
        statics = json.load(f)
    out = []
    for kind, cls in (("dg", DistGraph), ("fm", ChunkFormats)):
        kw = {}
        for fld in dataclasses.fields(cls):
            if fld.name in statics[kind]:
                kw[fld.name] = statics[kind][fld.name]
                continue
            arr = np.load(os.path.join(root, f"{kind}.{fld.name}.npy"),
                          mmap_mode="r")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # read-only map
                kw[fld.name] = torch.from_numpy(arr)
        if kind == "dg":
            spec = kw["spec"]
            kw["spec"] = TwoLevelSpec(**{**spec, "boundaries":
                                         tuple(spec["boundaries"])})
        out.append(cls(**kw))
    return tuple(out)


@contextlib.contextmanager
def recorded_live_combine(module):
    """Record the arguments of the combine call with the most live tiles
    that the engine makes through ``module.block_csr_combine`` inside the
    block (a mesh rank's calls all have the same slot count; their live
    tiles differ)."""
    real = module.block_csr_combine
    seen = {}

    def recording(*args, **kw):
        live = live_slots(args[3])
        if not seen or live > seen["live"]:
            seen.update(args=args, kw=kw, live=live)
        return real(*args, **kw)

    module.block_csr_combine = recording
    try:
        yield seen
    finally:
        module.block_csr_combine = real


def _mesh_rank(mesh, root, source, first):
    """One rank of the mesh_path phase: the graph mapped from ``root``,
    its own row on the card, then (a) PageRank and (b) BFS under
    block_csr with the exchange auto (on), (c) BFS with it off for
    ``MESH_DENSE_BFS_ITERS``, (d) ``multi_bfs`` of ``first`` (Q = 8,
    segment, 2 iterations).  The rank
    with the most live tiles in its largest combine call of (a) (add) and
    of (b) (min) replays it against the plain version while the others
    wait.  Returns per run the counters, launches, the exchange log and
    peak memory, the values' digest (rank 0 also the values)."""
    entered = time.time()
    import hashlib
    import numpy as np
    import torch
    from repro_torch.core import Engine, EngineConfig, phases
    from repro_torch.core import algorithms as alg
    from repro_torch.kernels import csr_spmv
    cuda = mesh.device.type == "cuda"
    t0 = time.perf_counter()
    dg, fm = load_structures(root)
    if cuda:
        csr_spmv._library()        # built by the parent: loaded here
    out = dict(rank=mesh.rank, entered=entered,
               load_s=time.perf_counter() - t0, runs={}, replays={})

    def run(name, eng, drive):
        csr_spmv.block_csr_combine.launches = 0
        csr_spmv.block_csr_combine_mq.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        n_log = len(eng.mesh_log)
        mesh.barrier()
        t0 = time.perf_counter()
        with recorded_live_combine(phases) as big:
            vals, st = drive(eng)
        if cuda:
            torch.cuda.synchronize()
        rec = dict(
            seconds=time.perf_counter() - t0, iterations=st.iterations,
            counters=dict(st.counters), log=eng.mesh_log[n_log:],
            returns=[np.asarray(r).tolist() for r in st.per_iter_return],
            launches=csr_spmv.block_csr_combine.launches,
            launches_mq=csr_spmv.block_csr_combine_mq.launches,
            peak=torch.cuda.max_memory_allocated() if cuda else 0,
            digest=hashlib.sha256(
                np.ascontiguousarray(vals).tobytes()).hexdigest())
        if mesh.rank == 0:
            rec["values"] = vals
        out["runs"][name] = rec
        return big

    def replay(big, mode):
        """The largest call over the ranks, replayed on the rank that made
        it against the plain version and timed; the others wait."""
        live = torch.tensor([[big.get("live", -1)]], dtype=torch.int64)
        lives = mesh.all_gather(live)[:, 0]
        owner = int(torch.argmax(lives))
        if mesh.rank == owner:
            if big["kw"]["mode"] != mode:
                raise AssertionError(f"mesh: combine ran mode "
                                     f"{big['kw']['mode']}, expected {mode}")
            row = check_kernel(csr_spmv, big["args"], big["kw"], "mesh")
            out["replays"][mode] = dict(row, rank=owner,
                                        live_tiles=int(lives[owner]))
        mesh.barrier()

    blk = EngineConfig(compute_backend="block_csr")
    eng = Engine(dg, fm, blk, mesh=mesh)
    big = run("pagerank", eng, lambda e: alg.pagerank(e, PR_ITERS))
    replay(big, "add")
    del big
    big = run("bfs", eng, lambda e: alg.bfs(e, source))
    replay(big, "min")
    del big, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    eng = Engine(dg, fm, EngineConfig(compute_backend="block_csr",
                                      physical_sparse_exchange=False),
                 mesh=mesh)
    run("bfs_dense", eng,
        lambda e: alg.bfs(e, source, MESH_DENSE_BFS_ITERS))
    del eng
    gc.collect()
    eng = Engine(dg, fm, EngineConfig(num_queries=len(first)), mesh=mesh)
    run("multi_bfs", eng,
        lambda e: alg.multi_bfs(e, first, max_iters=MESH_MQ_ITERS))
    del eng
    return out


def run_mesh_path(tmp, *, dg, fm, source, first, local_results):
    """The mesh_path phase (9d) of :func:`main`: the SHARD_MAP executor on
    ``MESH_RANKS`` gloo ranks sharing the card (:func:`_mesh_rank`), held
    against LOCAL.  Returns the launch counts and the combine rows."""
    import numpy as np
    import torch
    from repro_torch.core import Engine, EngineConfig, run_mesh
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import COUNTER_KEYS
    from repro_torch.core.exchange import choose_physical_exchange
    from repro_torch.core.sparse_collectives import capacity_bucket

    # LOCAL multi_bfs at the mesh run's depth (segment, Q = 8)
    t0 = time.perf_counter()
    local = Engine(dg, fm, EngineConfig(num_queries=len(first)))
    mq_vals, mq_stats = alg.multi_bfs(local, first, max_iters=MESH_MQ_ITERS)
    torch.cuda.synchronize()
    local_mq_s = time.perf_counter() - t0
    # and LOCAL BFS at (c)'s depth
    dense_vals, dense_stats = alg.bfs(local, source, MESH_DENSE_BFS_ITERS)
    del local
    gc.collect()
    torch.cuda.empty_cache()
    root, write_s, nbytes = structures(tmp, dg, fm)

    # An all-active frontier sends every need list whole (the filter never
    # skips: a need list is no longer than its partition's messages), so
    # PageRank's bound is the largest need list; the reference's
    # arbitration decides from it alone.
    all_active_bound = int(dg.need_counts.max())
    all_active_compacts = choose_physical_exchange(
        capacity_bucket(all_active_bound), dg.spec.v_max,
        EngineConfig().msg_bytes)
    t_spawn, t0 = time.time(), time.perf_counter()
    ranks = run_mesh(
        _mesh_rank, MESH_RANKS, timeout_s=MESH_TIMEOUT_S,
        device="cpu" if DEVICE == "cpu" else None,
        args=(root, source, first))
    job_s = time.perf_counter() - t0
    emit(phase="mesh_setup", ranks=MESH_RANKS, backend="gloo",
         structures_bytes=nbytes, write_s=write_s, local_multi_bfs_s=local_mq_s,
         job_s=job_s, spawn_s=max(r["entered"] for r in ranks) - t_spawn,
         load_s=[r["load_s"] for r in ranks],
         all_active_bound=all_active_bound, v_max=dg.spec.v_max,
         all_active_compacts=all_active_compacts)

    def same_on_every_rank(name):
        r0 = ranks[0]["runs"][name]
        for r in ranks[1:]:
            rr = r["runs"][name]
            if (rr["digest"] != r0["digest"] or rr["counters"] != r0["counters"]
                    or rr["iterations"] != r0["iterations"]):
                raise AssertionError(f"mesh {name}: rank {r['rank']} differs "
                                     "from rank 0")
        return r0

    def check_counters(name, c, ref, keys):
        for k in keys:
            if abs(c[k] - ref[k]) > 1e-5 * abs(ref[k]) + 1e-3:
                raise AssertionError(f"mesh {name}: counter {k} = {c[k]}, "
                                     f"LOCAL {ref[k]}")

    def check_launches(name, rec, per_pe):
        for r in ranks:
            rr = r["runs"][name]
            if rr["launches"] != (per_pe * rr["iterations"] if per_pe else 0):
                raise AssertionError(
                    f"mesh {name}: rank {r['rank']} launched the combine "
                    f"{rr['launches']} times in {rr['iterations']} "
                    "ProcessEdges")
            if rr["launches_mq"]:
                raise AssertionError(f"mesh {name}: the panel combine ran")
        return sum(r["runs"][name]["launches"] for r in ranks)

    results, totals = {}, {}
    for name in ("pagerank", "bfs", "bfs_dense", "multi_bfs"):
        rec = same_on_every_rank(name)
        c, vals = rec["counters"], rec["values"]
        if abs(c["measured_net_payload_elems"] - c["net_payload_elems"]) > 0.5:
            raise AssertionError(f"mesh {name}: measured payload "
                                 f"{c['measured_net_payload_elems']} != model "
                                 f"{c['net_payload_elems']}")
        pes = len(rec["log"])
        if name != "multi_bfs" and pes != rec["iterations"]:
            raise AssertionError(f"mesh {name}: {pes} ProcessEdges logged in "
                                 f"{rec['iterations']} iterations")
        if c["exchange_compacted_iters"] + c["exchange_dense_iters"] != pes:
            raise AssertionError(f"mesh {name}: {pes} exchanges, counted "
                                 f"{c['exchange_compacted_iters']} + "
                                 f"{c['exchange_dense_iters']}")
        if name == "pagerank":
            lv, ls = local_results["pagerank"]
            np.testing.assert_allclose(vals, lv, rtol=1e-5, atol=1e-5)
            check_counters(name, c, ls.counters, MESH_PR_COUNTERS)
            if c["exchange_compacted_iters"] != (pes if all_active_compacts
                                                 else 0):
                raise AssertionError(
                    "mesh pagerank: the all-active iterations did not all "
                    f"take the wire the largest need list "
                    f"({all_active_bound}) implies (compacted: "
                    f"{all_active_compacts})")
        elif name in ("bfs", "bfs_dense"):
            lv, ls = (local_results["bfs"] if name == "bfs"
                      else (dense_vals, dense_stats))
            if not np.array_equal(vals.view(np.int32), lv.view(np.int32)) \
                    or rec["iterations"] != ls.iterations:
                raise AssertionError(f"mesh {name}: levels differ from "
                                     "LOCAL's")
            check_counters(name, c, ls.counters,
                           [k for k in COUNTER_KEYS
                            if k not in MESH_WIRE_KEYS])
            if name == "bfs" and c["exchange_compacted_iters"] < 1:
                raise AssertionError("mesh bfs: no iteration went compacted")
            if name == "bfs_dense" and (
                    c["exchange_compacted_iters"] or rec["returns"]
                    != results["bfs"]["returns"][:rec["iterations"]]):
                raise AssertionError("mesh bfs with the exchange off is not "
                                     "all dense and equal to it on")
        else:
            if not np.array_equal(vals.view(np.int32),
                                  mq_vals.view(np.int32)) \
                    or rec["iterations"] != mq_stats.iterations:
                raise AssertionError("mesh multi_bfs differs from LOCAL's")
            check_counters(name, c, mq_stats.counters,
                           [k for k in COUNTER_KEYS
                            if k not in MESH_WIRE_KEYS])
        launches = totals[name] = check_launches(
            name, rec, 0 if name == "multi_bfs" else 1)
        n_log = len(rec["log"])
        per_iter = [dict(
            exchange_s=max(r["runs"][name]["log"][i]["exchange_s"]
                           for r in ranks),
            payload_elems=sum(r["runs"][name]["log"][i]["payload_elems"]
                              for r in ranks),
            payload_bytes=sum(r["runs"][name]["log"][i]["payload_bytes"]
                              for r in ranks),
            compacted=rec["log"][i]["compacted"],
            capacity=rec["log"][i]["capacity"]) for i in range(n_log)]
        emit(phase="mesh_path", run=name, ranks=MESH_RANKS,
             iterations=rec["iterations"],
             seconds=max(r["runs"][name]["seconds"] for r in ranks),
             launches=launches,
             launches_mq=sum(r["runs"][name]["launches_mq"] for r in ranks),
             exchange_compacted_iters=c["exchange_compacted_iters"],
             exchange_dense_iters=c["exchange_dense_iters"],
             net_payload_elems=c["net_payload_elems"],
             net_payload_elems_dense=c["net_payload_elems_dense"],
             exchange_per_iteration=per_iter,
             compute_s_per_rank=[sum(x["compute_s"]
                                     for x in r["runs"][name]["log"])
                                 for r in ranks],
             wire_s_per_rank=[sum(x["wire_s"] for x in r["runs"][name]["log"])
                              for r in ranks],
             peak_memory_per_rank=[r["runs"][name]["peak"] for r in ranks])
        results[name] = rec
    replays = {}
    for r in ranks:
        replays.update(r["replays"])
    if set(replays) != {"add", "min"}:
        raise AssertionError(f"mesh: replays {sorted(replays)}")
    return dict(
        launches={"add": totals["pagerank"],
                  "min": totals["bfs"] + totals["bfs_dense"]},
        combine_rows={m: {k: replays[m][k] for k in ROW_KEYS}
                      for m in ("add", "min")})


# ---------------------------------------------------------------------------
# Process mode: DIST_OOC's logical workers on OS ranks, over sockets
# ---------------------------------------------------------------------------

PROC_RANKS = 2                 # OS ranks sharing the card, 2 workers each
PROC_TIMEOUT_S = 900           # the ranks' deadline and the transport's I/O
PROC_KILL = (1, 2, "recv")     # the recovery run: worker 1's rank dies at
                               # ProcessEdges call 2, before its receive
PROC_LAUNCH_KEYS = ("combine", "decode", "decode_items", "stencil", "add",
                    "max", "gap_streams", "pinned_copies")


def _proc_rank(root, jobs, rank):
    """One OS rank of the proc_path phase: maps the graph's structures
    from ``root`` (no rebuild), loads the kernels the parent built, then
    runs each ``(spec, replays)`` of ``jobs`` in turn through the port's
    worker body (``procworker.run_rank``) with the DIST launch counts set
    to 0 just before and read just after.  Rank 0 replays the run's
    largest combine call (``"combine"``), streamed item (``"decode"``) and
    wire gap stream (``"wire"``) against their plain versions while the
    other rank waits in the final barrier.  Each job leaves the rank's
    ``result_r{rank}.npz`` and ``smoke_r{rank}.json`` (seconds, memory,
    checkpoint cost, wire, recovery, launches, replays) in its result
    directory.  The rank a fault plan kills exits with ``FAULT_EXIT``."""
    entered = time.time()
    import torch
    from repro_torch.core import executor
    from repro_torch.kernels import chunk_decode, csr_spmv, varint
    from repro_torch.runtime import procworker
    t0 = time.perf_counter()
    dg, fm = load_structures(root)
    device = jobs[0][0].get("device") or "cuda"
    cuda = device != "cpu"
    if cuda:
        csr_spmv._library()        # built by the parent: loaded here
        varint._library()
        chunk_decode._library()
    load_s = time.perf_counter() - t0
    dev = torch.device(device)
    if cuda:
        torch.zeros(1, device=dev)     # the CUDA context, before the runs
    ready = time.time()
    for spec, replays in jobs:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        copies0 = reset_dist_counts()
        t0 = time.perf_counter()
        with recorded_combine(executor, largest=True) as big, \
                recorded_decode(dev) as item, \
                recorded_gap_streams() as gaps:
            job = procworker.run_rank(spec, rank, dg.spec, dg, fm)
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        ctx, eng = job["ctx"], job["engine"]
        stats = dict(
            rank=rank, entered=entered, ready=ready, load_s=load_s,
            wall_s=wall_s,
            peak=torch.cuda.max_memory_allocated() if cuda else 0,
            launches=dist_counts(gaps, copies0), ckpt=dict(eng.proc_ckpt),
            wire_frames=int(ctx.stats["wire_frames"].sum()),
            socket_payload_bytes=int(ctx.stats["socket_payload_bytes"]),
            rank_local_wire_bytes=int(ctx.stats["rank_local_wire_bytes"]),
            recoveries=int(ctx.stats["recoveries"]),
            recovery_s=ctx.recovery_s, assign=list(ctx.assign),
            stall_reports=ctx.mesh.stall_reports,
            workers=ctx.my_workers(), replays={})
        if rank == 0:
            if "combine" in replays:
                stats["replays"]["combine"] = check_kernel(
                    csr_spmv, big["args"], big["kw"], "proc")
                stats["replays"]["mode"] = big["kw"]["mode"]
            if "decode" in replays:
                stats["replays"]["decode"] = check_decode_item(
                    item["host"], item["plan"], dev)
            if "wire" in replays:
                stencil_row, add_row, trip = check_wire_stream(
                    *gaps["largest"], dev)
                stats["replays"].update(stencil=stencil_row, add=add_row,
                                        wire_trip=trip)
        procworker.write_result(spec["result_dir"], rank, job["out"])
        with open(os.path.join(spec["result_dir"],
                               f"smoke_r{rank}.json"), "w") as f:
            json.dump(stats, f)
        del big, item, gaps, job, eng
        ctx.finalize()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def run_proc_path(tmp, *, dg, fm, store, source, scale, dist):
    """The proc_path phase (9e) of :func:`main`: process-mode DIST_OOC on
    ``PROC_RANKS`` OS ranks sharing the card (:func:`_proc_rank`), the W =
    4 logical workers of :func:`run_dist_ooc`'s sharded store two to a
    rank, with the reference's run specs: PageRank (2) and BFS
    failure-free, then BFS with worker 1's rank killed at ProcessEdges
    call 2 (``PROC_KILL``).  Held against the in-thread DIST_OOC runs
    ``dist``: values, iterations, per-iteration returns, every counter and
    ``worker_totals`` bit for bit, launches summed over the ranks equal to
    the thread runs', and the socket's payload bytes plus the bytes handed
    between two workers of one rank equal to ``measured_net_bytes``.
    Returns the launch counts and the kernel rows."""
    import numpy as np
    from repro_torch.runtime.faults import FAULT_EXIT, FaultPlan
    from repro_torch.runtime.procworker import load_result
    root, write_s, nbytes = structures(tmp, dg, fm)
    spec = dg.spec
    base = dict(
        world=PROC_RANKS, num_workers=DIST_WORKERS,
        graph=dict(scale=scale, edge_factor=16, seed=0, weighted=True),
        spec=dict(num_partitions=spec.num_partitions,
                  batch_size=spec.batch_size),
        store_root=store.root, io_timeout=PROC_TIMEOUT_S,
        stall_timeout=120.0,
        engine=dict(compute_backend="block_csr", verify_io=True))
    if DEVICE == "cpu":
        base["device"] = "cpu"
    pagerank = {"name": "pagerank", "args": {"num_iters": PR_ITERS}}
    bfs = {"name": "bfs", "args": {"source": source}}
    kill = FaultPlan([FaultPlan.kill(*PROC_KILL)]).to_json()
    runs = (("pagerank", pagerank, None, ("combine",)),
            ("bfs", bfs, None, ("combine", "decode", "wire")),
            ("bfs_recovery", bfs, kill, ()))
    jobs, dirs = [], {}
    for name, algo, plan, replays in runs:
        d = dirs[name] = os.path.join(tmp, "proc", name)
        for sub in ("rdv", "out"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        jobs.append((dict(base, run_id=f"smoke-{name}",
                          rendezvous=os.path.join(d, "rdv"),
                          result_dir=os.path.join(d, "out"),
                          algorithm=algo, fault_plan=plan), replays))

    import multiprocessing
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_proc_rank, args=(root, jobs, r),
                        name=f"proc-rank-{r}") for r in range(PROC_RANKS)]
    t_spawn, t0 = time.time(), time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, PROC_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    job_s = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    want_codes = [FAULT_EXIT if r == PROC_KILL[0] % PROC_RANKS else 0
                  for r in range(PROC_RANKS)]
    if codes != want_codes:             # a stall's report is on stderr
        raise AssertionError(f"proc_path: rank exit codes {codes}, expected "
                             f"{want_codes}")

    def stats_of(name, r):
        with open(os.path.join(dirs[name], "out", f"smoke_r{r}.json")) as f:
            return json.load(f)

    first = [stats_of("pagerank", r) for r in range(PROC_RANKS)]
    emit(phase="proc_setup", ranks=PROC_RANKS, workers=DIST_WORKERS,
         exit_codes=codes,
         structures_bytes=nbytes, structures_write_s=write_s, job_s=job_s,
         spawn_s=[st["entered"] - t_spawn for st in first],
         load_s=[st["load_s"] for st in first],
         ready_s=[st["ready"] - t_spawn for st in first])

    def check_result(name, res, ref, path):
        stats = ref["stats"]
        names = sorted(stats.counters)
        totals = ref["totals"]
        if not np.array_equal(res["values"].view(np.int32),
                              ref["values"].view(np.int32)) \
                or int(res["iterations"]) != stats.iterations \
                or not np.array_equal(res["rets"], np.asarray(
                    stats.per_iter_return, np.float64)) \
                or [str(n) for n in res["counter_names"]] != names \
                or not np.array_equal(res["counter_vals"], np.asarray(
                    [stats.counters[k] for k in names], np.float64)):
            raise AssertionError(f"{path}: values, iterations, returns or "
                                 "counters differ from the in-thread run")
        for key, field in (("wt_disk", "disk_bytes"),
                           ("wt_net", "net_bytes"),
                           ("wt_edges", "edges_touched")):
            if not np.array_equal(res[key], [t[field] for t in totals]):
                raise AssertionError(f"{path}: {key} differ from the "
                                     "in-thread run's worker_totals")

    launches, rows = {}, {}
    for name, algo, plan, _ in runs:
        ref = dist["results"][algo["name"]]
        ranks = [r for r in range(PROC_RANKS)
                 if plan is None or codes[r] == 0]
        res = {r: load_result(os.path.join(dirs[name], "out"), r)
               for r in ranks}
        sts = {r: stats_of(name, r) for r in ranks}
        for r in ranks:
            check_result(name, res[r], ref, f"proc {name} rank {r}")
        c = dict(zip([str(n) for n in res[0]["counter_names"]],
                     res[0]["counter_vals"]))
        summed = {k: sum(sts[r]["launches"][k] for r in ranks)
                  for k in PROC_LAUNCH_KEYS}
        if plan is None:
            thread = dist["launches"][algo["name"]]
            if any(summed[k] != thread[k] for k in PROC_LAUNCH_KEYS):
                raise AssertionError(
                    f"proc {name}: launches summed over the ranks {summed} "
                    f"differ from the in-thread run's {thread}")
            check_dist_counts(summed, f"proc {name}", algo["name"] == "bfs")
            wire = sum(sts[r]["socket_payload_bytes"]
                       + sts[r]["rank_local_wire_bytes"] for r in ranks)
            if wire != c["measured_net_bytes"] or any(
                    sts[r]["recoveries"] for r in ranks):
                raise AssertionError(
                    f"proc {name}: socket + rank-local wire bytes {wire} != "
                    f"measured_net_bytes {c['measured_net_bytes']}, or a "
                    "rank recovered")
            launches[name] = summed
        else:
            st = sts[0]
            if st["recoveries"] < 1 or st["assign"][PROC_KILL[0]] != 0 \
                    or int(res[0]["epoch"]) < 1:
                raise AssertionError(f"proc {name}: no recovery onto rank "
                                     f"0 ({st['assign']}, "
                                     f"{st['recoveries']})")
        replays = sts[0]["replays"]
        if "combine" in replays:
            mode = "add" if algo["name"] == "pagerank" else "min"
            if replays["mode"] != mode:
                raise AssertionError(f"proc {name}: combine mode "
                                     f"{replays['mode']}, expected {mode}")
            rows["combine", mode] = replays["combine"]
        for key in ("decode", "stencil", "add"):
            if key in replays:
                rows[key] = replays[key]
        emit(phase="proc_path", run=name, ranks=PROC_RANKS,
             workers_per_rank=[sts[r]["workers"] for r in ranks],
             fault_plan=plan, iterations=int(res[0]["iterations"]),
             wall_s=[sts[r]["wall_s"] for r in ranks],
             in_thread_cold_s=ref["cold_s"],
             peak_memory=[sts[r]["peak"] for r in ranks],
             ckpt=[sts[r]["ckpt"] for r in ranks],
             wire_frames=[sts[r]["wire_frames"] for r in ranks],
             socket_payload_bytes=[sts[r]["socket_payload_bytes"]
                                   for r in ranks],
             rank_local_wire_bytes=[sts[r]["rank_local_wire_bytes"]
                                    for r in ranks],
             measured_net_bytes=c["measured_net_bytes"],
             recoveries=[sts[r]["recoveries"] for r in ranks],
             recovery_s=[sts[r]["recovery_s"] for r in ranks],
             stall_reports=[sts[r]["stall_reports"] for r in ranks],
             assign=sts[0]["assign"],
             launches_per_rank=[{k: sts[r]["launches"][k]
                                 for k in PROC_LAUNCH_KEYS} for r in ranks],
             launches_in_thread=dist["launches"][algo["name"]],
             wire_round_trip=replays.get("wire_trip"),
             bit_identical_to_in_thread=True)
    for name, _, _, _ in runs:
        for w in range(DIST_WORKERS):
            shutil.rmtree(os.path.join(store.shards[w].root,
                                       f"ckpt-smoke-{name}"),
                          ignore_errors=True)
    return dict(launches=launches, rows=rows)


def kept_pairs(sq, skv, causal, window):
    """(query, key) pairs the mask keeps, counted row by row (positions
    from 0 for both, as the kernel's mask)."""
    total = 0
    for qp in range(sq):
        hi = min(qp, skv - 1) if causal else skv - 1
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def gla_ops_ms(bh, t, chunk, dk, dv, include_current, bonus, sub,
               product_flops=BF16_FLOPS):
    """Time for the operations of a chunked GLA that forms the per-channel
    decays exp(lq_td - lc_sd) only for pairs (t, s) of one ``sub``-step
    sub-chunk and takes every other pair of the chunk as a matrix product.
    ``sub = chunk`` counts the CUDA-core route's chunked form
    (gla_chunk.py:43-67); ``sub = 16`` the sub-chunked form of
    flash-linear-attention, the lesser work at the bf16 rate.  Per
    kept pair in a sub-chunk and channel a difference, an exponential, two
    products and a sum, and per step and channel the exponentials and
    scalings of q * exp(lq) and k * exp(l_last - lc) and the bonus
    diagonal (float32, 67 TFLOP/s); the matrix products (q * exp(lq)) S,
    (k * ...)^T v, q k^T over the pairs across sub-chunks and A v at
    ``product_flops`` (bf16 inputs: 989 TFLOP/s; float32 inputs: 67).  The
    two kinds of unit run side by side, so the time is the larger of the
    two."""
    causal = chunk * (chunk + 1) // 2
    diag = (chunk // sub) * (sub * (sub + 1) // 2 if include_current
                             else sub * (sub - 1) // 2)
    cross = causal - (chunk // sub) * (sub * (sub + 1) // 2)
    n = bh * (t // chunk)
    elementwise = n * (5 * diag * dk + 5 * chunk * dk + dk
                       + (3 * chunk * dk if bonus else 0))
    products = n * (4 * chunk * dk * dv + 2 * cross * dk + 2 * causal * dv)
    return max(elementwise / F32_FLOPS, products / product_flops) * 1e3


def within(out, want, rtol, atol):
    """(|out - want| <= atol + rtol |want| everywhere, max |out - want|)."""
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    return (bool((diff <= atol + rtol * want.abs()).all()),
            float(diff.max()))


def check_close(name, out, want, rtol, atol):
    """Raise unless ``out`` is finite and :func:`within` the tolerance of
    ``want``; the max absolute difference."""
    import torch
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite output")
    ok, err = within(out, want, rtol, atol)
    if not ok:
        raise AssertionError(f"{name}: differs beyond rtol {rtol} / atol "
                             f"{atol} (max |diff| {err})")
    return err


def flex_softcap(q, k, v, s, window, softcap):
    """One PyTorch call for the softcapped calls' function, timed beside
    the kernel and used nowhere in the port: ``torch.compile`` of
    ``flex_attention`` with a tanh ``score_mod`` (on the scaled scores)
    and a causal (and window) ``block_mask``.  Returns a closure over
    [1, H, S, D] views."""
    import torch
    from torch.nn.attention.flex_attention import (
        create_block_mask, flex_attention,
    )

    def cap(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / softcap) * softcap

    def keep(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx
        if window:
            ok = ok & (kv_idx > q_idx - window)
        return ok

    mask = create_block_mask(keep, None, None, s, s, device=q.device)
    flex = torch.compile(flex_attention)
    return lambda: flex(q[None], k[None], v[None], score_mod=cap,
                        block_mask=mask)


def attention_calls(cut):
    """The ``ops.attention`` calls of :func:`run_kernel_ops` at ``cut``:
    (model, label, dtype, positions, window, softcap, rtol, atol)."""
    import torch
    bf = torch.bfloat16
    seq = max(128, GEMMA_SEQ >> cut)
    local = min(GEMMA_WINDOW, seq // 2)
    yi_seq = max(128, YI_SEQ >> cut)
    return (
        ("gemma2-9b", "global, softcap 50", bf, seq, 0, GEMMA_SOFTCAP, 2e-2,
         1e-3),
        ("gemma2-9b", "local window %d, softcap 50" % local, bf, seq, local,
         GEMMA_SOFTCAP, 2e-2, 1e-3),
        ("gemma2-9b", "global, no softcap", bf, seq, 0, 0.0, 2e-2, 1e-3),
        ("gemma2-9b", "global, softcap 50, float32", torch.float32,
         min(1024, seq), 0, GEMMA_SOFTCAP, 1e-5, 1e-5),
        ("gemma2-9b", "local window %d, softcap 50, float32" % local,
         torch.float32, seq, local, GEMMA_SOFTCAP, 1e-5, 1e-5),
        ("yi-6b", "global, no softcap", bf, yi_seq, 0, 0.0, 2e-2, 1e-3),
    )


def _flex_warm_job(cut):
    """Compiles :func:`flex_softcap` for each softcapped call of
    :func:`attention_calls` on inputs of its shapes, in a spawned process
    while the parent builds the graph on the host: ``torch.compile`` keeps
    what it built in the Inductor and Triton caches (under the kernels'
    build directory), where ``run_kernel_ops``' own compile of the same
    calls finds it."""
    import torch
    for model, _, dtype, s, window, softcap, _, _ in attention_calls(cut):
        if not softcap:
            continue
        heads, kv_heads, d = ATTN_MODELS[model]
        q = torch.randn((heads, s, d), device=DEVICE).to(dtype)
        k, v = (torch.randn((kv_heads, s, d), device=DEVICE).to(dtype)
                .repeat_interleave(heads // kv_heads, dim=0)
                for _ in range(2))
        flex_softcap(q, k, v, s, window, softcap)()
        torch.cuda.synchronize()


def start_flex_warm(cut):
    """:func:`_flex_warm_job` in a spawned process; joined by
    :func:`run_kernel_ops` before its own compiles."""
    import multiprocessing
    proc = multiprocessing.get_context("spawn").Process(
        target=_flex_warm_job, args=(cut,), daemon=True)
    proc.start()
    return proc


def launched(counter_owner, fn):
    """(fn(), launches): ``counter_owner.launches`` set to 0 just before
    ``fn`` and read just after; raises unless it grew."""
    import torch
    counter_owner.launches = 0
    out = fn()
    torch.cuda.synchronize()
    n_launch = counter_owner.launches
    if n_launch < 1:
        raise AssertionError(f"kernel_ops: {counter_owner.__name__} was "
                             "never launched")
    return out, n_launch


def run_kernel_ops(scale, flex_warm=None):
    """Phase 10 of :func:`main`: ``ops.spmv``, ``ops.attention`` and
    ``ops.gla`` at full width, each call with its kernel's launch count set
    to 0 just before and read just after (it must have grown), held against
    its plain version (and spmv against the float64 edge oracle), and timed
    beside its bound and a PyTorch library call where one computes the
    same function.  ``scale`` below 21 shrinks the graph, the sequences and
    the GLA batch for a rehearsal.  ``flex_warm`` (the process of
    :func:`start_flex_warm`) is joined before the first library compile.
    Returns the kernel table's rows."""
    import numpy as np
    import torch
    from repro_torch.data.graphs import uniform_graph
    from repro_torch.kernels import csr_spmv, flash_attention
    from repro_torch.kernels import ops, ref
    dev = torch.device(DEVICE)
    cut = max(0, 21 - scale)
    rows = []

    # -- 10a. block_csr_spmv: uniform graph, the main graph's size --------
    t0 = time.perf_counter()
    n, n_edges, t = 2 ** scale, 2 ** (scale + 4), SPMV_TILE
    g = uniform_graph(n, n_edges, seed=0, weighted=True)
    blocks = ops.build_block_csr(g.src, g.dst, g.data, n, t)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_blocks = {}
    for key in list(blocks):           # each host array freed once on the card
        val = blocks.pop(key)
        dev_blocks[key] = (torch.from_numpy(val).to(dev)
                           if isinstance(val, np.ndarray) else val)
        del val
    gc.collect()
    copy_s = time.perf_counter() - t0
    x = torch.from_numpy(np.random.default_rng(1).random(
        dev_blocks["n_cols"] * t, dtype=np.float32)).to(dev)
    args = (dev_blocks["tiles"], dev_blocks["tile_col"],
            dev_blocks["row_ptr"], x)
    # the first call packs the structure (kept in the dict), then launches
    packs = csr_spmv.pack_block_csr.calls
    t0 = time.perf_counter()
    y, n_launch = launched(csr_spmv.block_csr_spmv,
                           lambda: ops.spmv(dev_blocks, x, tile=t))
    first_call_s = time.perf_counter() - t0
    packed = dev_blocks[ops.PACKED_KEY]
    if csr_spmv.pack_block_csr.calls != packs + 1:
        raise AssertionError("ops.spmv did not pack its structure once")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = csr_spmv.pack_block_csr(*args[:3], tile=t)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    for key in csr_spmv.PACKED_ARRAYS:
        if not torch.equal(again[key], packed[key]):
            raise AssertionError(f"pack_block_csr: {key} differs between "
                                 "two packs of one structure")
    del again
    y_packed_plain = csr_spmv.block_csr_spmv_packed_ref(packed, x)
    err = check_close("spmv vs the packed plain version", y, y_packed_plain,
                      1e-5, 1e-5)
    y_plain = csr_spmv.block_csr_spmv_ref(*args, tile=t)
    err_dense = check_close("spmv vs the dense plain version", y, y_plain,
                            1e-5, 1e-5)
    y_edges = torch.from_numpy(ref.ref_spmv_from_edges(
        g.src, g.dst, g.data, x.cpu().numpy(), n)).to(dev)
    err_edges = check_close("spmv vs the float64 edge oracle", y[:n],
                            y_edges, 1e-5, 1e-5)
    check_close("spmv dense plain vs the edge oracle", y_plain[:n], y_edges,
                1e-5, 1e-5)
    check_close("spmv packed plain vs the edge oracle", y_packed_plain[:n],
                y_edges, 1e-5, 1e-5)
    del y_plain, y_packed_plain
    launches_before = csr_spmv.block_csr_spmv.launches
    ms = cuda_ms(lambda: ops.spmv(dev_blocks, x, tile=t), 10)
    if (csr_spmv.pack_block_csr.calls != packs + 2
            or csr_spmv.block_csr_spmv.launches != launches_before + 11):
        raise AssertionError("ops.spmv packed again or skipped its kernel")
    plain_ms = cuda_ms(
        lambda: csr_spmv.block_csr_spmv_packed_ref(packed, x), 2)
    dense_plain_ms = cuda_ms(
        lambda: csr_spmv.block_csr_spmv_ref(*args, tile=t), 2)
    src_d, dst_d = (torch.from_numpy(a).to(dev) for a in (g.src, g.dst))
    live = int(torch.unique(dst_d // t * dev_blocks["n_cols"]
                            + src_d // t).numel())
    n_live, nnz = packed["pcol"].numel(), packed["pval"].numel()
    if live != n_live:
        raise AssertionError(f"pack_block_csr kept {n_live} live tiles; the "
                             f"edges occupy {live}")
    csr = torch.sparse_coo_tensor(
        torch.stack([dst_d, src_d]), torch.from_numpy(g.data).to(dev),
        (n, n), check_invariants=False).coalesce().to_sparse_csr()
    del src_d, dst_d
    library = lambda: torch.sparse.mm(csr, x[:, None])
    lib_err = check_close("torch.sparse.mm vs the edge oracle",
                          library()[:, 0], y_edges, 1e-5, 1e-5)
    library_ms = cuda_ms(library, 10)
    n_rows, n_slots = dev_blocks["n_rows"], dev_blocks["tile_col"].numel()
    out_b = n_rows * t * 4
    bytes_ = (sum(packed[k].numel() * packed[k].element_size()
                  for k in csr_spmv.PACKED_ARRAYS)
              + x.numel() * 4 + out_b)
    bound_ms, bound_by = bound(bytes_, 2 * nnz / F32_FLOPS * 1e3)
    dense_b = sum(a.numel() * a.element_size() for a in args) + out_b
    dense_bound_ms, _ = bound(dense_b, 2 * n_slots * t * t / F32_FLOPS * 1e3)
    emit(phase="kernel_ops", call="ops.spmv", graph=dict(
        generator="uniform_graph", vertices=n, edges=n_edges, seed=0,
        weighted=True), tile=t, row_blocks=n_rows, padded_slots=n_slots,
        live_tiles=n_live, occupied_cells=nnz,
        max_tiles_per_row=dev_blocks["max_tiles_per_row"],
        host_build_s=build_s, copy_to_card_s=copy_s, pack_s=pack_s,
        first_call_s=first_call_s, launches=n_launch,
        max_abs_err=err, max_abs_err_vs_dense_plain=err_dense,
        max_abs_err_vs_edges=err_edges,
        library_max_abs_err_vs_edges=lib_err, kernel_ms=ms,
        plain_ms=plain_ms, dense_plain_ms=dense_plain_ms,
        library_ms=library_ms,
        library="torch.sparse.mm (coalesced f32 CSR of the edges)",
        bytes=bytes_, bound_ms=bound_ms, bound_by=bound_by,
        dense_bytes=dense_b, dense_bound_ms=dense_bound_ms,
        gb_per_s=bytes_ / ms / 1e6)
    rows.append(kernel_row(
        "block_csr_spmv ops.spmv uniform 2^%d T=%d" % (scale, t),
        "block_csr_spmv.cu", TPU_SPMV, n_launch, dict(
            max_abs_err=max(err, err_dense), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)))
    del g, blocks, dev_blocks, packed, args, x, y, y_edges, csr, library
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10b. flash_attention at Gemma2-9B and Yi-6B widths ----------------
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    if flex_warm is not None:
        t0 = time.perf_counter()
        flex_warm.join()
        if flex_warm.exitcode != 0:
            raise AssertionError("the flex_attention warm-up failed (exit "
                                 f"{flex_warm.exitcode})")
        emit(phase="kernel_ops", call="flex_warm_join",
             wait_s=time.perf_counter() - t0)

    def attention_inputs(model, s, dtype):
        heads, kv_heads, d = ATTN_MODELS[model]
        qk_scale = math.sqrt(SCORE_VAR)
        q = (qk_scale * torch.randn((heads, s, d), generator=gen,
                                    device=dev)).to(dtype)
        # each KV head serves heads / kv_heads query heads (the kernel has
        # no GQA)
        k, v = (scale * torch.randn((kv_heads, s, d), generator=gen,
                                    device=dev)
                for scale in (qk_scale, 1.0))
        return (q,) + tuple(a.to(dtype).repeat_interleave(
            heads // kv_heads, dim=0) for a in (k, v))

    for model, label, dtype, s, window, softcap, rtol, atol in \
            attention_calls(cut):
        heads, kv_heads, head_dim = ATTN_MODELS[model]
        q, k, v = attention_inputs(model, s, dtype)
        kw = dict(causal=True, window=window, softcap=softcap)
        o, n_launch = launched(flash_attention.flash_attention,
                               lambda: ops.attention(q, k, v, **kw))
        plain = lambda **over: flash_attention.flash_attention_ref(
            q, k, v, **dict(kw, **over))
        want = plain()
        err = check_close(f"attention {model} {label}", o, want, rtol, atol)
        # the check must tell each masking feature apart at these inputs:
        # the plain version without it falls outside the tolerance
        without = dict(causal=dict(causal=False))
        if window:
            without["window"] = dict(window=0)
        if softcap:
            without["softcap"] = dict(softcap=0.0)
        feature_diff = {}
        for feature, over in without.items():
            ok, feature_diff[feature] = within(plain(**over), want, rtol,
                                               atol)
            if ok:
                raise AssertionError(f"attention {model} {label}: the check "
                                     f"cannot see the {feature} at these "
                                     "inputs")
        bf16 = dtype == bf
        ms = cuda_ms(lambda: ops.attention(q, k, v, **kw), 5 if bf16 else 3)
        plain_ms = cuda_ms(plain, 2)
        compile_s = None
        if not softcap:
            library = ("torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True)")
            lib_call = lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True)
        else:
            library = (f"torch.compile(flex_attention), score_mod tanh(s / "
                       f"{softcap:g}) * {softcap:g}, causal"
                       + (f" & window {window}" if window else "")
                       + " block_mask")
            t0 = time.perf_counter()
            lib_call = flex_softcap(q, k, v, s, window, softcap)
            lib_call()
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
        # reported, not checked: in bf16 both library calls round P to bf16
        lib_err = float((lib_call()[0].float() - o.float()).abs().max())
        library_ms = cuda_ms(lib_call, 5 if bf16 else 2)
        pairs = kept_pairs(s, s, True, window)
        flops = 4 * pairs * head_dim * heads
        bytes_ = 4 * q.numel() * q.element_size()
        bound_ms, bound_by = bound(
            bytes_, flops / (BF16_FLOPS if bf16 else F32_FLOPS) * 1e3)
        emit(phase="kernel_ops", call="ops.attention", model=model,
             label=label, route=flash_attention.route(dtype, head_dim),
             heads=heads, kv_heads=kv_heads, head_dim=head_dim, seq=s,
             dtype=str(dtype), score_var=SCORE_VAR, **kw,
             launches=n_launch, max_abs_err=err, rtol=rtol, atol=atol,
             out_mean_abs=float(want.float().abs().mean()),
             max_abs_diff_without=feature_diff, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, library=library,
             library_compile_s=compile_s, library_max_abs_diff=lib_err,
             kept_pairs_per_head=pairs, flops=flops, bytes=bytes_,
             bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9)
        rows.append(kernel_row(
            f"flash_attention[{flash_attention.route(dtype, head_dim)}] "
            f"ops.attention {model} {label} S={s}",
            "flash_attention.cu", TPU_FLASH, n_launch, dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)))
        del q, k, v, o, want, plain, lib_call
        gc.collect()
        torch.cuda.empty_cache()

    # -- 10c. gla_chunked at RWKV6-1.6B and Zamba2-1.2B (Mamba2) widths ----
    rows.extend(run_gla(cut, dev))
    return rows


def run_gla(cut, dev):
    """The ``ops.gla`` calls of :func:`run_kernel_ops`: bf16 at RWKV6-1.6B
    and Zamba2-1.2B (Mamba2) widths (the tensor-core route), and float32 at
    RWKV6-1.6B widths (the CUDA-core route), each with its launch count set
    to 0 just before it, its route checked, held against the plain
    version, and timed.  Returns the kernel table's rows."""
    import torch
    from repro_torch.kernels import gla_chunk, ops
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    batch = max(1, GLA_BATCH >> cut)
    steps = max(GLA_CHUNK, GLA_STEPS >> cut)
    calls = (   # model, input dtype, the route it must take, y tolerance
        ("rwkv6_1_6b", bf, "tensor_core", 2e-2),
        ("zamba2_1_2b_mamba2", bf, "tensor_core", 2e-2),
        ("rwkv6_1_6b", torch.float32, "cuda_core", 1e-4),
    )
    for model, dtype, want_route, ytol in calls:
        heads, dk, dv, include_current, bonus = GLA_MODELS[model]
        bh = batch * heads
        rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        q, k = (rand(bh, steps, dk).to(dtype) for _ in range(2))
        v = rand(bh, steps, dv)
        if include_current:
            # Mamba2 (models/mamba2.py:95-107): w = -exp(A_log) * dt, one
            # value per head and step, broadcast over the state dim, and
            # v = x * dt; A in [1, 16], dt = softplus(N(0, 1) + dt_bias),
            # dt_bias the inverse softplus of a log-uniform dt in
            # [1e-3, 1e-1]
            a = 1 + 15 * torch.rand((heads,), generator=gen, device=dev)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt0 = torch.exp(lo + (hi - lo) * torch.rand(
                (heads,), generator=gen, device=dev))
            dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
            dt = torch.nn.functional.softplus(
                rand(batch, heads, steps) + dt_bias[None, :, None])
            w = (-a[None, :, None] * dt).reshape(bh, steps, 1).expand(
                -1, -1, dk).contiguous()
            v = v * dt.reshape(bh, steps, 1)
            u = None
        else:
            # RWKV6 (models/rwkv6.py:116-120): w = -exp(.), per channel
            w = -torch.exp(rand(bh, steps, dk))
            u = 0.3 * rand(bh, dk) if bonus else None
        v = v.to(dtype)
        gla_route = gla_chunk.route(dtype, GLA_CHUNK)
        if gla_route != want_route:
            raise AssertionError(f"gla {model} {dtype}: takes the "
                                 f"{gla_route} route, not {want_route}")
        kw = dict(chunk=GLA_CHUNK, include_current=include_current)
        (y, state), n_launch = launched(
            gla_chunk.gla_chunked, lambda: ops.gla(q, k, v, w, u, **kw))
        plain = lambda: gla_chunk.gla_chunked_ref(q, k, v, w, u, **kw)
        yp, sp = plain()
        label = f"{model} {str(dtype).removeprefix('torch.')}"
        err_y = check_close(f"gla {label} y", y, yp, ytol, ytol)
        err_s = check_close(f"gla {label} state", state, sp, 1e-4, 1e-4)
        del yp, sp
        ms = cuda_ms(lambda: ops.gla(q, k, v, w, u, **kw), 5)
        plain_ms = cuda_ms(plain, 1)
        bytes_ = (sum(a.numel() * a.element_size() for a in (q, k, v, w))
                  + (0 if u is None else u.numel() * 4)
                  + y.numel() * y.element_size() + state.numel() * 4)
        product_flops = BF16_FLOPS if dtype == bf else F32_FLOPS
        chunked_ms, sub_ms = (gla_ops_ms(
            bh, steps, GLA_CHUNK, dk, dv, include_current, bonus, sub,
            product_flops) for sub in (GLA_CHUNK, GLA_SUB))
        # at the float32 rate the chunked form is the lesser work
        least_ms = min(chunked_ms, sub_ms)
        bound_ms, bound_by = bound(bytes_, least_ms)
        emit(phase="kernel_ops", call="ops.gla", model=model, batch=batch,
             dtype=str(dtype), route=gla_route, heads=heads, steps=steps,
             dk=dk, dv=dv, **kw, bonus=u is not None, launches=n_launch,
             max_abs_err=err_y, y_max_abs=float(y.float().abs().max()),
             y_tolerance=ytol, state_max_abs_err=err_s,
             state_tolerance=1e-4, kernel_ms=ms, plain_ms=plain_ms,
             library_ms=None, library="none: no single PyTorch call "
             "computes gated linear attention", bytes=bytes_,
             bound_ms=bound_ms, bound_by=bound_by,
             bytes_bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
             least_ops_ms=least_ms, chunked_form_ops_ms=chunked_ms,
             subchunked_form_ops_ms=sub_ms)
        rows.append(kernel_row(
            f"gla_chunked[{gla_route}] ops.gla {label} B={batch} "
            f"T={steps}", "gla_chunk.cu", TPU_GLA, n_launch, dict(
                max_abs_err=max(err_y, err_s), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)))
        del q, k, v, w, u, y, state, plain
        gc.collect()
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
