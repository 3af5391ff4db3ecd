#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``flink_ml_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

Phases, each of which fails the run (no result line, nonzero exit):

1. build the port's CUDA kernels from ``flink_ml_tpu_torch/csrc/`` with nvcc
   (one process per source, all at once) and print the card's name and
   power limit;
2. hold every KMeans kernel against its plain PyTorch version on the card,
   at the main-path shape (1,000,000 x 100, k = 10), a ragged n, n = 0,
   zero-weight rows, a wide k that makes the kernels stage centroids in
   chunks, and an odd width; reruns must be bit-identical; time kernel,
   plain version and a one-call PyTorch yardstick, and Lloyd's first stage
   alone, eagerly and as device time (``stage1_device_ms`` of its row in
   the kernels line); then hold
   ``reduce_partials`` bit for bit against its plain version at four
   partials shapes (Lloyd's, made by its path's first stage, and, from
   seeded tensors, SGD's (blocks, 102) and the (1024, 100, 2) and (25,
   131072, 1) shapes the segment sums gave it, the shapes of the second
   stages that SGD and the segment sums since took into their own C
   entries) and time it and
   ``torch.sum`` there, eagerly (what a fit's loop pays, host enqueue
   included) and as device times (calls captured in a CUDA graph and
   replayed: the host takes longer to enqueue one call than the card to run
   it);
3. the same for the SGD kernel, for each loss: the main-path window (the
   first 100,000 rows of a 10,000,000 x 100 table), a window in the middle,
   the clipped window at the end, a ragged window, a one-row window,
   zero-weight rows, an odd width, rows so wide that the kernel stages
   them in column chunks (d = 1,500, and an odd d = 6,001), and margins
   that overflow exp for the logistic loss, printing each case's launch
   plan (register or chunked instance, grid); the C entry's output must
   equal ``reduce_partials_plain`` of the partials the same call wrote, bit
   for bit; time the whole call and its first stage alone, eagerly and as
   device times (``device_ms``, ``stage1_device_ms`` and
   ``library_device_ms`` of its row in the kernels line); the timed calls
   move their window on by lb each call, so none finds its rows in L2;
4. drive the KMeans main path as a user would: the benchmark runner on
   ``flink_ml_tpu/benchmark/configs/kmeans-benchmark.json`` (KMeans fit at
   full size), then transform of the same table, save, load and transform
   again; hold the fit against a plain PyTorch fit on the card and a small
   fit against the CPU;
5. drive the linear-model main path: the runner on
   ``logisticregression-benchmark.json`` at full size (10,000,000 x 100,
   20 rounds of 100,000 rows), one run each of ``linearsvc-benchmark.json``
   and ``linearregression-benchmark.json``, then LR transform of the same
   table, save, load and transform again; hold the LR fit against a plain
   PyTorch fit on the card, and small fits of all three models against the
   CPU;
6. hold the KNN kernels against their plain version on the card, printing
   each case's launch plan and the tiled kernel's blocks per SM: a ragged
   n, a ragged n_train, k > n_train, k = 1, duplicate train rows, n = 0, an
   odd d, d = 64, d = 128 with k = 32, d = 256 and an odd d = 769 (x
   streamed in chunks), and the wide instance (k > 32): k = 50 and k = 300,
   k > n_train and duplicate train rows; then the train split: 1,000 and
   16,384 rows against 50,000 train rows (the 16,384 block also forced to 2
   and 3 splits), duplicate train rows on both sides of a split boundary,
   and k larger than a split's rows; reruns must be bit-identical, and a
   split run identical to the same rows in one split; time kernel, plain
   version and the library's ``torch.topk(torch.addmm(...))`` on a 16,384
   x 50,000 x 32 block, the wide instance on the same block (k = 33), and
   the kernel a few times at the main path's 10,000,000 rows;
7. the same for the segment-sum kernels: 1-D and 2-D values, -1 and
   out-of-range ids, n = 0, a ragged n, one chunk, hashed 2^18 domains
   (c = 1 and c = 2), a domain of more than 65,535 segment tiles, values of
   5,000 columns (column groups), and the sparse FTRL path's shapes: the
   per-row dots as the path packs them (1,000,000 ascending row ids, ten
   a row, then 48,576 padding slots with id 0 and value 0), the same over
   sorted random row ids without padding, and the per-coordinate gradient
   and weight sums; timed eagerly and as device times (a replayed CUDA
   graph) against ``index_add_`` at the gradient shape (n = 1,048,576, c =
   2, u = 100) and at both dots layouts (u = 131,072), with their byte
   bounds, and as device times on the hashed domains;
8. drive the KNN main path: the runner on ``knn-benchmark.json`` at full
   size (10,000,000 x 32 against 50,000 train rows, k = 10), then transform
   of the same table, save, load and transform again; hold 113,333 of its
   predictions (first, middle and ragged last rows) against the plain
   version's neighbours, and small models on the card against the CPU (one
   of them 300 wide with k = 40, through the wide instance);
9. drive the FTRL main path: the runner on
   ``onlinelogisticregression-benchmark.json`` at full size (10,000,000 x
   100, 100 dense batches), then a sparse stream of the same widths and
   params (2,000,000 rows, 10 stored values each, 20 batches) through the
   device CSR engine; hold the sparse fit against a rerun (identical bits)
   and the float64 host engine, a sparse fit over a hashed 2^18 domain
   against the host engine, the dense engine on hyperplane labels over
   the full table against the CPU, transform, save and load, and small
   dense fits on the card against the CPU;
10. drive the iteration runtime's modes on the LR and KMeans configs at
    full size (phases 5 and 4's tables): K-round segments between
    checkpoints (K = 5 for LR, 3 for KMeans; a timed CheckpointManager in a
    temporary directory), host rounds with a listener that records the
    epochs, and a supervised fit (``set_retry_policy(RetryPolicy(
    backoff_s=0))``) under ``faults.chaos(at={"epoch-boundary": [2]})``,
    which fails at its second boundary and resumes from the first one's
    checkpoint; each fit must equal the all-device fit of the same table
    bit for bit (KMeans transform too), each segment boundary must cost one
    ``read_boundary`` fetch, and the chaos run one restart; print each
    mode's fit ms beside the all-device fit's, the boundaries and fetches,
    the checkpoint save and restore ms and bytes, and, on one more segment
    fit, the host-clock split of its boundaries (fetch, save with its
    fsyncs, npz write and gc, restore, clear, the rest); then phase 9's
    sparse FTRL stream with a checkpoint every 5 batches, clean and with a
    fault at its third save resumed from the second on the rest of the
    stream, both equal to the stream without checkpoints bit for bit
    (coefficients, version, history) and launching the segment kernel;
11. drive the data-parallel layer (``flink_ml_tpu_torch/parallel/``) at
    full size: the LR config (10,000,000 x 100, global batch 100,000, 20
    rounds) with no mesh, on one shard (bit for bit the fit with no mesh,
    20 launches) and on eight virtual shards of the card with the
    replicated and the sharded update (each 8 x 20 ``sgd_batch_terms``
    launches, 12,500 rows a shard; sharded against replicated rtol 1e-5;
    the eight-shard fit against its plain rounds); the eight-shard fit in
    segments of K = 5 with a fault at the second boundary, resumed by the
    supervisor, bit for bit the all-device fit (replicated sgd, and
    sharded adam, whose moments are sharded checkpoint leaves); the same
    fit through torch.distributed (NCCL at world size 1), bit for bit the
    one-shard fit; the KMeans config on one and eight shards (8 x 10 Lloyd
    launches; eight against one shard within the main path's KMeans
    tolerance, below); phase 9's dense FTRL table on hyperplane labels and
    its sparse stream on one and eight shards (the segment kernel on every
    shard; eight against one within BIG_FIT_RTOL/ATOL); and a 4,003 x 20 LR
    table with a global batch of 801 (uneven local batches, a padded last
    shard) on eight shards, on the card against the CPU; print each fit's
    ms on one shard against eight, and the launches;
12. observability on the card (``flink_ml_tpu_torch/observability/``): the
    LR and KMeans configs at full size (phase 10's tables) in segment fits
    (K = 5 and 3), supervised, with a fault at the second boundary, with
    tracing and health armed (``FLINK_ML_TPU_TRACE_DIR`` and
    ``FLINK_ML_TPU_HEALTH=1``): the trace must nest fit → segment →
    ``checkpoint.save``, hold one resumed ``checkpoint.restore`` and one
    ``supervisor.restart``, count ``boundaryFetches`` equal to
    ``boundaries`` and 20 and 10 ``rounds``, and record a finite health
    series over every round of the resumed attempt (the ``epochs`` gauge at
    20 and 10); each model must equal the same fit unarmed bit for bit.
    Then one profiled LR fit, one profiled KMeans fit and one profiled
    KMeans transform (``FLINK_ML_TPU_PROFILE_CAPTURE=1``, each into its own
    trace dir): each ``profile.json`` must read ``source: "device"``, with
    device rows for ``sgd_batch_terms``, ``lloyd_partial_sums``,
    ``reduce_partials`` and ``assign_nearest``, and every roofline share
    of the efficiency report at most 100%. Prints the profiled device ms
    per launch, the shares, the kernel builds phase 1 recorded, and the
    armed and unarmed fit ms (host clock, best of two);
13. the serving path (``flink_ml_tpu_torch/servable/``, ``serving/``,
    ``observability/server.py``) at the FTRL config's width of 100
    features: an LR fit on the card of a seeded 1,000,000 x 100 table with
    hyperplane labels (the LR config's params; drift and quality capture
    armed; it must launch ``sgd_batch_terms``) is published as v1 with
    both baselines; the registry's loader builds the device-predict
    servable; a micro-batcher (buckets 8, 32, 128; window 1 ms) is warmed
    on its device thread, ``/healthz`` must say ok and ``/serving`` show
    ``lr@v1``; six 1-row requests time the first ticks after warmup, on
    this batcher and on a second one warmed on the caller's thread; then a
    closed loop of 400 requests of 1, 2 and 4 rows from 64 callers, with
    labeled feedback, during which an FTRL fit of the same table is
    published as v2 and hot-swapped in by the watcher; then the same mix
    with one ``transform`` per request. Gates: every response's dots
    within SERVE_RTOL/SERVE_ATOL of the host float64 predict of the version
    that served it and its predictions exact except rows with |dot| <
    SERVE_ATOL (counted), no error or rejection, the registry at v2 with
    responses from both versions, no kernel build after warmup, no
    swallowed telemetry fault, and a finite drift PSI and live AUC per
    version. Prints both runs' throughput and p50/p90/p99, the first and
    steady ticks, the warmup report, batch fill and padding waste;
14. the ops loop (``observability/{slo,flightrecorder,fleet}.py``,
    ``serving/controller.py``) at the FTRL config's width, with a trace
    dir, a fleet dir (beacons every 0.2 s), drift and quality capture and
    an incident bundle for every trigger (50 ms profile each) armed: v1,
    an LR fit on the card of OPS_V1_ROWS seeded rows with labels from a
    hyperplane whose weights sum to 0 (balanced under any mean shift),
    is published with both baselines and served by a registry of
    device-predict servables through a micro-batcher warmed on its device
    thread. Traffic drives of OPS_DRIVE_ROWS rows in requests of
    OPS_REQUEST_ROWS rows from OPS_CALLERS callers, with
    labeled feedback, feed a buffer of the last two drives; the
    controller's retrain is an FTRL ``warm_start`` refit of four passes
    over that buffer packed as a CSR column (64-row batches of 6,400
    stored values: ``cuda-csr-batches``, ``segment_reduce_sum``) that
    returns the leaves and both fresh baselines. Twice at one seed,
    under ``faults.chaos`` at the five ``CONTROLLER_SITES`` (rate 0.2),
    stepped by ``step()``: traffic shifted by +OPS_SHIFT triggers on
    drift and the cycle ramps the canary (0.25, 0.5, 1.0), bakes and
    swaps in v2, whose drift then reads clean; a rigged refit (finite,
    one class on shifted traffic) is promoted straight after its probe,
    the bake regresses and the registry rolls back to v2 without a
    re-probe, recording a ``rollback`` incident; an honest cycle swaps
    v4 in. After the second run a fourth cycle runs on the controller's
    own thread (``start()``), which names the card, retrains on it and
    swaps, while ``/slo``, ``/incidents``, ``/fleet`` and ``/controller``
    answer 200 and the fleet CLI's ``--check`` reads 0 with the serving
    and controller roles alive. Gates: identical transitions and
    outcomes in both runs, every retrain on ``cuda-csr-batches`` with
    segment launches and the serving version's coefficients untouched,
    no error or rejection, every response within SERVE_RTOL/SERVE_ATOL of
    the host float64 predict of the version that served it (predictions
    exact but for |dot| < SERVE_ATOL), no kernel build after warmup, an
    impossible latency SLO leaving an ``slo`` bundle, and the port's
    CLIs: controller ``--check`` 0, incident ``--check`` 4, then 0 after
    ``--ack``. Prints each cycle's outcome, wall ms and publish-to-swap
    ms, each retrain's ms and segment launches, batched requests/s and
    p99 during the ramp, and the incident and beacon counts;
15. Pipeline, Graph and the dense feature transformers
    (``flink_ml_tpu_torch/api/{pipeline,graph}.py``, ``models/feature/``,
    ``ops/{columnar,quantile,stats}.py``, ``models/classification/
    naivebayes.py``), every stage call inside a guard that fails any Table
    read taking a tensor column to the host: (a) the README's pipeline,
    ``Pipeline([StandardScaler(withMean, withStd), LogisticRegression])``
    on the LR config's 10,000,000 x 100 table with the config's params:
    fit (exactly 20 ``sgd_batch_terms`` launches, the scaled column handed
    to the LR stage as a float32 tensor on the card), save, load and
    transform (the reloaded model predicts the same, bit for bit); the
    scaler's statistics within STAT_RTOL of float64 statistics over a host
    copy of the rows, and the LR coefficients within COEFF_RTOL/ATOL of
    LogisticRegression alone on the pre-scaled column; (b)
    ``Pipeline([MinMaxScaler, KMeans])`` on the KMeans config's table:
    Lloyd, reduce and assignment launches, labels equal to KMeans alone
    on the pre-scaled column but for ties (TIE_RTOL); (c)
    ``examples/graph_example.py``'s DAG (StandardScaler → LR) on
    GRAPH_ROWS seeded rows: fit, save, load, transform, with (a)'s
    equalities; (d) the sixteen FEATURE_CONFIGS through the runner, uncut
    (one warmup, one timed run), then the stage once more on the same
    generated table, its output's first FEATURE_ROWS rows held against
    the port on the CPU on a host copy of those rows (continuous outputs
    within FEATURE_RTOL/ATOL given the card's statistics, through
    ``convert.py``; bucket ids, binarized values and selected columns
    exactly, but for values within EDGE_ATOL of a split or threshold;
    NaiveBayes's predictions exactly, its model against a CPU fit of a
    host copy of all rows), and the statistics against float64 ones over
    all rows (plain PyTorch float64 on the card; ``kthvalue`` for
    RobustScaler; the selector's ANOVA p-values by float64 sums and
    scipy) within STAT_RTOL. Prints each part's host ms (synchronized),
    each runner row's totalTimeMs, executeTimeMs, achievedGBps and
    deviceName, and the phase's launches (those of ``PATH_KERNELS[
    "pipeline"]``, each at least once; the runner rows launch none);
16. the text, discrete and misc feature transformers
    (``flink_ml_tpu_torch/models/feature/{text,discrete,misc}.py``) with
    the host pool (``common/hostpool.py``) and the native host kernels
    (``native/``, built with g++): (a) ``examples/sparse_text_pipeline_
    example.py``'s chain as written (3,000 docs, HashingTF at 2^18, FTRL
    with a batch of 500: its ~2,900 stored values a batch take the host
    engine), then with the device engine's floor under the batches' size
    (``cuda-csr-batches``, segment launches); each above 0.9 accurate;
    (b) the ``hashingtf`` config's table as shipped (10,000,000 rows of
    10 tokens, seed 2) through HashingTF (2^18, one CSR column), IDF fit
    and transform and FTRL in TEXT_BATCH batches on ``cuda-csr``, labels
    the sign of a seeded ±1 sum of each row's tokens: the hashed column
    never densified, a rerun identical, the first TEXT_PREFIX_BATCHES
    batches within CSR_RTOL/CSR_ATOL of the float64 host engine, accuracy
    above TEXT_ACCURACY (a CPU run of the same stream at full size read
    1.0); prints each stage's host ms (synchronized), the packing alone
    and the launches; (c) the fourteen TEXT_CONFIGS through the runner,
    uncut (one warmup, one timed run; rows name the card), then the stage
    once more on a generated table: card stages (CountVectorizer's dense
    counts, also timed alone on ids already on the card against their
    byte bound; IDF; KBinsDiscretizer; VectorIndexer; Imputer;
    SQLTransformer; FeatureHasher's hashing) held on the first
    FEATURE_ROWS rows against the port's host path on a host copy of those
    rows, host stages against the row-at-a-time path (ragged object
    columns): tokens, indices and counts exactly, IDF and Imputer within
    FEATURE_RTOL/ATOL; (d) after CUDA is up: ``native.factorize_i64`` on
    HOST_KEYS seeded keys against a numpy first-appearance factorization,
    ``csv_parse_numeric`` and ``Table.from_csv`` against Python's ``csv``,
    a forked ``map_row_shards`` over the CountVectorizer config's first
    HOST_POOL_ROWS rows against the serial one, and a ``hostpool-hang``
    chaos run ending in ``WorkerTimeout`` with every child reaped; then
    ``benchmark-demo.json`` through ``run_benchmarks`` (its two broken
    rows reported as DEMO_FAILURES); the launches are those of
    ``PATH_KERNELS["text"]``;
17. the online estimators, the CSR-fed linear models and the host
    algorithms, each path with the counts at 0: (a) OnlineKMeans over the
    KMeans config's table (1,000,000 x 100, k = 10) in 100 batches of
    STREAM_BATCH rows, decay STREAM_DECAY, from KMeansModelDataGenerator's
    model: one ``lloyd_partial_sums`` and one ``reduce_partials`` launch a
    batch and no assignment; a rerun bit-identical; the first batch's
    partials against the plain version (TIE_RTOL); every batch's update,
    from a recording rerun's states, against the plain update and the JAX
    package's float64 update (its ``models/online.py`` :1043-1060) from
    the same state, rows assigned otherwise being ties (TIE_RTOL), within
    STEP_ATOL, or CENTROID_ATOL for a batch with tie rows; the whole-fit
    differences over the first STREAM_REPLAY_BATCHES batches against the
    same stream on the CPU and a float64 numpy replay are reported, not
    held: independent runs on these structureless rows part at their first
    tie flip and then drift apart; (b) OnlineStandardScaler over the LR
    config's table (10,000,000 x 100) in count windows of SCALER_WINDOW
    rows (100 models), again with SCALER_OFFSET added to every feature
    (the cancellation case), and in event-time tumbling windows on a
    seeded timestamp column: means and stds against float64 two-pass
    moments; launches ``PATH_KERNELS["online"]``; (c) the hashingtf
    config's table (phase 16's hashed column and labels) through
    LogisticRegression with the LR config's paramMap on ``cuda-csr``:
    exactly two ``segment_reduce_sum`` launches a round, the column never
    densified, a rerun identical, the coefficients within BIG_FIT_RTOL/ATOL
    of the CPU fit, accuracy at least SPARSE_ACCURACY, the transform on the
    CSR column; LinearSVC on the same table; a host-rounds fit with a
    checkpoint every SPARSE_CKPT_INTERVAL rounds interrupted at round
    SPARSE_CRASH_ROUND and resumed, equal to the uninterrupted fit;
    launches ``PATH_KERNELS["sparse_linear"]``; (d)
    ``agglomerativeclustering-benchmark.json`` through ``run_benchmarks``,
    uncut, its row naming the card; (e) Swing on a seeded purchase log of
    SWING_USERS x SWING_PER_USER purchases: the native scorer equal to the
    Python oracle on the first SWING_PREFIX_USERS users' groupings, and
    timed on the whole log; (d) and (e) launch no kernel;
18. mesh telemetry, mesh-sharded serving and the trace CLI
    (``observability/{meshstats,shards,path,lockstats,diff,cli}.py``,
    ``servable/lr.py``), with the counts at 0: (a) the KMeans config in
    host rounds and the LR config in segments of MESH_SEGMENT rounds, each
    on MESH_SHARDS virtual shards of the card, fitted unarmed, then three
    times traced with the lock watchdog armed (each into its own trace
    dir), then unarmed again: every armed fit bit-identical to the
    unarmed one; ``mesh.json`` names MESH_SHARDS shards on platform
    ``gpu``, ``rows`` is 125,000 and 1,250,000 a shard, KMeans'
    ``nonFinite`` all 0, one ``readyMs`` observation a shard a round
    (KMeans) or a segment (LR); then the KMeans model's transform, and
    ``record_input_health`` on a placed copy of its table with NaNs in
    shard 5 only, naming shard 5; a profiled LR fit on the mesh; (b)
    phase 13's servable (an LR fit of SERVE_FIT_ROWS seeded rows with
    hyperplane labels, at the FTRL config's width) and traffic (400
    requests of 1, 2 and 4 rows from 64 callers) through a micro-batcher
    (buckets 8, 32, 128) on SERVE_SHARDS shards and on one, traced and
    warmed on the device thread: every response within SERVE_RTOL /
    SERVE_ATOL of the host float64 predict, every bucket sharded on
    SERVE_SHARDS shards, and the request paths reconstructed with at
    least 0.9 coverage; (c) the port's ``flink-ml-tpu-torch-trace`` over
    those dirs, each view's exit code and wall ms: ``summary --check``,
    ``shards --check`` (0 on the meshes, 2 on the one-shard serving dir),
    ``path --check``, ``locks --check`` on the serving dir, ``health
    --check`` on the fits, ``efficiency`` on the profiled fit, ``diff A B
    --budget DIFF_BUDGET_PCT --min-ms DIFF_MIN_MS`` of each fit's two warm
    armed runs (0), and ``python -m flink_ml_tpu_torch.observability.cli
    shards --check`` as a process; prints armed against unarmed fit ms,
    the ready waits per observation and shard, requests/s, p50/p99 and
    tick ms on each mesh, and the launches of ``PATH_KERNELS[
    "mesh_observability"]``, each at least once;
19. the rest of the parallel layer (``parallel/{mesh,collective,
    shardmap,sequence,distributed,elastic}.py``, the tensor-parallel SGD
    of ``ops/optimizer.py``), with the counts at 0: (a) the LR config on a
    (data 4, model 2) mesh of virtual shards: one ``reduce_partials`` a
    data shard a round for the model-axis margins and one for the data
    axes, no batch-terms call; its coefficients within COEFF_RTOL/ATOL of
    the 1-D fit over the same 4 data shards (the same rows a round), fit
    ms beside the 1-D 4- and 8-shard fits; (b) the KMeans and LR configs
    on a (dcn 2, data 4) mesh: with ``FLINK_ML_TPU_HIER_REDUCE=0`` bit for
    bit the 1-D 8-shard fits, with ``=1`` within CENTROID_ATOL /
    COEFF_RTOL-ATOL of them, the inter-level payload a sum
    ``ceil(w / 4) / w`` of the flat one (w, dim 0 of the summed value,
    padded to the 4 inner shards), two ``reduce_partials`` a sum; the
    KMeans model's transform; (c) ring and Ulysses attention, causal and
    not, over SEQ_SHARDS ``seq`` shards at L = SEQ_LEN, H = SEQ_HEADS, Dh
    = SEQ_DIM float32, each within SEQ_RTOL/SEQ_ATOL of full attention on
    the card, with ms and peak device memory (ring's under a quarter of
    full's); (d) ``scripts/port_gloo_cuda_probe.py`` on two ranks that
    share the card (the launcher picks gloo): every op of
    ``collective.GLOO_CUDA_OPS`` (the gloo collectives the port calls on
    CUDA tensors) takes them; then ``run_elastic``
    launches two gloo ranks of ``scripts/port_elastic_worker.py`` on the
    LR config (5,000,000 rows a rank, segments of ELASTIC_INTERVAL rounds,
    ``sgd_batch_terms`` in each rank); the worker-loss fault kills rank 1
    at boundary ELASTIC_KILL_AT; the driver names it, relaunches one rank,
    which resumes from the newest checkpoint (offsets rescaled, 2 shards →
    1), bit for bit a one-rank fit resumed here from the same snapshot;
    the trace holds ``elastic.worker-lost`` and ``elastic.relaunch``, a
    beacon's load carries ``provenance()``; prints detection, relaunch and
    resume ms;
20. static checks on the card's host: (1) the port's linter
    (``flink_ml_tpu_torch/analysis/``, torchlint) in this process over
    ``flink_ml_tpu_torch/``, ``chip_smoke.py`` and ``scripts/port_*.py``:
    exit 0 and 0 unsuppressed findings, its counts printed, and neither
    ``jax`` nor ``flink_ml_tpu`` in ``sys.modules`` afterwards; (2) one line
    with the count of justified ``host-sync`` suppressions per module, from
    its ``--suppressions`` audit; (3) ``benchmark/visualize.load_results``
    on a results JSON of the runner rows phases 5 and 16 returned (the
    three linear configs, ``benchmark-demo.json`` with its two broken
    rows), equal to those rows' results; (4) a chart of them where
    ``matplotlib`` imports, else the ``ImportError`` naming it and nothing
    written; wall ms beside the card's name and power limit; launches no
    kernel;
21. meshes over processes (``parallel/{mesh,collective,sequence,
    distributed}.py`` and the tensor-parallel SGD over ranks), with the
    counts at 0: ``scripts/port_mesh_worker.py`` ranks that share the card
    over gloo fit the LR config (10,000,000 x 100, 20 rounds of 100,000,
    uncut) on (a) four ranks of a (data 2, model 2) mesh, one position a
    rank (5,000,000 rows x 50 columns placed a rank; both axes' subgroups
    carry the sums), and (b) two ranks of two positions each on (data 2,
    model 2), whose model axis lies inside a rank (``reduce_partials``
    launches there), and on (data 1, model 2), whose model axis spans the
    ranks; each fit's coefficients against the in-process fit on the same
    mesh shape in this process: printed whether bit-equal, held within
    MESH_PROC_RTOL; (c) the same two ranks run ring and Ulysses attention,
    causal and not, at L = SEQ_LEN, H = SEQ_HEADS, Dh = SEQ_DIM on (seq
    4), two shards a rank: within MESH_PROC_ATT_ATOL of full attention,
    printed whether bit-equal to the in-process (seq 4) result; both ranks
    gather the same bits. Prints each fit's ms, attention ms and
    ``max_memory_allocated`` a rank, and the staged send/recv hops; every
    rank exits 0;
22. print one ``{"kernels": [...]}`` line with every kernel's launches in
    its main-path runs (in all and by path), error, times and bound, then
    the result line.

Tolerances (float32 throughout, TF32 off):
- labels: identical, except rows whose two nearest centroids are closer than
  TIE_RTOL (relative, in float64) — summation order decides those;
- partial sums (Lloyd and SGD): |kernel - plain| <= SUM_RTOL * |plain| +
  SUM_ATOL: sums over up to 1e5 rows of float32 terms, added in another
  order (per block, then across blocks) than the plain version adds them;
  counts exact wherever the labels agree;
- the KMeans main-path fit: centroids within CENTROID_ATOL of the plain
  fit's, and at least LABEL_AGREEMENT of its labels equal to the plain
  fit's. The benchmark's rows are uniform in [0, 1)^100 and have no cluster
  structure, so many rows sit near a boundary between clusters: the
  centroid drift that summation order causes over 10 rounds (about 3e-4)
  moves some tenths of a percent of the labels. The transform itself is
  held exactly (up to ties) against the plain assignment on the same
  centroids;
- the LR main-path fit: coefficients within COEFF_RTOL * |plain| +
  COEFF_ATOL of the plain fit's on the same table, and the final loss
  within COEFF_RTOL: 20 rounds whose gradient sums differ by float32
  reassociation only;
- small linear and FTRL fits on the card against the CPU: coefficients
  rtol SMALL_RTOL, atol SMALL_ATOL (a few hundred rows, sums in another
  order);
- KNN neighbours: identical, except rows where the two lists differ, and
  there, position by position, the float64 distances of the two train rows
  are within TIE_RTOL (relative): a swap at the k-th place or inside the
  list, which summation order decides. ``max_abs_err`` of the kernels line
  is the largest such float64 distance gap. Predictions equal the vote of
  the kernel's neighbours exactly, and differ from the plain vote only on
  such rows; small models predict identically on the card and the CPU;
- segment sums: within SUM_RTOL/SUM_ATOL of the plain version (float32
  sums of up to a million terms in another order; the plain version sums
  in float64);
- the sparse FTRL fit: identical coefficients on a rerun, and within
  CSR_RTOL/CSR_ATOL of the float64 host engine (the JAX package's own bound
  for its device-CSR engine, tests/test_sparse_training.py); its model
  scores its own stream above 85% accurate;
- the full-size dense FTRL fit on hyperplane labels: within BIG_FIT_RTOL,
  BIG_FIT_ATOL of the CPU's (100 batches whose 100,000-row sums are added
  in another order);
- phase 13: the served dots are a float32 product of 100 terms against
  the host's float64 one: within SERVE_RTOL relative, SERVE_ATOL absolute
  (margins that close to zero are the rows whose prediction may flip);
- phase 15: scaler statistics within STAT_RTOL of float64 ones (float32
  sums over up to 10,000,000 rows); continuous feature outputs within
  FEATURE_RTOL/FEATURE_ATOL of the CPU's on the same rows and statistics
  (float32 products and sums in another order); discrete outputs exact
  but within EDGE_ATOL of an edge;
- phase 19: the tensor-parallel fit against the 1-D 4-shard fit and the
  two-level hybrid LR fit against the flat one by COEFF_RTOL/ATOL (float32
  sums in another order over the same rows); the two-level KMeans fit by
  CENTROID_ATOL; attention by SEQ_RTOL/SEQ_ATOL (the JAX package's
  tolerance for its long causal sequence), online softmax against one
  softmax over 16,384 keys;
- phase 21: fits over ranks against the same mesh shape in-process by
  MESH_PROC_RTOL (every sum there has two operands, so the bits are
  expected equal, and the line says whether they are); attention against
  full attention by MESH_PROC_ATT_ATOL (max-abs);
- phase 11: a fit on eight shards differs from the one-shard fit only in
  the order its sums are added (per shard, then across the shards), so
  it is held as the fits that add in another order are: the KMeans fit
  by CENTROID_ATOL and LABEL_AGREEMENT (the labels of both fits' centroids
  under the plain assignment), the FTRL fits by BIG_FIT_RTOL/ATOL; the LR
  fit on eight shards takes other batches than on one (each shard its
  own local batch), so it is held against its own plain rounds by
  COEFF_RTOL/ATOL; the sharded update against the replicated one by rtol
  1e-5 (virtual shards add in the same order, so both are expected bit
  for bit, and the line says whether they were).
"""

import contextlib
import io
import itertools
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "flink_ml_tpu" / "benchmark" / "configs"
CONFIG = CONFIGS / "kmeans-benchmark.json"
LINEAR_CONFIGS = {
    "logisticregression": CONFIGS / "logisticregression-benchmark.json",
    "linearsvc": CONFIGS / "linearsvc-benchmark.json",
    "linearregression": CONFIGS / "linearregression-benchmark.json",
}
KNN_CONFIG = CONFIGS / "knn-benchmark.json"
FTRL_CONFIG = CONFIGS / "onlinelogisticregression-benchmark.json"
# each path's own kernels; reduce_partials is Lloyd's second stage alone
# (SGD and the segment sums launch their own from their C entries)
PATH_KERNELS = {
    "kmeans": ("assign_nearest", "lloyd_partial_sums", "reduce_partials"),
    "linear": ("sgd_batch_terms",),
    "knn": ("knn_topk_indices",),
    "ftrl": ("segment_reduce_sum",),
    # the LR and KMeans fits in the iteration runtime's modes, KMeans
    # transform after each, and FTRL's sparse stream with a checkpoint
    # interval
    "iteration": ("sgd_batch_terms", "assign_nearest", "lloyd_partial_sums",
                  "reduce_partials", "segment_reduce_sum"),
    # the LR, KMeans and FTRL fits on one and eight shards: a launch per
    # shard, and reduce_partials for the cross-shard sums
    "parallel": ("sgd_batch_terms", "lloyd_partial_sums", "reduce_partials",
                 "segment_reduce_sum"),
    # the traced, health-armed and profiled LR and KMeans fits, and a
    # profiled KMeans transform
    "observability": ("sgd_batch_terms", "assign_nearest",
                      "lloyd_partial_sums", "reduce_partials"),
    # the producer LR fit of the serving path (its FTRL fit runs dense
    # batches, which launch no kernel; serving's product is one torch call)
    "serving": ("sgd_batch_terms",),
    # the ops loop: the v1 LR fit, and every retrain an FTRL refit through
    # the device-CSR engine
    "ops": ("sgd_batch_terms", "segment_reduce_sum"),
    # Pipeline([StandardScaler, LogisticRegression]) and the graph of the
    # same two stages fit through SGD; Pipeline([MinMaxScaler, KMeans])
    # fits through Lloyd and predicts through the assignment
    "pipeline": ("sgd_batch_terms", "assign_nearest", "lloyd_partial_sums",
                 "reduce_partials"),
    # the sparse text example's and the hashed stream's FTRL fits through
    # the device-CSR engine (one C entry: no reduce_partials)
    "text": ("segment_reduce_sum",),
    # OnlineKMeans: one Lloyd partials call and its second stage a batch
    # (OnlineStandardScaler launches no kernel of the port)
    "online": ("lloyd_partial_sums", "reduce_partials"),
    # LogisticRegression and LinearSVC on a CSR column: two segment sums a
    # round (the per-row dots, then the gradient)
    "sparse_linear": ("segment_reduce_sum",),
    # the traced 8-shard KMeans fit (Lloyd and its cross-shard sums), its
    # transform, the 8-shard LR fits and the serving producer's LR fit
    "mesh_observability": ("sgd_batch_terms", "lloyd_partial_sums",
                           "reduce_partials", "assign_nearest"),
    # the tensor-parallel LR fit (its model- and data-axis sums), the
    # hybrid-mesh KMeans and LR fits and the KMeans transform, and the
    # elastic ranks' LR fits (their launches counted in the ranks)
    "parallel_layer": ("sgd_batch_terms", "lloyd_partial_sums",
                       "reduce_partials", "assign_nearest"),
    # the tensor-parallel LR fits over ranks (counted in the ranks): the
    # in-process part of a sum over an axis a rank holds two shards of
    "meshes_processes": ("reduce_partials",),
}
# phase 15's configs, run uncut through the runner
FEATURE_CONFIGS = (
    "standardscaler", "minmaxscaler", "maxabsscaler", "robustscaler",
    "vectorassembler", "normalizer", "bucketizer", "binarizer",
    "elementwiseproduct", "polynomialexpansion", "dct", "interaction",
    "vectorslicer", "univariatefeatureselector", "variancethresholdselector",
    "naivebayes")
LOSSES = ("logistic", "hinge", "least_square")

TIE_RTOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
CENTROID_ATOL = 1e-3
LABEL_AGREEMENT = 0.99
COEFF_RTOL, COEFF_ATOL = 1e-4, 1e-6
SMALL_RTOL, SMALL_ATOL = 1e-5, 1e-6
CSR_RTOL, CSR_ATOL = 1e-3, 1e-5
BIG_FIT_RTOL, BIG_FIT_ATOL = 1e-4, 1e-5
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-4
# phase 13's request sizes (rows), serve_bench.py's mix
SERVE_SIZES = (1, 2, 4)
# phase 14: the v1 fit's rows; the traffic's mean shift (every feature, in
# standard deviations); rows per traffic drive, of which the retrain buffer
# keeps the last two drives, in requests of OPS_REQUEST_ROWS rows from
# OPS_CALLERS closed-loop callers; the refit's batch
# (6,400 stored values, past FTRL_SPARSE_MIN_NNZ) and its passes over the
# buffer; the drift sample floor; the chaos plan at the five controller
# sites
OPS_V1_ROWS = 200_000
OPS_SHIFT = 3.0
OPS_DRIVE_ROWS = 512
OPS_REQUEST_ROWS, OPS_CALLERS = 4, 16
OPS_RETRAIN_BATCH, OPS_RETRAIN_PASSES = 64, 4
OPS_MIN_COUNT = 400
OPS_CHAOS_SEED, OPS_CHAOS_RATE = 20260804, 0.2
# phase 15: the graph's seeded rows; the rows of a host copy each feature
# config's output is held against the CPU on; the statistics' tolerance;
# the continuous outputs' tolerance; how near a split or threshold a value
# may lie for its discrete output to be left unchecked
GRAPH_ROWS = 200_000
FEATURE_ROWS = 65_536
STAT_RTOL = 1e-4
FEATURE_RTOL, FEATURE_ATOL = 1e-5, 1e-6
EDGE_ATOL = 1e-6

# phase 16: the configs run uncut through the runner; the hashed stream's
# global batch, the prefix (in batches) held against the host engine, and
# the accuracy its model must reach on its own stream; the keys of the
# native factorize check, the rows of the CSV check, the CountVectorizer
# rows of the pool check, and the wedged worker's deadline; the demo
# config's two broken rows as the JAX runner reports them
TEXT_CONFIGS = (
    "tokenizer", "regextokenizer", "ngram", "stopwordsremover", "hashingtf",
    "featurehasher", "countvectorizer", "idf", "stringindexer",
    "onehotencoder", "kbinsdiscretizer", "vectorindexer", "imputer",
    "sqltransformer")
TEXT_BATCH = 100_000
TEXT_PREFIX_BATCHES = 10
TEXT_ACCURACY = 0.95
HOST_KEYS = 10_000_000
HOST_CSV_ROWS = 200_000
HOST_POOL_ROWS = 1_000_000
HANG_DEADLINE_S = 2.0
DEMO_FAILURES = {
    "Undefined-Parameter": "ValueError: unknown parameter 'featureCol' for "
                           "KMeans",
    "Unmatch-Input": "ValueError: too many values to unpack (expected 1)"}

# phase 17: (a) OnlineKMeans's global batch over the KMeans table, its decay,
# the batches replayed in float64 numpy and run on the CPU, and the
# tolerance of each batch's step against the plain and the float64 one
# from the same state (batch sums of ~1,000 rows in another order or
# width, divided by the count: about 1e-7; a step with tie rows is held by
# CENTROID_ATOL); (b) OnlineStandardScaler's
# count window over the LR table, the constant offset of the cancellation
# case, the event-time window and its timestamps' seed, and the statistics'
# tolerances (relative, against float64 two-pass moments of the same
# float32 values: the means and the stds are float64 sums of exact values
# added in another order; with the offset, Σx² − n·m² cancels seven
# digits of float64); (c) the host-rounds fit's checkpoint interval and the
# round it is interrupted at, and the accuracy bar of the CSR fits on
# their own table; (e) Swing's seeded purchase log (users, the items they
# draw from, purchases each) and the prefix held against the Python oracle
STREAM_BATCH = 10_000
STREAM_DECAY = 0.5
STREAM_REPLAY_BATCHES = 10
STEP_ATOL = 1e-5
SCALER_WINDOW = 100_000
SCALER_OFFSET = 1e3
SCALER_EVENT_MS = 150_000
SCALER_TS_SEED = 17
SCALER_MEAN_RTOL = 1e-12
SCALER_STD_RTOL = 1e-9
SCALER_OFFSET_STD_RTOL = 1e-6
SPARSE_CKPT_INTERVAL = 5
SPARSE_CRASH_ROUND = 12
SPARSE_ACCURACY = 0.75
# phase 18: the virtual shards of the fits and of the sharded serving run,
# the LR fit's segment, the serving producer's rows, and the `diff` gate
# between the two warm armed runs of each fit (a span name regresses only
# past both: DIFF_BUDGET_PCT percent and DIFF_MIN_MS ms of self time)
MESH_SHARDS = 8
MESH_SEGMENT = 5
SERVE_SHARDS = 4
SERVE_FIT_ROWS = 1_000_000
DIFF_BUDGET_PCT = 100
DIFF_MIN_MS = 25
SWING_SEED = 17
SWING_USERS, SWING_ITEMS, SWING_PER_USER = 20_000, 10_000, 20
SWING_PREFIX_USERS = 2_000

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W): device
# memory bytes per second and fp32 (non-tensor-core) operations per second
# phase 19: attention at a long-context size (the full score matrix, 8 x
# 16,384^2 float32, is 8.6 GB), held at the JAX test's tolerance; the
# elastic fit's checkpoint interval and the boundary whose worker-loss
# fault kills rank 1
SEQ_LEN, SEQ_HEADS, SEQ_DIM, SEQ_SHARDS = 16_384, 8, 64, 8
SEQ_RANK_LEN = 2_048  # the same over two gloo ranks
SEQ_RTOL, SEQ_ATOL = 5e-4, 5e-5
ELASTIC_INTERVAL = 5
ELASTIC_KILL_AT = 2
# phase 21: fits over ranks against the in-process fit on the same mesh
# shape (relative), and attention over ranks against full attention
# (max-abs)
MESH_PROC_RTOL = 1e-6
MESH_PROC_ATT_ATOL = 1e-5
SEQ_SHARDS_PROC = 4
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, batches=7, per_batch=10, warmup=3):
    """Median per-call device time over batches of back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def graph_ms(fn, reps=20):
    """Device time per call of a short kernel: ``reps`` calls captured in a
    CUDA graph and replayed, so that the host's enqueue time does not hide
    the card's."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, batches=5, per_batch=5, warmup=1) / reps


def rolling_starts(n, lb):
    """A function giving window starts that move on by lb at every call and
    wrap at the end of n rows: a timed call reads rows that the calls just
    before it did not leave in L2, as every round of a fit does."""
    starts = itertools.cycle(range(0, n - lb + 1, lb))
    return lambda: next(starts)


def bound_ms(nbytes, ops):
    """The least time the card could take for work of ``nbytes`` bytes and
    ``ops`` fp32 operations (``ops/kernels.py`` ``launch_cost`` counts
    both), and which of the two bounds it."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tie_rows_ok(x, c, got, want):
    """Rows where two label vectors differ must be near ties."""
    rows = torch.nonzero(got != want).flatten()
    if rows.numel() == 0:
        return 0
    xd, cd = x[rows].double(), c.double()
    d_got = ((xd - cd[got[rows].long()]) ** 2).sum(1)
    d_want = ((xd - cd[want[rows].long()]) ** 2).sum(1)
    gap = (d_got - d_want).abs() / torch.maximum(d_got, d_want).clamp_min(1e-30)
    worst = float(gap.max())
    assert worst <= TIE_RTOL, (
        f"{rows.numel()} labels differ and not at ties: relative gap {worst}")
    return rows.numel()


def check_assign(K, x, c, tag):
    got = K.assign_nearest(x, c)
    want = K.assign_nearest_plain(x, c)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0],), tag
    assert torch.equal(got, K.assign_nearest(x, c)), f"{tag}: rerun differs"
    ties = tie_rows_ok(x, c, got, want)
    log(f"  assign_nearest {tag}: n={x.shape[0]} d={x.shape[1]} "
        f"k={c.shape[0]} tie-flips={ties}")
    return got, want


def check_lloyd(K, x, v, c, tag):
    got = K.lloyd_partial_sums(x, v, c)
    want = K.lloyd_partial_sums_plain(x, v, c)
    assert got.shape == (c.shape[0], c.shape[1] + 1), tag
    assert torch.equal(got, K.lloyd_partial_sums(x, v, c)), (
        f"{tag}: rerun not bit-identical")
    excess = ((got - want).abs() - SUM_RTOL * want.abs() - SUM_ATOL).max()
    ties = 0
    if x.shape[0]:
        ties = tie_rows_ok(x, c, K.assign_nearest(x, c),
                           K.assign_nearest_plain(x, c))
    if ties == 0:
        assert torch.equal(got[:, -1], want[:, -1]), f"{tag}: counts differ"
    else:
        assert float((got[:, -1] - want[:, -1]).abs().sum()) <= 2 * ties, tag
    assert float(excess) <= 0, f"{tag}: sums off by {float(excess)} over tolerance"
    log(f"  lloyd_partial_sums {tag}: n={x.shape[0]} d={x.shape[1]} "
        f"k={c.shape[0]} max|err|={float((got - want).abs().max()):.3g} "
        f"tie-flips={ties}")
    return got, want


def within_sum_tol(got, want, tag):
    excess = float(((got - want).abs() - SUM_RTOL * want.abs() - SUM_ATOL).max())
    assert excess <= 0, f"{tag}: off by {excess} over tolerance"
    return float((got - want).abs().max())


def phase_build(K):
    start = time.perf_counter()
    logs = K.build_kernels()
    log(f"phase 1: built {sorted(logs) or 'cached library'} in "
        f"{time.perf_counter() - start:.1f} s")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())


def phase_kernels(K):
    log("phase 2: KMeans kernels against their plain versions on the card")
    g = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    # ragged n, n = 0, zero-weight rows, wide k (chunked centroids), odd d
    for n, d, k, zero_share, tag in [
            (100_003, 100, 10, 0.0, "ragged-n"),
            (0, 100, 10, 0.0, "n=0"),
            (200_000, 100, 10, 0.3, "zero-weights"),
            (50_000, 100, 300, 0.0, "wide-k"),
            (10_007, 7, 5, 0.0, "odd-d")]:
        x, c = rand(n, d), rand(k, d)
        v = (rand(n) >= zero_share).float()
        check_assign(K, x, c, tag)
        got, _ = check_lloyd(K, x, v, c, tag)
        if tag == "wide-k":
            assert K._layout(k, d, False)[1] < k, "wide-k did not chunk (assign)"
            assert K._layout(k, d, True)[1] < k, "wide-k did not chunk (Lloyd)"
        if tag == "zero-weights":
            keep = v > 0
            alone = K.lloyd_partial_sums(x[keep].contiguous(),
                                         torch.ones(int(keep.sum()), device="cuda"), c)
            assert torch.allclose(got, alone, rtol=SUM_RTOL, atol=SUM_ATOL), (
                "zero-weight rows added something")
        if n == 0:
            assert not got.any(), "n=0 must give zeros"

    # the main-path shape: errors, times, bounds
    n, d, k = 1_000_000, 100, 10
    x, c, v = rand(n, d), rand(k, d), torch.ones(n, device="cuda")
    a_got, a_want = check_assign(K, x, c, "main")
    p_got, p_want = check_lloyd(K, x, v, c, "main")
    partials = K._launch_lloyd_partials(x, v, c)
    r_got = K.reduce_partials(partials)
    r_want = K.reduce_partials_plain(partials)
    assert torch.equal(r_got, r_want), "reduce differs from its plain version"
    blocks = partials.shape[0]

    one_hot = torch.nn.functional.one_hot(a_want.long(), k).float() * v[:, None]
    x_aug = torch.cat([x, torch.ones(n, 1, device="cuda")], dim=1)
    rows = {
        "assign_nearest": dict(
            err=float((a_got - a_want).abs().max()),
            kernel=lambda: K.assign_nearest(x, c),
            plain=lambda: K.assign_nearest_plain(x, c),
            # one PyTorch call for the same labels
            library=lambda: torch.cdist(x, c).argmin(1),
            cost=K.launch_cost("assign_nearest", n=n, k=k, d=d)),
        "lloyd_partial_sums": dict(
            err=float((p_got - p_want).abs().max()),
            kernel=lambda: K.lloyd_partial_sums(x, v, c),
            plain=lambda: K.lloyd_partial_sums_plain(x, v, c),
            # the one-hot product alone, given the labels
            library=lambda: torch.matmul(one_hot.T, x_aug),
            cost=K.launch_cost("lloyd_partial_sums", n=n, k=k, d=d)),
    }
    measured = {}
    for name, r in rows.items():
        b_ms, b_by = bound_ms(*r["cost"])
        measured[name] = {
            "max_abs_err": r["err"], "ms": time_ms(r["kernel"]),
            "plain_ms": time_ms(r["plain"]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(r["library"])}
        log(f"  {name} @ 1M x 100, k=10: {measured[name]}")
    stage1 = time_ms(lambda: K._launch_lloyd_partials(x, v, c))
    stage1_device = graph_ms(lambda: K._launch_lloyd_partials(x, v, c))
    measured["lloyd_partial_sums"]["stage1_device_ms"] = stage1_device
    log(f"  lloyd stage 1 alone: {stage1:.4f} ms over {blocks} blocks; "
        f"device {stage1_device:.4f} ms")

    # the second stage at Lloyd's partials shape, made by its path's first
    # stage, and, from seeded tensors, at the shapes of the second stages
    # SGD and the segment sums took into their own C entries (SGD's block
    # partials at the main window; FTRL's gradient and per-row dots
    # partials); device times
    sgd_blocks = K._sgd_card_plan(x, 100_000, "logistic").blocks
    shapes = {
        "Lloyd": partials,
        "SGD": torch.randn(sgd_blocks, d + 2, generator=g, device="cuda"),
        "FTRL gradient": torch.randn(1024, 100, 2, generator=g, device="cuda"),
        "FTRL per-row dots": torch.randn(25, 1 << 17, 1, generator=g,
                                         device="cuda"),
    }
    for tag, p in shapes.items():
        assert torch.equal(K.reduce_partials(p), K.reduce_partials_plain(p)), (
            f"reduce differs from its plain version at {tag}")
        ms = {"eager": time_ms(lambda: K.reduce_partials(p)),
              "eager sum": time_ms(lambda: torch.sum(p, dim=0)),
              "device": graph_ms(lambda: K.reduce_partials(p)),
              "device sum": graph_ms(lambda: torch.sum(p, dim=0))}
        log(f"  reduce_partials @ {tag} {tuple(p.shape)}: eager "
            f"{ms['eager']:.5f} ms against torch.sum {ms['eager sum']:.5f} "
            f"ms; device {ms['device']:.5f} ms against torch.sum "
            f"{ms['device sum']:.5f} ms; bit-identical to the plain version"
            + "".join(f"; {kind} SLOWER than torch.sum"
                      for kind in ("eager", "device")
                      if ms[kind] > ms[f"{kind} sum"]))
        if tag == "Lloyd":
            b_ms, b_by = bound_ms(*K.launch_cost(
                "reduce_partials", blocks=blocks, inner=k * (d + 1)))
            # eager times, as every row of the kernels line has them; the
            # device times of a replayed CUDA graph beside them
            measured["reduce_partials"] = {
                "max_abs_err": float((r_got - r_want).abs().max()),
                "ms": ms["eager"],
                "plain_ms": time_ms(lambda: K.reduce_partials_plain(p)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": ms["eager sum"], "device_ms": ms["device"],
                "library_device_ms": ms["device sum"]}
    log(f"  reduce_partials @ Lloyd: {measured['reduce_partials']}")
    del shapes
    return measured


def check_sgd(K, x, y, w, c, start, clip, lb, loss, tag):
    got = K.sgd_batch_terms(x, y, w, c, start, clip, lb, loss)
    want = K.sgd_batch_terms_plain(x, y, w, c, start, clip, lb, loss)
    assert got.shape == (x.shape[1] + 2,) and got.dtype == torch.float32, tag
    assert torch.isfinite(got).all(), f"{tag}: non-finite terms"
    assert torch.equal(got, K.sgd_batch_terms(x, y, w, c, start, clip, lb,
                                              loss)), (
        f"{tag}: rerun not bit-identical")
    err = within_sum_tol(got, want, tag)
    plan = K._sgd_card_plan(x, lb, loss)
    log(f"  sgd_batch_terms {loss} {tag}: start={start} clip={clip} lb={lb} "
        f"d={x.shape[1]} max|err|={err:.3g}; {plan.instance} v={plan.v} "
        f"vec4={plan.vec4} grid={plan.blocks} of {plan.resident} resident")
    return got, want, err


def phase_sgd_kernels(K):
    from flink_ml_tpu_torch.ops.losses import LossFunc

    log("phase 3: the SGD kernel against its plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    # the main-path table: 10,000,000 x 100, labels in {0, 1}
    n, d, lb = 10_000_000, 100, 100_000
    x = rand(n, d)
    y = torch.floor(rand(n) * 2)
    w = rand(n)
    c = rand(d) - 0.5
    main_err = 0.0
    for loss in LOSSES:
        for start, clip, this_lb, tag in [
                (0, 0, lb, "main"),
                (n // 2 - 37, 0, lb, "middle"),
                (n - lb, 41_234, lb, "end-clipped"),
                (17, 0, lb + 3, "ragged-lb"),
                (123_457, 0, 1, "lb=1")]:
            _, _, err = check_sgd(K, x, y, w, c, start, clip, this_lb, loss, tag)
            if tag == "main":
                main_err = max(main_err, err)
        # zero-weight rows add nothing: the same sums as the kept rows alone
        xs, ys = x[:200_000], y[:200_000]
        ws = w[:200_000] * (rand(200_000) >= 0.3).float()
        got, _, _ = check_sgd(K, xs, ys, ws, c, 0, 0, 200_000, loss,
                              "zero-weights")
        keep = ws > 0
        alone = K.sgd_batch_terms(xs[keep].contiguous(), ys[keep].contiguous(),
                                  ws[keep].contiguous(), c, 0, 0,
                                  int(keep.sum()), loss)
        within_sum_tol(got, alone, "zero-weights against the kept rows")
        # an odd width, and rows so wide that the kernel stages them in
        # column chunks (one aligned, one odd with a ragged last chunk)
        for dd, rows, tag in [(7, 10_007, "odd-d"), (1_500, 5_000, "chunked-d"),
                              (6_001, 3_000, "chunked-odd-d")]:
            xd = rand(rows, dd)
            cd = (rand(dd) - 0.5) / dd ** 0.5
            check_sgd(K, xd, y[:rows].contiguous(), w[:rows].contiguous(), cd,
                      5, 3, rows - 9, loss, tag)
            wide_row = dd > K.SGD_REG_COLS
            assert K._sgd_card_plan(xd, rows - 9, loss).instance == (
                "chunked" if wide_row else "registers"), tag
    # margins far past exp's float32 range: the multipliers must come out
    # as +-0 or +-w, and the loss finite
    big = c * 1000
    got, want, _ = check_sgd(K, x, y, w, big, 0, 0, lb, "logistic", "overflow")

    # the C entry's second stage against the plain order of its own
    # partials, for every loss
    for loss in LOSSES:
        ws = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, loss)
        assert torch.equal(ws[-1], K.reduce_partials_plain(ws[:-1])), (
            f"{loss}: the combine differs from reduce_partials_plain")
    blocks = ws.shape[0] - 1
    log(f"  sgd combine of ({blocks}, {d + 2}) partials: bit-identical to "
        "reduce_partials_plain for every loss")
    loss = "logistic"

    # times and bounds at the main-path window size, logistic instance; each
    # timed call takes the next window of the table (cold in L2)
    mult = LossFunc.by_name(loss).terms(x @ c, y, w)[1]
    kernel_start, plain_start, library_start = (rolling_starts(n, lb)
                                                for _ in range(3))

    def library():
        s = library_start()
        # the gradient matvec alone, given the multipliers
        return torch.mv(x[s:s + lb].T, mult[s:s + lb])

    rows = {
        "sgd_batch_terms": dict(
            err=main_err,
            kernel=lambda: K.sgd_batch_terms(x, y, w, c, kernel_start(), 0, lb,
                                             loss),
            plain=lambda: K.sgd_batch_terms_plain(x, y, w, c, plain_start(),
                                                  0, lb, loss),
            library=library,
            cost=K.launch_cost("sgd_batch_terms", lb=lb, d=d)),
    }
    measured = {}
    for name, r in rows.items():
        b_ms, b_by = bound_ms(*r["cost"])
        measured[name] = {
            "max_abs_err": r["err"], "ms": time_ms(r["kernel"]),
            "plain_ms": time_ms(r["plain"]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(r["library"]),
            "device_ms": graph_ms(r["kernel"]),
            "library_device_ms": graph_ms(r["library"])}
    stage1_start = rolling_starts(n, lb)

    def stage1_call():
        return K._launch_sgd_terms(x, y, w, c, stage1_start(), 0, lb, loss,
                                   combine=False)

    stage1 = time_ms(stage1_call)
    measured["sgd_batch_terms"]["stage1_device_ms"] = graph_ms(stage1_call)
    log(f"  sgd_batch_terms @ lb=100,000 of 10M x 100: "
        f"{measured['sgd_batch_terms']}")
    log(f"  sgd stage 1 alone: {stage1:.4f} ms over {blocks} blocks; device "
        f"{measured['sgd_batch_terms']['stage1_device_ms']:.4f} ms")
    hot = time_ms(lambda: K.sgd_batch_terms(x, y, w, c, 0, 0, lb, loss))
    log(f"  sgd_batch_terms on one window again and again (warm L2): "
        f"{hot:.4f} ms")
    for other in ("hinge", "least_square"):
        other_start = rolling_starts(n, lb)
        log(f"  sgd_batch_terms {other}: " + "%.4f ms" % time_ms(
            lambda: K.sgd_batch_terms(x, y, w, c, other_start(), 0, lb, other)))
    # a wide row: the chunked kernel against its plain version, timed
    wide_d, wide_rows = 2_000, 100_000
    xw = rand(wide_rows, wide_d)
    cw = (rand(wide_d) - 0.5) / wide_d ** 0.5
    yw, ww = y[:wide_rows].contiguous(), w[:wide_rows].contiguous()
    log(f"  sgd_batch_terms chunked @ {wide_rows} x {wide_d}: "
        + "%.4f ms (plain %.4f ms)" % (
            time_ms(lambda: K.sgd_batch_terms(xw, yw, ww, cw, 0, 0, wide_rows,
                                              loss)),
            time_ms(lambda: K.sgd_batch_terms_plain(xw, yw, ww, cw, 0, 0,
                                                    wide_rows, loss))))
    del x, y, w, mult, ws, xw
    torch.cuda.empty_cache()
    return measured


def phase_main_path(K, runner, kmeans_mod):
    log("phase 4: the KMeans main path through the port's entry points")
    spec = runner.load_config(str(CONFIG))["KMeans"]
    params = spec["stage"]["paramMap"]
    n = spec["inputData"]["paramMap"]["numValues"]
    k, max_iter = params["k"], params["maxIter"]

    K.reset_launch_counts()
    row = runner.best_of("KMeans", spec, runs=2)
    log("  benchmark row:", json.dumps(row, sort_keys=True))
    assert row["executionPath"] == "cuda-lloyd", row["executionPath"]

    table = runner.build_generator(spec).get_data()
    estimator = runner.build_stage(spec)
    model = estimator.fit(table)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = model.transform(table)[0]
    labels = out[model.prediction_col]
    torch.cuda.synchronize()
    transform_ms = (time.perf_counter() - start) * 1e3
    assert estimator.last_execution_path == "cuda-lloyd"
    assert model.last_execution_path == "cuda-assign"
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0][loaded.prediction_col]
    assert torch.equal(labels, again), "the loaded model predicts otherwise"
    counts = dict(K.launch_counts)
    log(f"  transform: {transform_ms:.3f} ms for {n} rows; save/load: same labels")
    log(f"  launches in the main-path run: {counts}")

    # is the output right: shapes, finiteness, and the plain fit on the card
    assert labels.dtype == torch.int64 and labels.shape == (n,)
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    x = table.vectors(estimator.features_col)
    fitted = torch.as_tensor(model.centroids, dtype=torch.float32, device="cuda")
    ties = tie_rows_ok(x, fitted, labels, K.assign_nearest_plain(x, fitted).long())
    log(f"  transform against the plain assignment: tie-flips={ties}")
    assert model.centroids.shape == (k, 100) and np.isfinite(model.centroids).all()
    assert model.weights.sum() == n
    centroids = kmeans_mod.initial_centroids(x, k, estimator.get_seed_or_default())
    v = torch.ones(n, device="cuda")
    for _ in range(max_iter):
        centroids, _ = kmeans_mod.lloyd_round(K.lloyd_partial_sums_plain, x, v,
                                              centroids)
    diff = float(np.abs(centroids.cpu().numpy() - model.centroids).max())
    plain_labels = K.assign_nearest_plain(x, centroids).long()
    agree = float((plain_labels == labels).float().mean())
    log(f"  against the plain fit: max|centroid diff|={diff:.3g}, "
        f"label agreement={agree:.6f}")
    assert diff <= CENTROID_ATOL and agree >= LABEL_AGREEMENT

    # small fits give the same model on the card and on the CPU: the blob
    # tables of tests/test_torch_kmeans.py, whose CPU fits match the JAX
    # package's (no row of them sits near a tie)
    Table = type(table)
    for n_small, d_small, k_small, iters in [(300, 8, 3, 5), (250, 16, 4, 10)]:
        rng = np.random.default_rng(n_small + d_small)
        centers = rng.normal(size=(k_small, d_small)) * 10
        small = (centers[rng.integers(0, k_small, n_small)]
                 + rng.normal(size=(n_small, d_small)) * 0.2)
        fits = [kmeans_mod.KMeans(k=k_small, seed=11, max_iter=iters,
                                  device=dev).fit(Table.from_columns(features=small))
                for dev in ("cuda", "cpu")]
        np.testing.assert_allclose(fits[0].centroids, fits[1].centroids,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(fits[0].weights, fits[1].weights)
    log("  small fits: card and CPU agree")

    assert counts["lloyd_partial_sums"] >= max_iter, counts
    assert counts["reduce_partials"] >= max_iter, counts
    assert counts["assign_nearest"] >= 1, counts
    return counts


def _small_linear_table(Table, seed, n, d, regression):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    margin = x @ (rng.normal(size=d) * 2)
    y = margin + 0.1 * rng.normal(size=n) if regression else (margin > 0) * 1.0
    return Table.from_columns(features=x, label=y, weight=rng.random(n) + 0.5)


def phase_linear_main_path(K, runner, optimizer, Table, keep=None):
    log("phase 5: the linear-model main path through the port's entry points")
    specs = {name: runner.load_config(str(path))[name]
             for name, path in LINEAR_CONFIGS.items()}
    spec = specs["logisticregression"]
    n = spec["inputData"]["paramMap"]["numValues"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    max_iter = spec["stage"]["paramMap"]["maxIter"]

    K.reset_launch_counts()
    rows = {"logisticregression": runner.best_of("logisticregression", spec,
                                                 runs=2)}
    fits = 3  # warmup + two timed runs
    for name in ("linearsvc", "linearregression"):
        rows[name] = runner.run_benchmark(name, specs[name])
        fits += 1
    for name, row in rows.items():
        log(f"  benchmark row {name}:", json.dumps(row, sort_keys=True))
        assert row["executionPath"] == "cuda-sgd", (name, row["executionPath"])
        assert row["inputRecordNum"] == n and row["outputRecordNum"] == 1
    if keep is not None:  # phase 20 draws them, in the runner's schema
        keep.setdefault("runner_results", {}).update({
            name: {"stage": specs[name]["stage"],
                   "inputData": specs[name]["inputData"], "results": row}
            for name, row in rows.items()})

    table = runner.build_generator(spec).get_data()
    estimator = runner.build_stage(spec)
    model = estimator.fit(table)
    fits += 1
    assert estimator.last_execution_path == "cuda-sgd"
    transform_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.transform(table)[0]
        torch.cuda.synchronize()
        transform_ms.append((time.perf_counter() - start) * 1e3)
    pred, raw = out[model.prediction_col], out[model.raw_prediction_col]
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0]
    assert torch.equal(pred, again[loaded.prediction_col]), (
        "the loaded model predicts otherwise")
    assert torch.equal(raw, again[loaded.raw_prediction_col])
    counts = dict(K.launch_counts)
    log(f"  LR transform: {min(transform_ms):.3f} ms (best of 3) for {n} "
        f"rows; save/load: same predictions")
    log(f"  launches in the main-path run: {counts}")

    # is the output right: shapes, finiteness, the plain fit on the card
    assert pred.shape == (n,) and pred.dtype == torch.float32
    assert raw.shape == (n, 2) and bool(torch.isfinite(raw).all())
    assert set(torch.unique(pred).tolist()) <= {0.0, 1.0}
    coeffs = model.coefficients
    assert coeffs.shape == (d,) and np.isfinite(coeffs).all()
    x = table.vectors(estimator.features_col)
    y = table.column(estimator.label_col)
    w = torch.ones(n, device="cuda")
    prm = optimizer.SGDParams(
        learning_rate=estimator.learning_rate,
        global_batch_size=estimator.global_batch_size, max_iter=max_iter,
        tol=estimator.tol, reg=estimator.reg,
        elastic_net=estimator.elastic_net)
    plain, plain_loss, plain_rounds = optimizer.sgd_rounds(
        K.sgd_batch_terms_plain, "logistic", prm, x, y, w,
        torch.zeros(d, device="cuda"))
    kern, kern_loss, kern_rounds = optimizer.sgd_rounds(
        K.sgd_batch_terms, "logistic", prm, x, y, w,
        torch.zeros(d, device="cuda"))
    plain = plain.double().cpu().numpy()
    assert np.array_equal(kern.double().cpu().numpy(), coeffs), (
        "the estimator's fit differs from the same rounds run directly")
    diff = np.abs(coeffs - plain)
    log(f"  against the plain fit: max|coeff diff|={diff.max():.3g} "
        f"(max|coeff|={np.abs(plain).max():.3g}), loss {float(kern_loss):.7g} "
        f"vs {float(plain_loss):.7g}, rounds {int(kern_rounds)}")
    assert np.all(diff <= COEFF_RTOL * np.abs(plain) + COEFF_ATOL)
    assert abs(float(kern_loss) - float(plain_loss)) <= COEFF_RTOL * abs(
        float(plain_loss))
    assert int(kern_rounds) == int(plain_rounds)

    # where a fit's time goes: the rounds alone, on tensors already placed
    torch.cuda.synchronize()
    start = time.perf_counter()
    optimizer.sgd_rounds(K.sgd_batch_terms, "logistic", prm, x, y, w,
                         torch.zeros(d, device="cuda"))
    enqueue_ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    rounds_ms = (time.perf_counter() - start) * 1e3
    log(f"  {max_iter} rounds alone: {rounds_ms:.3f} ms "
        f"({enqueue_ms:.3f} ms of it to enqueue them)")
    del x, y, w, table, out, pred, raw, again
    torch.cuda.empty_cache()

    # small fits give the same model on the card and on the CPU
    from flink_ml_tpu_torch.models import classification, regression
    for i, cls in enumerate((classification.LogisticRegression,
                             classification.LinearSVC,
                             regression.LinearRegression)):
        small = _small_linear_table(Table, 10 + i, 400, 7,
                                    cls.__name__ == "LinearRegression")
        params = dict(max_iter=15, global_batch_size=96, learning_rate=0.05,
                      reg=0.01, elastic_net=0.3, weight_col="weight")
        fitted = {}
        for dev in ("cuda", "cpu"):
            est = cls(device=dev, **params)
            fitted[dev] = est.fit(small).coefficients
            assert est.last_execution_path == (
                "cuda-sgd" if dev == "cuda" else "torch-sgd")
        np.testing.assert_allclose(fitted["cuda"], fitted["cpu"],
                                   rtol=SMALL_RTOL, atol=SMALL_ATOL)
    log("  small fits of the three models: card and CPU agree")

    assert counts["sgd_batch_terms"] >= max_iter * fits, counts
    # one C entry a round launches both stages
    assert counts["reduce_partials"] == 0, counts
    return counts


def knn_tie_check(x, train, got, want, tag):
    """Rows where two (n, k) index lists differ must be near ties: at every
    position the float64 distances of the two train rows are within
    TIE_RTOL (relative). That covers a swap at the k-th place and a swap of
    two neighbours inside the list. Returns (rows that differ, the largest
    absolute float64 distance gap over them)."""
    rows = torch.nonzero((got != want).any(1)).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    xd, td = x[rows].double(), train.double()
    d_got = ((xd[:, None, :] - td[got[rows].long()]) ** 2).sum(-1)
    d_want = ((xd[:, None, :] - td[want[rows].long()]) ** 2).sum(-1)
    gap = (d_got - d_want).abs()
    rel = float((gap / torch.maximum(d_got, d_want).clamp_min(1e-30)).max())
    assert rel <= TIE_RTOL, (
        f"{tag}: {rows.numel()} rows differ and not at ties: relative gap {rel}")
    return rows.numel(), float(gap.max())


def check_knn(K, x, train, k, tag, block=16_384):
    """The kernel against its plain version, block by block (the plain
    version holds a (block, n_train) distance matrix)."""
    got = K.knn_topk_indices(x, train, k)
    kk = min(k, train.shape[0])
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], kk), tag
    assert torch.equal(got, K.knn_topk_indices(x, train, k)), (
        f"{tag}: rerun not bit-identical")
    flips, err = 0, 0.0
    for s in range(0, x.shape[0], block):
        want = K.knn_topk_indices_plain(x[s:s + block], train, k)
        f, e = knn_tie_check(x[s:s + block], train, got[s:s + block], want, tag)
        flips, err = flips + f, max(err, e)
    log(f"  knn_topk_indices {tag}: n={x.shape[0]} n_train={train.shape[0]} "
        f"d={x.shape[1]} k={kk} tie-rows={flips} max|dist gap|={err:.3g}")
    return got, flips, err


def knn_plan_line(K, x, nt, k):
    plan = K._knn_card_plan(x, nt, min(k, nt))
    return plan, (f"{plan.route}" + (
        f" kcap={plan.kcap} dpad={plan.dpad} splits={plan.splits} "
        f"smem={K.knn_tile_smem_bytes(plan.dpad)} B "
        f"scratch={plan.scratch_bytes} B"
        if plan.route == "tiled" else f" scratch={plan.scratch_bytes} B"))


def phase_knn_kernel(K):
    log("phase 6: the KNN kernels against their plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(13)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kcap in K.KNN_KCAPS:
        for dpad in (32, 128, 256):
            log(f"  knn_tile_kernel<{kcap}> at dpad={dpad}: "
                f"{K._knn_resident_blocks(0, kcap, dpad) // sms} block(s) "
                f"per SM ({K.knn_tile_smem_bytes(dpad)} bytes of shared "
                f"memory)")
    dup = rand(5_000, 32)
    dup[100:200] = dup[4_000:4_100]  # exact ties across train tiles
    dup_wide = rand(5_000, 160)
    dup_wide[100:200] = dup_wide[4_000:4_100]
    for n, train, k, tag in [
            (100_003, rand(5_000, 32), 10, "ragged-n"),
            (20_000, rand(50_001, 32), 10, "ragged-n_train"),
            (3_000, rand(7, 32), 10, "k>n_train"),
            (30_000, rand(20_000, 32), 1, "k=1"),
            (20_000, dup, 10, "duplicates"),
            (0, rand(1_000, 32), 10, "n=0"),
            (10_007, rand(9_999, 7), 10, "odd-d"),
            (4_000, rand(6_000, 64), 17, "d=64"),
            (4_000, rand(6_000, 128), 32, "d=128 k=32"),
            (3_000, rand(6_000, 256), 10, "d=256"),
            (2_000, rand(5_000, 769), 7, "odd d=769"),
            (3_000, rand(6_001, 32), 50, "wide k=50"),
            (1_000, rand(3_000, 200), 300, "wide d=200 k=300"),
            (500, rand(40, 300), 64, "wide k>n_train"),
            (5_000, dup_wide, 40, "wide duplicates"),
    ]:
        x = rand(n, train.shape[1])
        plan, line = knn_plan_line(K, x, train.shape[0], k)
        assert (plan.route == "wide") == tag.startswith("wide"), (tag, line)
        log(f"  plan {tag}: {line}")
        got, _, _ = check_knn(K, x, train, k, tag)
        if tag.endswith("duplicates"):
            # of two identical train rows, the lower index comes first
            rows, pos = torch.nonzero(got == 4_050, as_tuple=True)
            assert rows.numel() and bool((pos > 0).all()), tag
            assert bool((got[rows, pos - 1] == 150).all()), tag

    # the train split: small batches against the main path's train set;
    # a split run must equal the same rows in one split
    nt, d = 50_000, 32
    train = rand(nt, d)
    for n in (1_000, 16_384):
        x = rand(n, d)
        plan, line = knn_plan_line(K, x, nt, 10)
        log(f"  plan {n} x {nt}: {line}")
        got, _, _ = check_knn(K, x, train, 10, f"split n={n}")
        for splits in sorted({1, 2, 3} - {plan.splits}):
            assert torch.equal(got, K._launch_knn(x, train, 10, splits)), (
                f"n={n}: {splits} splits differ from {plan.splits}")
        if n == 1_000:
            assert plan.splits > 1, line
    # duplicate train rows on both sides of a split boundary: test rows
    # next to them take both twins, the lower index first
    x = rand(1_000, d)
    lo = K.knn_split_bounds(nt, K._knn_card_plan(x, nt, 10).splits)[1][0]
    twins = train.clone()
    twins[lo - 50:lo] = twins[lo:lo + 50]
    x[:50] = twins[lo:lo + 50] + 1e-3 * rand(50, d)
    got, _, _ = check_knn(K, x, twins, 10, "duplicates across a split")
    want = torch.stack([torch.arange(lo - 50, lo), torch.arange(lo, lo + 50)],
                       1).to(torch.int32).cuda()
    assert torch.equal(got[:50, :2], want), "twins across a split: order"
    # k larger than a split's rows: 148 train rows are two tiles, the second
    # of 20 rows, and 1,000 test rows split them
    x, small = rand(1_000, d), rand(148, d)
    plan, line = knn_plan_line(K, x, 148, 32)
    log(f"  plan k>split rows: {line}")
    assert plan.splits == 2, line
    check_knn(K, x, small, 32, "k>split rows")

    # times and bounds on a block of test rows the library call can hold,
    # at the main path's widths (50,000 train rows, d = 32, k = 10)
    n, nt, d, k = 16_384, 50_000, 32, 10
    x, train = rand(n, d), rand(nt, d)
    _, _, err = check_knn(K, x, train, k, "timed block")
    tsq = torch.sum(train * train, dim=1)
    b_ms, b_by = bound_ms(*K.launch_cost("knn_topk_indices", n=n, nt=nt, d=d,
                                         k=k))
    measured = {"knn_topk_indices": {
        "max_abs_err": err,
        "ms": time_ms(lambda: K.knn_topk_indices(x, train, k)),
        "plain_ms": time_ms(lambda: K.knn_topk_indices_plain(x, train, k),
                            batches=3, per_batch=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        # one PyTorch call's worth: the distance product and torch.topk
        # (no tie order promised)
        "library_ms": time_ms(lambda: torch.topk(
            torch.addmm(tsq, x, train.T, alpha=-2), k, largest=False)),
    }}
    log(f"  knn_topk_indices @ {n} x {nt} x {d}, k={k}: "
        f"{measured['knn_topk_indices']}")
    # the wide instance on the same block: k = 33 is past the tiled lists
    wide_ms = time_ms(lambda: K.knn_topk_indices(x, train, 33), batches=3,
                      per_batch=3, warmup=1)
    log(f"  knn_topk_indices wide instance @ {n} x {nt} x {d}, k=33: "
        f"{wide_ms:.3f} ms")
    # the main path's shape: a few calls, each of them about a second
    big = rand(10_000_000, d)
    main = time_ms(lambda: K.knn_topk_indices(big, train, k), batches=3,
                   per_batch=1, warmup=1)
    main_bound, _ = bound_ms(*K.launch_cost(
        "knn_topk_indices", n=big.shape[0], nt=nt, d=d, k=k))
    log(f"  knn_topk_indices @ 10,000,000 x {nt} x {d}: {main:.3f} ms "
        f"(bound {main_bound:.3f} ms by operations, "
        f"{main_bound / main:.1%} of it)")
    # the split at work: a serving-size batch and the block, planned and
    # forced into another number of splits
    for rows in (1_000, n):
        xs = x[:rows]
        plan = K._knn_card_plan(xs, nt, k)
        for splits in (plan.splits, 1 if plan.splits > 1 else 2):
            log(f"  knn_topk_indices @ {rows} x {nt} x {d}, {splits} "
                f"split(s){' (plan)' if splits == plan.splits else ''}: "
                + "%.4f ms" % time_ms(lambda: K._launch_knn(xs, train, k,
                                                           splits)))
    del big, x, train, dup, dup_wide
    torch.cuda.empty_cache()
    return measured


def check_segment(K, values, ids, u, tag):
    got = K.segment_reduce_sum(values, ids, u)
    want = K.segment_reduce_sum_plain(values, ids, u)
    assert got.shape == want.shape and got.dtype == torch.float32, tag
    assert torch.equal(got, K.segment_reduce_sum(values, ids, u)), (
        f"{tag}: rerun not bit-identical")
    err = within_sum_tol(got, want, tag)
    log(f"  segment_reduce_sum {tag}: n={values.shape[0]} "
        f"c={1 if values.ndim == 1 else values.shape[1]} u={u} "
        f"max|err|={err:.3g}")
    return err


def phase_segment_kernel(K):
    log("phase 7: the segment-sum kernel against its plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(17)

    def ids_in(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device="cuda",
                             dtype=torch.int32)

    def vals(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    past_grid = 65_535 * K.SEG_TILE_FLOATS + 4_097  # 65,537 tiles at c = 1
    hashed = {}
    for n, c, u, lo, hi, tag in [
            (1_000_003, 1, 1000, 0, 1000, "1-d ragged-n"),
            (500_000, 3, 777, 0, 777, "2-d"),
            (300_000, 2, 100, -1, 130, "-1 and out-of-range ids"),
            (0, 2, 100, 0, 100, "n=0"),
            (777, 1, 5, 0, 5, "one chunk"),
            (2_000_000, 1, 1 << 18, -5, (1 << 18) + 5, "hashed u=2^18"),
            (1_000_000, 2, 1 << 18, 0, 1 << 18, "hashed u=2^18 c=2"),
            (100_000, 1, past_grid, -5, past_grid + 5, "65,537 tiles"),
            (20_000, 5_000, 3, -1, 4, "c=5000 column groups"),
    ]:
        v = vals(n) if c == 1 else vals(n, c)
        ids = ids_in(lo, hi, n)
        check_segment(K, v, ids, u, tag)
        if tag.startswith("hashed"):
            hashed[tag] = (v, ids, u)  # timed below
        del v, ids
    torch.cuda.empty_cache()

    # the sparse FTRL path's shapes (one batch of 100,000 rows with 10
    # stored values each, packed to 1,048,576 slots): the per-row dots over
    # the packed row ids (ascending, ten a row, then id-0 padding whose
    # values are 0) and over sorted random row ids without padding, and the
    # per-coordinate gradient and weight sums
    nnz, rows_b, rows_s, d = 1 << 20, 100_000, 1 << 17, 100
    packed = torch.zeros(nnz, dtype=torch.int32, device="cuda")
    packed[:10 * rows_b] = torch.arange(
        rows_b, dtype=torch.int32, device="cuda").repeat_interleave(10)
    packed_v = vals(nnz)
    packed_v[10 * rows_b:] = 0.0
    sorted_ids = torch.sort(ids_in(0, rows_b, nnz)).values
    sorted_v = vals(nnz)
    col_ids, gw = ids_in(0, d, nnz), vals(nnz, 2)
    timed = {}
    for tag, v, ids, u in [("FTRL dots padded", packed_v, packed, rows_s),
                           ("FTRL dots sorted", sorted_v, sorted_ids, rows_s),
                           ("FTRL grad/wsum", gw, col_ids, d)]:
        err = check_segment(K, v, ids, u, tag)
        c = 1 if v.ndim == 1 else v.shape[1]
        library_ids = ids.long()  # every id of these shapes lies in [0, u)
        library_out = torch.zeros((u, c) if c > 1 else (u,), device="cuda")

        def library():
            return library_out.zero_().index_add_(0, library_ids, v)

        b_ms, b_by = bound_ms(*K.launch_cost("segment_reduce_sum",
                                             n=v.shape[0], c=c, u=u))
        timed[tag] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: K.segment_reduce_sum(v, ids, u)),
            "plain_ms": time_ms(lambda: K.segment_reduce_sum_plain(v, ids, u),
                                batches=3, per_batch=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library),
            "device_ms": graph_ms(lambda: K.segment_reduce_sum(v, ids, u)),
            "library_device_ms": graph_ms(library)}
        log(f"  segment_reduce_sum {tag} @ n={nnz}, c={c}, u={u}: "
            f"{timed[tag]}")
    for tag, (v, ids, u) in hashed.items():
        log(f"  segment_reduce_sum {tag}: device "
            + "%.5f ms, eager %.5f ms" % (
                graph_ms(lambda: K.segment_reduce_sum(v, ids, u)),
                time_ms(lambda: K.segment_reduce_sum(v, ids, u))))
    # the kernels line: the per-coordinate shape, the per-row dots beside
    measured = {"segment_reduce_sum": {**timed["FTRL grad/wsum"],
                                       "per_row_dots": timed["FTRL dots padded"]}}
    return measured


def phase_knn_main_path(K, runner, Table):
    from flink_ml_tpu_torch.models.classification import Knn, knn as knn_mod

    log("phase 8: the KNN main path through the port's entry points")
    spec = runner.load_config(str(KNN_CONFIG))["KnnModel-predict"]
    n = spec["inputData"]["paramMap"]["numValues"]
    k = spec["stage"]["paramMap"]["k"]

    K.reset_launch_counts()
    row = runner.best_of("KnnModel-predict", spec, runs=2)
    log("  benchmark row:", json.dumps(row, sort_keys=True))
    assert row["executionPath"] == "cuda-knn", row["executionPath"]
    assert row["inputRecordNum"] == n and row["outputRecordNum"] == n

    table = runner.build_generator(spec).get_data()
    model = runner.build_stage(spec).set_model_data(
        runner.build_generator(spec, key="modelData").get_data())
    torch.cuda.synchronize()
    start = time.perf_counter()
    pred = model.transform(table)[0][model.prediction_col]
    torch.cuda.synchronize()
    transform_ms = (time.perf_counter() - start) * 1e3
    assert model.last_execution_path == "cuda-knn"
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0][loaded.prediction_col]
    assert torch.equal(pred, again), "the loaded model predicts otherwise"
    counts = dict(K.launch_counts)
    log(f"  transform: {transform_ms:.3f} ms for {n} rows; save/load: same "
        "predictions")
    log(f"  launches in the main-path run: {counts}")

    # is the output right: labels from the model data, and the predictions
    # of the plain version on blocks at the start, middle and ragged end
    labels = torch.as_tensor(np.unique(model.labels), device="cuda")
    assert pred.shape == (n,) and bool(torch.isin(pred, labels).all())
    x = table.vectors(model.features_col)
    train = torch.as_tensor(model.features, dtype=torch.float32, device="cuda")
    _, label_idx = np.unique(model.labels, return_inverse=True)
    label_idx = torch.as_tensor(label_idx, device="cuda")
    checked = flips = 0
    for lo, hi in [(0, 40_000), (n // 2 - 20_000, n // 2 + 20_000),
                   (n - 33_333, n)]:
        got = K.knn_topk_indices(x[lo:hi], train, k)
        want = torch.cat([K.knn_topk_indices_plain(x[s:min(s + 16_384, hi)],
                                                   train, k)
                          for s in range(lo, hi, 16_384)])
        f, _ = knn_tie_check(x[lo:hi], train, got, want, f"rows {lo}:{hi}")
        vote = knn_mod._vote(got, label_idx, len(labels))
        assert torch.equal(pred[lo:hi], labels.double()[vote]), (
            f"rows {lo}:{hi}: transform differs from its kernel's neighbours")
        plain_vote = knn_mod._vote(want, label_idx, len(labels))
        differ = int((vote != plain_vote).sum())
        assert differ <= f, f"rows {lo}:{hi}: {differ} votes off the plain ones"
        checked += hi - lo
        flips += f
    log(f"  {checked} predictions against the plain version: tie-rows={flips}")
    del x, table, pred, again
    torch.cuda.empty_cache()

    # small models give the same predictions on the card and on the CPU
    # (blobs far apart: no row near a tie)
    rng = np.random.default_rng(5)
    for d, k in [(9, 7), (300, 40)]:  # the tiled and the wide instance
        centers = rng.normal(size=(4, d)) * 10
        which = rng.integers(0, 4, 600)
        xs = centers[which] + rng.normal(size=(600, d))
        small = Table.from_columns(features=xs, label=which * 2.5 - 1.0)
        test = Table.from_columns(features=centers[rng.integers(0, 4, 300)]
                                  + rng.normal(size=(300, d)))
        preds = {}
        for dev in ("cuda", "cpu"):
            m = Knn(k=k, device=dev).fit(small)
            preds[dev] = m.transform(test)[0]["prediction"].cpu()
            assert m.last_execution_path == (
                "cuda-knn" if dev == "cuda" else "torch-knn")
        assert torch.equal(preds["cuda"], preds["cpu"]), (d, k)
    log("  small models (d = 9, k = 7; d = 300, k = 40): card and CPU agree")
    assert counts["knn_topk_indices"] >= 3 + 2, counts  # runs + transforms
    return counts


def _sparse_stream(Table, sparse, n, d, nnz_per_row, seed, striped=False):
    """n rows of nnz_per_row stored values at seeded distinct columns of d,
    labels from a seeded hyperplane, weights in [0.5, 1.5). ``striped``
    draws the j-th column of a row from the j-th of nnz_per_row equal
    stripes of d, which keeps a wide domain's draw small."""
    rng = np.random.default_rng(seed)
    if striped:
        stripe = d // nnz_per_row
        cols = (rng.integers(0, stripe, (n, nnz_per_row))
                + np.arange(nnz_per_row) * stripe)
    else:
        cols = np.sort(rng.random((n, d), dtype=np.float32)
                       .argpartition(nnz_per_row, axis=1)[:, :nnz_per_row],
                       axis=1)
    values = rng.normal(size=(n, nnz_per_row))
    truth = rng.normal(size=d)
    y = ((values * truth[cols]).sum(1) > 0).astype(np.float64)
    import scipy.sparse as sp

    x = sp.csr_matrix((values.ravel(), cols.ravel().astype(np.int32),
                       np.arange(0, n * nnz_per_row + 1, nnz_per_row)),
                      shape=(n, d))
    return Table.from_columns(features=sparse.CsrVectorColumn(x), label=y,
                              weight=rng.random(n) + 0.5)


def phase_ftrl_main_path(K, runner, Table):
    from flink_ml_tpu_torch.iteration import streaming
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.models import online

    log("phase 9: the FTRL main path through the port's entry points")
    spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
    n = spec["inputData"]["paramMap"]["numValues"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    batch = spec["stage"]["paramMap"]["globalBatchSize"]

    K.reset_launch_counts()
    row = runner.best_of("OnlineLogisticRegression", spec, runs=2)
    log("  benchmark row:", json.dumps(row, sort_keys=True))
    assert row["executionPath"] == "torch-dense-batches", row["executionPath"]
    assert row["inputRecordNum"] == n and row["outputRecordNum"] == 1

    # the sparse stream: the config's widths and params, 10 stored values a
    # row; every batch runs the segment kernel
    stream = _sparse_stream(Table, sparse, 2_000_000, d, 10, seed=23)

    def sparse_fit():
        est = runner.build_stage(spec).warm_start(np.zeros(d))
        torch.cuda.synchronize()
        start = time.perf_counter()
        model = est.fit(stream)
        torch.cuda.synchronize()
        return model, est.last_execution_path, (time.perf_counter() - start) * 1e3

    sparse_model, path, sparse_ms = sparse_fit()
    counts = dict(K.launch_counts)
    log(f"  sparse stream fit: {sparse_ms:.3f} ms for 2,000,000 rows "
        f"({path}, version {sparse_model.model_version})")
    log(f"  launches in the main-path run: {counts}")
    assert path == "cuda-csr-batches", path
    assert sparse_model.model_version == 2_000_000 // batch
    # where the sparse fit's time goes: the host's batching and packing
    # alone, and the packed batches' copies to the card
    start = time.perf_counter()
    packed = []
    for b in streaming.generate_batches(
            streaming.StreamTable.from_table(stream, batch), batch):
        x = sparse.features_matrix(b, "features")
        packed.append(online._pack_csr_shards(
            x, b.scalars("label", np.float64),
            b.scalars("weight", np.float64), 1))
    pack_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    for p in packed:
        [torch.as_tensor(a[0], device="cuda") for a in p]
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - start) * 1e3
    log(f"  of which host batching and packing alone: {pack_ms:.3f} ms; "
        f"copies of the packed batches to the card: {copy_ms:.3f} ms")
    del packed

    # is the output right: the sparse fit reruns to the same bits and
    # matches the float64 host engine on the same stream
    again, _, _ = sparse_fit()
    assert np.array_equal(again.coefficients, sparse_model.coefficients), (
        "the sparse fit differs on a rerun")
    threshold = online.FTRL_SPARSE_MIN_NNZ
    online.FTRL_SPARSE_MIN_NNZ = 1 << 62
    try:
        host, host_path, host_ms = sparse_fit()
    finally:
        online.FTRL_SPARSE_MIN_NNZ = threshold
    assert host_path == "host-csr-batches", host_path
    diff = np.abs(sparse_model.coefficients - host.coefficients)
    log(f"  against the host engine ({host_ms:.3f} ms): "
        f"max|coeff diff|={diff.max():.3g} (max|coeff|="
        f"{np.abs(host.coefficients).max():.3g})")
    assert np.all(diff <= CSR_RTOL * np.abs(host.coefficients) + CSR_ATOL)
    for (va, a), (vb, b) in zip(sparse_model.history, host.history):
        assert va == vb
        assert np.all(np.abs(a - b) <= CSR_RTOL * np.abs(b) + CSR_ATOL)
    out = sparse_model.transform(stream)[0]
    assert isinstance(out["prediction"], np.ndarray)
    accuracy = float((out["prediction"] == stream.scalars("label",
                                                          np.float64)).mean())
    log(f"  sparse model accuracy on its stream: {accuracy:.4f}")
    assert accuracy > 0.85, accuracy
    del stream, out

    # a hashed 2^18 domain: the per-coordinate sums take 128 segment tiles
    # on the card, and the fit still matches the host engine
    wide_d = 1 << 18
    wide = _sparse_stream(Table, sparse, 4 * batch, wide_d, 10, seed=31,
                          striped=True)
    wide_fits = {}
    for name, floor in [("card", threshold), ("host", 1 << 62)]:
        online.FTRL_SPARSE_MIN_NNZ = floor
        try:
            e = runner.build_stage(spec).warm_start(np.zeros(wide_d))
            wide_fits[name] = (e.fit(wide).coefficients, e.last_execution_path)
        finally:
            online.FTRL_SPARSE_MIN_NNZ = threshold
    assert wide_fits["card"][1] == "cuda-csr-batches", wide_fits["card"][1]
    assert wide_fits["host"][1] == "host-csr-batches", wide_fits["host"][1]
    card_c, host_c = wide_fits["card"][0], wide_fits["host"][0]
    diff = np.abs(card_c - host_c)
    log(f"  hashed 2^18 domain, {4 * batch} rows: max|coeff diff| against "
        f"the host engine={diff.max():.3g} (max|coeff|="
        f"{np.abs(host_c).max():.3g}, {int((host_c != 0).sum())} nonzero)")
    assert np.all(diff <= CSR_RTOL * np.abs(host_c) + CSR_ATOL)
    del wide

    # the dense fit on the config's table: version, history, transform,
    # save/load. Its labels are independent of its features, so l1 holds
    # every coefficient at 0; the same fit on labels from a hyperplane
    # learns, and is held against the CPU
    table = runner.build_generator(spec).get_data()
    est = runner.build_stage(spec).set_initial_model_data(
        runner.build_generator(spec, key="modelData").get_data())
    model = est.fit(table)
    assert est.last_execution_path == "torch-dense-batches"
    assert model.model_version == n // batch and len(model.history) == n // batch
    assert np.isfinite(model.coefficients).all()
    truth = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(29),
                        device="cuda")
    x = table.column("features")
    margin = x @ truth
    learnable = table.with_column(
        "label", (margin > margin.median()).to(torch.float32))
    fits = {}
    for dev in ("cuda", "cpu"):
        t = learnable if dev == "cuda" else Table.from_columns(
            **{c: learnable.column(c).cpu() for c in learnable.column_names})
        e = runner.build_stage(spec, device=dev).warm_start(np.zeros(d))
        fits[dev] = e.fit(t).coefficients
        del t
    diff = np.abs(fits["cuda"] - fits["cpu"])
    log(f"  dense fit on hyperplane labels against the CPU: max|coeff diff|="
        f"{diff.max():.3g} (max|coeff|={np.abs(fits['cpu']).max():.3g}, "
        f"{int((fits['cpu'] != 0).sum())} of {d} nonzero)")
    assert np.abs(fits["cpu"]).max() > 0.01
    assert np.all(diff <= BIG_FIT_RTOL * np.abs(fits["cpu"]) + BIG_FIT_ATOL)
    del x, margin, learnable
    torch.cuda.synchronize()
    start = time.perf_counter()
    pred = model.transform(table)[0]
    torch.cuda.synchronize()
    transform_ms = (time.perf_counter() - start) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0]
    assert torch.equal(pred[model.prediction_col], again[loaded.prediction_col])
    assert bool(torch.isfinite(pred[model.raw_prediction_col]).all())
    assert int(pred[model.model_version_col][0]) == n // batch
    log(f"  FTRL transform: {transform_ms:.3f} ms for {n} rows; save/load: "
        "same predictions")
    del table, pred, again
    torch.cuda.empty_cache()

    # small dense fits give the same model on the card and on the CPU
    small = _small_linear_table(Table, 31, 600, 7, False)
    fitted = {}
    for dev in ("cuda", "cpu"):
        e = online.OnlineLogisticRegression(
            device=dev, global_batch_size=100, reg=0.05, elastic_net=0.3,
            weight_col="weight").warm_start(np.zeros(7))
        fitted[dev] = e.fit(small).coefficients
    np.testing.assert_allclose(fitted["cuda"], fitted["cpu"],
                               rtol=SMALL_RTOL, atol=SMALL_ATOL)
    log("  small dense fits: card and CPU agree")
    batches = 2_000_000 // batch
    # two segment calls a batch, each one C entry with its own second stage
    assert counts["segment_reduce_sum"] >= 2 * batches, counts
    assert counts["reduce_partials"] == 0, counts
    return counts


def _checkpoint_stats(CheckpointManager):
    """A CheckpointManager that times its saves and restores and records
    the bytes of the leaves each one moved."""

    class Timed(CheckpointManager):
        def __init__(self, base_dir):
            super().__init__(base_dir)
            self.saves, self.restores = [], []

        def save(self, carry, epoch, extras=None):
            start = time.perf_counter()
            path = super().save(carry, epoch, extras)
            self.saves.append((epoch, (time.perf_counter() - start) * 1e3,
                               _nbytes(carry)))
            return path

        def restore(self, template_carry):
            start = time.perf_counter()
            restored = super().restore(template_carry)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            self.restores.append(
                (None, ms, 0) if restored is None
                else (restored[1], ms, _nbytes(restored[0])))
            return restored

    return Timed


def _nbytes(tree):
    """Bytes of a carry's leaves (tensors and numpy arrays in tuples)."""
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(child) for child in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return np.asarray(tree).nbytes


def _host_split(run, wraps):
    """``run()`` with each named callable of ``wraps`` ([(name, owner,
    attribute)]) wrapped for the run only → (run's result, {name: [host ms,
    calls]})."""
    spent = {name: [0.0, 0] for name, _, _ in wraps}
    undo = []
    for name, owner, attr in wraps:
        real = getattr(owner, attr)

        def timed(*args, _real=real, _name=name, **kwargs):
            start = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                spent[_name][0] += (time.perf_counter() - start) * 1e3
                spent[_name][1] += 1

        setattr(owner, attr, timed)
        undo.append((owner, attr, real))
    try:
        return run(), spent
    finally:
        for owner, attr, real in reversed(undo):
            setattr(owner, attr, real)


def phase_iteration_modes(K, runner, Table):
    """Phase 10: the iteration runtime's modes on the card at the LR and
    KMeans benchmark configs' full size, each held bit for bit against the
    all-device fit of the same table."""
    from flink_ml_tpu_torch.iteration import checkpoint, iteration
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.resilience import InjectedFault, RetryPolicy, faults

    log("phase 10: iteration modes on the card")
    Timed = _checkpoint_stats(CheckpointManager)
    fetches = []
    real_read_boundary = iteration.read_boundary

    def counting_read_boundary(boundary):
        assert isinstance(boundary, torch.Tensor) and boundary.shape == (2,)
        fetches.append(1)
        return real_read_boundary(boundary)

    class CountingPlan(faults.FaultPlan):
        """A fault plan that also counts every boundary it is asked about."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.boundaries = 0

        def decide(self, site):
            self.boundaries += site == "epoch-boundary"
            return super().decide(site)

    class Epochs(iteration.IterationListener):
        def __init__(self):
            self.epochs = []

        def on_epoch_watermark_incremented(self, epoch, carry):
            self.epochs.append(epoch)

    def timed_fit(est, table):
        torch.cuda.synchronize()
        start = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        return model, (time.perf_counter() - start) * 1e3

    iteration.read_boundary = counting_read_boundary
    K.reset_launch_counts()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_iteration_")
    summary = {}
    try:
        cases = [
            ("LR", runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))
             ["logisticregression"], 5, ("sgd_batch_terms",), "cuda-sgd"),
            ("KMeans", runner.load_config(str(CONFIG))["KMeans"], 3,
             ("lloyd_partial_sums", "reduce_partials"), "cuda-lloyd"),
        ]
        for name, spec, k, kernels_of_fit, path in cases:
            table = runner.build_generator(spec).get_data()
            max_iter = spec["stage"]["paramMap"]["maxIter"]
            n = table.num_rows
            boundaries = -(-max_iter // k)

            def result(model):
                return (model.coefficients if name == "LR"
                        else np.concatenate([model.centroids.ravel(),
                                             model.weights]))

            plain_est = runner.build_stage(spec)
            plain, _ = timed_fit(plain_est, table)
            plain_ms = min(timed_fit(runner.build_stage(spec), table)[1]
                           for _ in range(2))
            assert plain_est.last_execution_path == path
            want = result(plain)
            if name == "KMeans":
                want_labels = plain.transform(table)[0][plain.prediction_col]

            def check_mode(tag, model, est, before, plan, fit_ms, expect_path):
                launched = {kern: K.launch_counts[kern] - before[kern]
                            for kern in K.launch_counts}
                assert est.last_execution_path == expect_path, (
                    tag, est.last_execution_path)
                assert np.array_equal(result(model), want), (
                    f"{name} {tag}: differs from the all-device fit")
                for kern in kernels_of_fit:
                    assert launched[kern] >= max_iter, (tag, launched)
                if name == "KMeans":
                    labels = model.transform(table)[0][model.prediction_col]
                    assert torch.equal(labels, want_labels), tag
                log(f"  {name} {tag}: fit {fit_ms:.3f} ms against the "
                    f"all-device fit's {plain_ms:.3f} ms ({n} rows, "
                    f"{max_iter} rounds); boundaries {plan.boundaries}; "
                    f"launches { {k: v for k, v in launched.items() if v} }; "
                    "bit-identical")
                return launched

            # (a) K-round segments between checkpoints
            runs = []
            for attempt in range(2):
                mgr = Timed(f"{workdir}/{name}-segments-{attempt}")
                est = runner.build_stage(spec).set_iteration_config(
                    iteration.IterationConfig(checkpoint_interval=k,
                                              checkpoint_manager=mgr))
                before, seg_fetches = dict(K.launch_counts), len(fetches)
                with faults.chaos(plan=CountingPlan()) as plan:
                    model, fit_ms = timed_fit(est, table)
                runs.append((fit_ms, mgr, len(fetches) - seg_fetches, plan))
                launched = check_mode(f"segments (K={k})", model, est, before,
                                      plan, fit_ms, path + "-segments")
            fit_ms, mgr, seg_fetches, plan = min(runs, key=lambda r: r[0])
            assert plan.boundaries == boundaries and seg_fetches == boundaries, (
                plan.boundaries, seg_fetches)
            saves = mgr.saves
            assert [e for e, _, _ in saves] == [
                k * i for i in range(1, boundaries) if k * i < max_iter], saves
            assert mgr.list_checkpoints() == []
            log(f"  {name} segments: boundary fetches {seg_fetches} for "
                f"{boundaries} boundaries; checkpoint saves {len(saves)}, "
                f"ms {[round(ms, 3) for _, ms, _ in saves]}, "
                f"{saves[0][2]} bytes of leaves each")
            summary[name] = {"segments_ms": fit_ms, "plain_ms": plain_ms,
                             "boundaries": boundaries,
                             "fetches": seg_fetches,
                             "save_ms": statistics.median(
                                 ms for _, ms, _ in saves),
                             "save_bytes": saves[0][2]}

            # where a boundary's time goes: the host clock around each call
            # the segment driver makes there, on one more segment fit
            mgr = Timed(f"{workdir}/{name}-split")
            est = runner.build_stage(spec).set_iteration_config(
                iteration.IterationConfig(checkpoint_interval=k,
                                          checkpoint_manager=mgr))
            (model, split_fit_ms), spent = _host_split(
                lambda: timed_fit(est, table), [
                    ("fetch", iteration, "read_boundary"),
                    ("save", mgr, "save"), ("fsync", checkpoint.os, "fsync"),
                    ("npz", checkpoint.np, "savez"), ("gc", mgr, "_gc"),
                    ("restore", mgr, "restore"), ("clear", mgr, "clear")])
            assert np.array_equal(result(model), want), "split run differs"
            assert spent["fetch"][1] == boundaries, spent
            rest = split_fit_ms - sum(spent[part][0] for part in
                                      ("fetch", "save", "restore", "clear"))
            split = {part: round(ms, 4) for part, (ms, _) in spent.items()}
            split.update(fit=round(split_fit_ms, 4), rest=round(rest, 4))
            log(f"  {name} boundary split (host ms over {boundaries} "
                f"boundaries, {len(mgr.saves)} saves; fsync, npz and gc are "
                f"inside save; rest = fit - fetch - save - restore - clear): "
                f"{json.dumps(split, sort_keys=True)}; fsync calls "
                f"{spent['fsync'][1]}")
            summary[name]["split_ms"] = split

            # (b) host rounds with a listener
            listener = Epochs()
            est = runner.build_stage(spec).set_iteration_config(
                iteration.IterationConfig(mode="host"), listeners=[listener])
            before, host_fetches = dict(K.launch_counts), len(fetches)
            with faults.chaos(plan=CountingPlan()) as plan:
                model, fit_ms = timed_fit(est, table)
            check_mode("host rounds", model, est, before, plan, fit_ms,
                       path + "-rounds")
            assert listener.epochs == list(range(max_iter)), listener.epochs
            assert len(fetches) == host_fetches  # a round's stop, not a segment
            summary[name]["rounds_ms"] = fit_ms

            # (c) supervised: a fault at the second boundary, a restart from
            # the first boundary's checkpoint
            mgr = Timed(f"{workdir}/{name}-chaos")
            est = (runner.build_stage(spec)
                   .set_iteration_config(iteration.IterationConfig(
                       checkpoint_interval=k, checkpoint_manager=mgr))
                   .set_retry_policy(RetryPolicy(backoff_s=0)))
            before = dict(K.launch_counts)
            with faults.chaos(plan=CountingPlan(at={"epoch-boundary": [2]})
                              ) as plan:
                model, fit_ms = timed_fit(est, table)
            check_mode("supervised chaos", model, est, before, plan, fit_ms,
                       path + "-segments")
            restarts = len(mgr.restores) - 1
            resumed = [r for r in mgr.restores if r[0] is not None]
            assert restarts == 1 and len(resumed) == 1, mgr.restores
            assert resumed[0][0] == k, resumed
            assert plan.boundaries == boundaries + 1, plan.boundaries
            log(f"  {name} supervised chaos: restarts {restarts}, resumed "
                f"from epoch {resumed[0][0]}; restore {resumed[0][1]:.3f} ms, "
                f"{resumed[0][2]} bytes of leaves")
            summary[name].update(chaos_ms=fit_ms, restarts=restarts,
                                 restore_ms=resumed[0][1],
                                 restore_bytes=resumed[0][2])
            del table
            torch.cuda.empty_cache()

        # FTRL's sparse stream (phase 9's) with a checkpoint every 5
        # batches: a due save takes the state to the host and the next
        # batch places it again. A fault at the third save ends a fit,
        # which resumes from the second save on the rest of the stream. Both
        # end with the bytes of the stream without checkpoints.
        spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
        d = spec["inputData"]["paramMap"]["vectorDim"]
        batch = spec["stage"]["paramMap"]["globalBatchSize"]
        stream = _sparse_stream(Table, sparse, 2_000_000, d, 10, seed=23)
        batches, interval = stream.num_rows // batch, 5

        def ftrl_fit(rows, config=None):
            est = runner.build_stage(spec).warm_start(np.zeros(d))
            if config is not None:
                est.set_iteration_config(config)
            before = K.launch_counts["segment_reduce_sum"]
            model, fit_ms = timed_fit(est, rows)
            assert est.last_execution_path == "cuda-csr-batches", (
                est.last_execution_path)
            launched = K.launch_counts["segment_reduce_sum"] - before
            assert launched >= 2 * (rows.num_rows // batch), launched
            return model, fit_ms

        def assert_same(tag, model, clean):
            assert np.array_equal(model.coefficients, clean.coefficients), tag
            assert model.model_version == clean.model_version == batches, tag
            assert len(model.history) == len(clean.history), tag
            for (va, a), (vb, b) in zip(model.history, clean.history):
                assert va == vb and np.array_equal(a, b), (tag, va, vb)

        clean, clean_ms = ftrl_fit(stream)
        saved_mgr = Timed(f"{workdir}/FTRL")
        saved, saved_ms = ftrl_fit(stream, iteration.IterationConfig(
            checkpoint_interval=interval, checkpoint_manager=saved_mgr))
        assert_same("FTRL checkpointed", saved, clean)
        assert [e for e, _, _ in saved_mgr.saves] == list(
            range(interval, batches + 1, interval)), saved_mgr.saves
        assert saved_mgr.list_checkpoints() == []
        mgr = Timed(f"{workdir}/FTRL-crash")
        config = iteration.IterationConfig(checkpoint_interval=interval,
                                           checkpoint_manager=mgr)
        crashed = runner.build_stage(spec).warm_start(np.zeros(d))
        crashed.set_iteration_config(config)
        with faults.chaos(at={"checkpoint-save": [3]}):
            try:
                crashed.fit(stream)
                raise AssertionError("FTRL: the fault at the third save "
                                     "did not end the fit")
            except InjectedFault:
                pass
        assert mgr.list_checkpoints() == [f"ckpt-{interval:08d}",
                                          f"ckpt-{2 * interval:08d}"]
        resumed, resumed_ms = ftrl_fit(
            stream.take(slice(2 * interval * batch, None)), config)
        assert_same("FTRL resumed", resumed, clean)
        restored = [r for r in mgr.restores if r[0] is not None]
        assert [r[0] for r in restored] == [2 * interval], mgr.restores
        assert mgr.list_checkpoints() == []
        log(f"  FTRL sparse stream ({stream.num_rows} rows, {batches} "
            f"batches): {clean_ms:.3f} ms without checkpoints, "
            f"{saved_ms:.3f} ms with a save every {interval} batches (saves "
            f"ms {[round(ms, 3) for _, ms, _ in saved_mgr.saves]}, bytes "
            f"{[b for _, _, b in saved_mgr.saves]}); resumed from batch "
            f"{restored[0][0]} on the last {batches - 2 * interval} batches "
            f"in {resumed_ms:.3f} ms, restore {restored[0][1]:.3f} ms, "
            f"{restored[0][2]} bytes; both bit-identical")
        summary["FTRL"] = {"plain_ms": clean_ms, "checkpointed_ms": saved_ms,
                           "resumed_ms": resumed_ms,
                           "restore_ms": restored[0][1],
                           "restore_bytes": restored[0][2]}
        del stream
    finally:
        iteration.read_boundary = real_read_boundary
        shutil.rmtree(workdir, ignore_errors=True)
    counts = dict(K.launch_counts)
    log(f"  launches in the iteration-modes run: {counts}")
    log("  iteration modes:", json.dumps(summary, sort_keys=True))
    for kern in PATH_KERNELS["iteration"]:
        assert counts[kern] >= 1, counts
    return counts


def _timed_fit(est, table):
    """(model, ms): host clock around ``est.fit`` ended by a synchronize."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    return model, (time.perf_counter() - start) * 1e3


def phase_parallel(K, runner, optimizer, Table):
    """Phase 11: the data-parallel layer on the card: the LR, KMeans and
    FTRL fits on one shard and on eight virtual shards of the card, with
    the replicated and the sharded update, a segmented LR fit resumed after
    a fault, and an LR fit through torch.distributed (NCCL, world size
    1)."""
    from flink_ml_tpu_torch.iteration import iteration
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.parallel import (create_mesh, init_distributed,
                                             shutdown_distributed)
    from flink_ml_tpu_torch.parallel import update_sharding as upd
    from flink_ml_tpu_torch.resilience import RetryPolicy, faults

    log("phase 11: the data-parallel layer on the card")
    card = torch.device("cuda")
    meshes = {None: None, 1: create_mesh((1,), devices=[card]),
              8: create_mesh((8,), devices=[card] * 8)}
    K.reset_launch_counts()
    summary = {}

    def fit(spec, table, p, sharded=False, reps=2, setup=None):
        """The spec's estimator on ``p`` shards (None: no mesh asked for),
        fitted ``reps`` times → (model, best ms, launches of one fit)."""
        runs = []
        with mock.patch.dict(os.environ, {upd.ENV: str(int(sharded))}):
            for _ in range(reps):
                est = runner.build_stage(spec, mesh=meshes[p])
                if setup is not None:
                    est = setup(est)
                before = dict(K.launch_counts)
                model, ms = _timed_fit(est, table)
                runs.append((ms, model, {k: K.launch_counts[k] - before[k]
                                         for k in K.launch_counts}))
        ms, model, launched = min(runs, key=lambda r: r[0])
        return model, ms, {k: v for k, v in launched.items() if v}

    def same(a, b):
        return bool(np.array_equal(a, b))

    # (a) LR at full size: no mesh, one shard, eight shards replicated and
    # sharded, then the segmented fit resumed after a fault and NCCL
    spec = runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))[
        "logisticregression"]
    max_iter = spec["stage"]["paramMap"]["maxIter"]
    gb = spec["stage"]["paramMap"]["globalBatchSize"]
    table = runner.build_generator(spec).get_data()
    nomesh, nomesh_ms, _ = fit(spec, table, None)
    one, one_ms, one_l = fit(spec, table, 1)
    assert same(one.coefficients, nomesh.coefficients), (
        "LR on one shard differs from the fit with no mesh")
    assert one_l == {"sgd_batch_terms": max_iter}, one_l
    rep, rep_ms, rep_l = fit(spec, table, 8)
    assert rep_l == {"sgd_batch_terms": 8 * max_iter,
                     "reduce_partials": max_iter}, rep_l
    sh, sh_ms, sh_l = fit(spec, table, 8, sharded=True)
    assert sh_l == {"sgd_batch_terms": 8 * max_iter,
                    "reduce_partials": 2 * max_iter}, sh_l
    np.testing.assert_allclose(sh.coefficients, rep.coefficients, rtol=1e-5)
    # the eight-shard fit against its plain rounds on the card (launches of
    # the comparison are not the path's)
    saved = dict(K.launch_counts)
    est = runner.build_stage(spec)
    x, y = table.vectors(est.features_col), table.column(est.label_col)
    prm = optimizer.SGDParams(
        learning_rate=est.learning_rate, global_batch_size=gb,
        max_iter=max_iter, tol=est.tol, reg=est.reg,
        elastic_net=est.elastic_net)
    plain, _, _ = optimizer.sgd_rounds(
        K.sgd_batch_terms_plain, "logistic", prm, x, y,
        torch.ones(table.num_rows, device=card), torch.zeros(
            x.shape[1], device=card), mesh=meshes[8])
    K.launch_counts.update(saved)
    plain = plain.double().cpu().numpy()
    diff = np.abs(rep.coefficients - plain)
    assert np.all(diff <= COEFF_RTOL * np.abs(plain) + COEFF_ATOL), diff.max()
    log(f"  LR ({table.num_rows} x {x.shape[1]}, {max_iter} rounds, global "
        f"batch {gb}, {gb // 8} rows a shard on 8): fit ms no mesh "
        f"{nomesh_ms:.3f}, 1 shard {one_ms:.3f} (bit-identical), 8 shards "
        f"{rep_ms:.3f}, 8 sharded {sh_ms:.3f} (bit-identical to replicated: "
        f"{same(sh.coefficients, rep.coefficients)}); launches 1 shard "
        f"{one_l}, 8 shards {rep_l}, 8 sharded {sh_l}; 8 shards against "
        f"their plain rounds max|diff|={diff.max():.3g}, against 1 shard "
        f"max|diff|={np.abs(rep.coefficients - one.coefficients).max():.3g}")
    summary["LR"] = {"nomesh_ms": nomesh_ms, "p1_ms": one_ms, "p8_ms": rep_ms,
                     "p8_sharded_ms": sh_ms, "p1_launches": one_l,
                     "p8_launches": rep_l, "p8_sharded_launches": sh_l}

    # segments: K = 5 with a fault at the second boundary, resumed by the
    # supervisor from the first boundary's checkpoint, bit for bit the
    # eight-shard all-device fit; replicated sgd, and sharded adam (its
    # moments are Sharded leaves of the checkpoint)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        for tag, sharded, method in [("replicated", False, "sgd"),
                                     ("sharded adam", True, "adam")]:
            def optimizer_of(est, method=method):
                est.optimizer = method
                return est

            want = rep.coefficients if method == "sgd" else fit(
                spec, table, 8, sharded, 1, optimizer_of)[0].coefficients
            mgr = CheckpointManager(f"{workdir}/{method}")

            def segmented(est, mgr=mgr, method=method):
                est.optimizer = method
                return (est.set_iteration_config(iteration.IterationConfig(
                    checkpoint_interval=5, checkpoint_manager=mgr))
                    .set_retry_policy(RetryPolicy(backoff_s=0)))

            with faults.chaos(at={"epoch-boundary": [2]}):
                got, seg_ms, seg_l = fit(spec, table, 8, sharded, 1,
                                         segmented)
            assert same(got.coefficients, want), f"LR segments {tag} differ"
            assert mgr.list_checkpoints() == []
            log(f"  LR 8-shard segments (K=5, {tag}), a fault at boundary "
                f"2 resumed: {seg_ms:.3f} ms, bit-identical to the "
                f"all-device fit; launches {seg_l}")
            summary["LR"][f"segments_{method}_ms"] = seg_ms
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # torch.distributed: NCCL at world size 1, the default mesh one shard
    # per rank; bit for bit the one-shard in-process fit
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        init_distributed(init_method=f"file://{rendezvous}/store",
                         world_size=1, rank=0, device=card)
        import torch.distributed as dist

        assert dist.get_backend() == "nccl"
        nccl, nccl_ms, nccl_l = fit(spec, table, None)
    finally:
        shutdown_distributed()
        shutil.rmtree(rendezvous, ignore_errors=True)
    assert same(nccl.coefficients, one.coefficients), (
        "LR through NCCL differs from the one-shard fit")
    log(f"  LR through torch.distributed (NCCL, world size 1): {nccl_ms:.3f} "
        f"ms, bit-identical to 1 shard; launches {nccl_l}")
    summary["LR"]["nccl_ms"] = nccl_ms
    del table, x, y
    torch.cuda.empty_cache()

    # (b) KMeans at full size on 1 and 8 shards
    spec = runner.load_config(str(CONFIG))["KMeans"]
    max_iter = spec["stage"]["paramMap"]["maxIter"]
    table = runner.build_generator(spec).get_data()
    n = table.num_rows
    one, one_ms, one_l = fit(spec, table, 1)
    assert one_l == {"lloyd_partial_sums": max_iter,
                     "reduce_partials": max_iter}, one_l
    rep, rep_ms, rep_l = fit(spec, table, 8)
    # per shard a Lloyd call (two stages), then the cross-shard sum
    assert rep_l == {"lloyd_partial_sums": 8 * max_iter,
                     "reduce_partials": 9 * max_iter}, rep_l
    sh, sh_ms, sh_l = fit(spec, table, 8, sharded=True)
    assert sh_l == rep_l, sh_l
    np.testing.assert_allclose(sh.centroids, rep.centroids, rtol=1e-5)
    assert same(sh.weights, rep.weights)
    x = table.vectors(runner.build_stage(spec).features_col)
    diff = float(np.abs(rep.centroids - one.centroids).max())
    c8 = torch.as_tensor(rep.centroids, dtype=torch.float32, device=card)
    c1 = torch.as_tensor(one.centroids, dtype=torch.float32, device=card)
    agree = float((K.assign_nearest_plain(x, c8)
                   == K.assign_nearest_plain(x, c1)).float().mean())
    moved = int(np.abs(rep.weights - one.weights).sum())
    log(f"  KMeans ({n} x {x.shape[1]}, k = {rep.centroids.shape[0]}, "
        f"{max_iter} rounds): fit ms 1 shard {one_ms:.3f}, 8 shards "
        f"{rep_ms:.3f}, 8 sharded {sh_ms:.3f} (bit-identical to replicated: "
        f"{same(sh.centroids, rep.centroids)}); launches 1 shard {one_l}, 8 "
        f"shards {rep_l}; 8 against 1 shard: max|centroid diff|={diff:.3g}, "
        f"label agreement {agree:.6f}, {moved} of {n} counts moved")
    assert rep.weights.sum() == n
    assert diff <= CENTROID_ATOL and agree >= LABEL_AGREEMENT
    summary["KMeans"] = {"p1_ms": one_ms, "p8_ms": rep_ms,
                         "p8_sharded_ms": sh_ms, "p1_launches": one_l,
                         "p8_launches": rep_l, "centroid_diff": diff}
    del table, x
    torch.cuda.empty_cache()

    # (c) FTRL: the config's dense table on hyperplane labels, and phase 9's
    # sparse stream, on 1 and 8 shards
    spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    batch = spec["stage"]["paramMap"]["globalBatchSize"]
    table = runner.build_generator(spec).get_data()
    truth = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(
        29), device="cuda")
    margin = table.column("features") @ truth
    table = table.with_column("label",
                              (margin > margin.median()).to(torch.float32))
    batches = table.num_rows // batch

    def warm(est):
        return est.warm_start(np.zeros(d))

    for kind, rows, engine, kernel in [
            ("dense", table, "torch-dense-batches", None),
            ("sparse", _sparse_stream(Table, sparse, 2_000_000, d, 10,
                                      seed=23),
             "cuda-csr-batches", "segment_reduce_sum")]:
        b = rows.num_rows // batch
        fits = {}
        for p, sharded in [(1, False), (8, False), (8, True)]:
            est_box = []

            def setup(est, est_box=est_box):
                est_box.append(est)
                return warm(est)

            model, ms, launched = fit(spec, rows, p, sharded, 2, setup)
            assert est_box[-1].last_execution_path == engine, (
                est_box[-1].last_execution_path)
            fits[p, sharded] = (model, ms, launched)
        (m1, ms1, l1), (m8, ms8, l8), (s8, mss8, ls8) = (
            fits[1, False], fits[8, False], fits[8, True])
        if kernel:
            assert l1 == {kernel: 2 * b}, l1
            assert l8 == {kernel: 2 * 8 * b, "reduce_partials": b}, l8
            assert ls8 == l8, ls8
        else:
            assert l1 == {} and l8 == {"reduce_partials": b} == ls8, (l1, l8)
        np.testing.assert_allclose(s8.coefficients, m8.coefficients,
                                   rtol=1e-5, atol=1e-7)
        diff = np.abs(m8.coefficients - m1.coefficients)
        assert m8.model_version == m1.model_version == b
        assert np.all(diff <= BIG_FIT_RTOL * np.abs(m1.coefficients)
                      + BIG_FIT_ATOL), diff.max()
        log(f"  FTRL {kind} ({rows.num_rows} rows, {b} batches): fit ms 1 "
            f"shard {ms1:.3f}, 8 shards {ms8:.3f}, 8 sharded {mss8:.3f} "
            f"(bit-identical to replicated: "
            f"{same(s8.coefficients, m8.coefficients)}); launches 1 shard "
            f"{l1}, 8 shards {l8}; 8 against 1 shard max|coeff diff|="
            f"{diff.max():.3g} (max|coeff|={np.abs(m1.coefficients).max():.3g})")
        summary[f"FTRL {kind}"] = {"p1_ms": ms1, "p8_ms": ms8,
                                   "p8_sharded_ms": mss8, "p1_launches": l1,
                                   "p8_launches": l8}
        del rows
    del table, margin
    torch.cuda.empty_cache()

    # (d) a small fit with uneven local batches and a padded last shard
    # (4,003 rows of 20, global batch 801) on 8 shards: card against CPU
    from flink_ml_tpu_torch.models.classification import LogisticRegression

    small = _small_linear_table(Table, 41, 4003, 20, False)
    for sharded in (False, True):
        fitted = {}
        with mock.patch.dict(os.environ, {upd.ENV: str(int(sharded))}):
            for dev in ("cuda", "cpu"):
                est = LogisticRegression(
                    device=dev, mesh=create_mesh((8,), devices=[dev] * 8),
                    max_iter=15, global_batch_size=801, learning_rate=0.05,
                    reg=0.01, elastic_net=0.3, weight_col="weight")
                fitted[dev] = est.fit(small).coefficients
        np.testing.assert_allclose(fitted["cuda"], fitted["cpu"],
                                   rtol=SMALL_RTOL, atol=SMALL_ATOL)
    log("  LR on 8 shards, 4,003 x 20, global batch 801 (local batches 101 "
        "and 100, last shard 500 of 501 rows): card and CPU agree, "
        "replicated and sharded")

    counts = dict(K.launch_counts)
    log(f"  launches in the data-parallel run: {counts}")
    log("  data-parallel:", json.dumps(summary, sort_keys=True))
    for kern in PATH_KERNELS["parallel"]:
        assert counts[kern] >= 1, counts
    return counts


def _armed(**env):
    """The environment of ``env`` for a block (names of the
    ``flink_ml_tpu_torch.observability`` switches)."""
    return mock.patch.dict(os.environ, {k: str(v) for k, v in env.items()})


def phase_observability(K, runner):
    """Phase 12: the observability core on the card: traced, health-armed
    supervised segment fits of the LR and KMeans configs at full size, each
    held bit for bit against the same fit unarmed, then profiled fits whose
    device time the in-program profile reads per kernel."""
    from flink_ml_tpu_torch.iteration import iteration
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.observability import (compilestats, exporters,
                                                  health, profiling, tracing)
    from flink_ml_tpu_torch.resilience import RetryPolicy, faults

    log("phase 12: observability on the card")
    builds = compilestats.compile_totals()
    grp = exporters.metrics.group("ml", "compile")
    cached = sum(grp.get_counter("cached", labels={"fn": src})
                 for src in (K.KMEANS_SOURCE, K.SGD_SOURCE, K.SEGMENT_SOURCE,
                             K.KNN_SOURCE))
    log(f"  kernel builds recorded in phase 1: {builds['count']} compiled "
        f"(their nvcc wall times, which overlap, sum to "
        f"{builds['timeMs']:.1f} ms), {cached} cached")
    assert builds["count"] + cached == 4, (builds, cached)
    K.reset_launch_counts()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_observability_")
    tracer = tracing.tracer
    summary = {}
    try:
        cases = [
            ("LR", runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))
             ["logisticregression"], 5, "LogisticRegression"),
            ("KMeans", runner.load_config(str(CONFIG))["KMeans"], 3,
             "KMeans"),
        ]
        for name, spec, k, algo in cases:
            table = runner.build_generator(spec).get_data()
            max_iter = spec["stage"]["paramMap"]["maxIter"]
            runs = {"unarmed": [], "armed": []}

            def result(model):
                return (model.coefficients if name == "LR"
                        else np.concatenate([model.centroids.ravel(),
                                             model.weights]))

            def supervised(tag, trace_dir=None):
                mgr = CheckpointManager(f"{workdir}/{name}-{tag}")
                est = (runner.build_stage(spec)
                       .set_iteration_config(iteration.IterationConfig(
                           checkpoint_interval=k, checkpoint_manager=mgr))
                       .set_retry_policy(RetryPolicy(backoff_s=0)))
                env = ({} if trace_dir is None else
                       {tracing.TRACE_DIR_ENV: trace_dir,
                        health.HEALTH_ENV: 1})
                if trace_dir is not None:
                    # the trace dir's snapshot is the process registry:
                    # start it empty, so it holds this fit's series alone
                    exporters.metrics.clear()
                with _armed(**env), faults.chaos(at={"epoch-boundary": [2]}):
                    model, ms = _timed_fit(est, table)
                tracer.shutdown()
                runs["unarmed" if trace_dir is None else "armed"].append(ms)
                return result(model)

            # unarmed, armed, armed, unarmed: the host's drift falls on both
            want = supervised("unarmed-0")
            trace_dir = f"{workdir}/{name}-trace"
            got = supervised("armed-0", trace_dir)
            supervised("armed-1", f"{workdir}/{name}-trace-1")
            assert np.array_equal(supervised("unarmed-1"), want)
            assert np.array_equal(got, want), f"{name}: armed fit differs"

            spans = exporters.read_spans(trace_dir)
            by_id = {sp["id"]: sp for sp in spans}
            (fit,) = [sp for sp in spans if sp["name"] == f"{algo}.fit"]
            segments = [sp for sp in spans if sp["name"] == "segment"]
            saves = [sp for sp in spans if sp["name"] == "checkpoint.save"]
            restores = [sp for sp in spans
                        if sp["name"] == "checkpoint.restore"]
            resumed = [sp for sp in restores if "checkpoint" in sp["attrs"]]
            restarts = [ev for sp in spans for ev in sp["events"]
                        if ev["name"] == "supervisor.restart"]
            assert fit["parent"] is None
            assert segments and all(sp["parent"] == fit["id"]
                                    for sp in segments)
            assert saves and all(by_id[sp["parent"]]["name"] == "segment"
                                 for sp in saves)
            assert len(resumed) == 1 and resumed[0]["attrs"]["epoch"] == k, (
                restores)
            assert len(restarts) == 1, restarts
            assert fit["attrs"]["hbm_peak_bytes"] > 0
            snap = exporters.read_metrics(trace_dir)
            it = snap["ml.iteration"]["counters"]
            assert it["boundaryFetches"] == it["boundaries"], it
            assert it["rounds"] == max_iter, it
            hgroup = snap["ml.health"]
            series = sorted(
                (ev["attrs"] for sp in spans for ev in sp["events"]
                 if ev["name"] == "ml.convergence"),
                key=lambda a: a["epoch"])
            assert [a["epoch"] for a in series] == list(range(k, max_iter))
            assert all(math.isfinite(v) for a in series
                       for key, v in a.items()
                       if key not in ("algo", "epoch"))
            assert hgroup["gauges"][f'epochs{{algo="{algo}"}}'] == max_iter
            summary[name] = {
                "unarmed_ms": min(runs["unarmed"]),
                "armed_ms": min(runs["armed"]),
                "boundaries": it["boundaries"], "rounds": it["rounds"],
                "spans": len(spans), "health_rows": len(series),
                "peak_bytes": fit["attrs"]["hbm_peak_bytes"]}
            log(f"  {name} supervised segments (K={k}), traced and "
                f"health-armed: {json.dumps(summary[name], sort_keys=True)}; "
                "bit-identical to unarmed")

            # profiled: the next traced fit (and, for KMeans, transform)
            # captures a torch.profiler window
            profiled = {}
            regions = [("fit", lambda: runner.build_stage(spec).fit(table))]
            if name == "KMeans":
                model = runner.build_stage(spec).fit(table)
                regions.append(("transform", lambda: model.transform(table)))
            for region, call in regions:
                pdir = f"{workdir}/{name}-{region}-profile"
                profiling.reset()
                with _armed(**{tracing.TRACE_DIR_ENV: pdir,
                               profiling.CAPTURE_ENV: 1}):
                    call()
                    torch.cuda.synchronize()
                tracer.shutdown()
                report = profiling.read_profile(pdir)
                eff = profiling.efficiency_report(pdir)
                lost = (report["launches"], report["launchesWithoutKernel"])
                assert report["source"] == "device", (
                    report["source"], "launches and those without a kernel "
                    "on the device lane:", lost)
                for row in eff["fns"]:
                    if row["fn"] == "torch":
                        continue
                    launches = row["launches"]
                    share = row["utilization"]
                    assert launches, f"no launch cost in the window: {row}"
                    assert share is not None and 0.0 < share <= 1.0, row
                    profiled[row["fn"]] = {
                        "device_ms": row["deviceMs"], "launches": launches,
                        "ms_per_launch": row["deviceMs"] / launches,
                        "bound_ms": row["boundMs"], "share": share,
                        "bound": row["bound"]}
                torch_ms = sum(r["deviceMs"] for r in eff["fns"]
                               if r["fn"] == "torch")
                log(f"  {name} profiled {region}: PyTorch's own kernels "
                    f"{torch_ms:.4f} ms of device time; "
                    f"{len(report['ops'])} distinct kernels; {lost[0]} "
                    f"launches, {lost[1]} without a kernel on the device "
                    "lane")
            for fn, row in sorted(profiled.items()):
                log(f"  {name} profile {fn}: {json.dumps(row, sort_keys=True)}")
            summary[name]["profile"] = profiled
            del table
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    counts = dict(K.launch_counts)
    seen = set(summary["LR"]["profile"]) | set(summary["KMeans"]["profile"])
    missing = set(PATH_KERNELS["observability"]) - seen
    assert not missing, f"no device rows in the profiles for {missing}"
    log(f"  launches in the observability run: {counts}")
    log("  observability:", json.dumps(summary, sort_keys=True))
    for kern in PATH_KERNELS["observability"]:
        assert counts[kern] >= 1, counts
    return counts


def _get_json(port, route):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as resp:
        return resp.status, json.loads(resp.read())


class _Counting(logging.Handler):
    """Counts the servable wrapper's swallowed telemetry faults."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.faults = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("serving ") and msg.endswith(" failed"):
            self.faults.append(msg)


def _recording_servable(coef, version, served, ticks, device="cuda"):
    """A device-predict LR servable whose transform records, for each
    request of the batch, the version that served it and its dots
    (``served[ordinal]``), and for each transform (version, thread, rows,
    ms, device-product ms) (``ticks``); the product is the one-device or,
    on a mesh whose shards divide the batch, the row-sharded one."""
    from flink_ml_tpu_torch.servable import LogisticRegressionModelServable
    from flink_ml_tpu_torch.servable.lr import LogisticRegressionModelData

    sv = LogisticRegressionModelServable().set_device_predict(
        True, device=device)
    sv.model_data = LogisticRegressionModelData(coef, version)
    inner_dots, inner_sharded = sv._device_dots, sv._sharded_dots
    inner_transform = sv.transform
    last = {}

    def timed(fn, *args, **kwargs):
        t = time.perf_counter()
        last["dots"] = fn(*args, **kwargs)
        last["ms"] = (time.perf_counter() - t) * 1e3
        return last["dots"]

    def transform(df):
        t = time.perf_counter()
        out = inner_transform(df)
        ms = (time.perf_counter() - t) * 1e3
        ticks.append((version, threading.current_thread().name,
                      df.num_rows(), ms, last["ms"]))
        offset = 0
        for seq, rows in getattr(df, "request_segments", None) or ():
            served[seq] = (version, last["dots"][offset:offset + rows])
            offset += rows
        return out

    sv._device_dots = lambda xb: timed(inner_dots, xb)
    sv._sharded_dots = lambda *a, **kw: timed(inner_sharded, *a, **kw)
    sv.transform = transform
    return sv


def _recording_loader(served, ticks, coefs=None, device="cuda"):
    """The registry loader of phases 13 and 14: a
    :func:`_recording_servable` per version; ``coefs[version]`` keeps
    each loaded coefficient."""

    def loader(leaves, version):
        coef = np.asarray(leaves[0], np.float64)
        if coefs is not None:
            coefs[version] = coef
        return _recording_servable(coef, version, served, ticks, device)

    return loader


def phase_serving(K, runner, card_line):
    """Phase 13: the serving path on the card. An LR fit on the card
    (1,000,000 x 100, drift and quality capture armed) is published as v1
    with both baselines; the registry's loader builds the device-predict
    servable; a micro-batcher over the registry is warmed and serves a
    closed loop of 400 requests of 1, 2 and 4 rows from 64 callers while an
    FTRL fit of the same table, published as v2 mid-run, is hot-swapped in
    by the watcher. Every response is held against the host float64
    predict of the version that served it."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.linalg.vectors import DenseVector
    from flink_ml_tpu_torch.models.classification import LogisticRegression
    from flink_ml_tpu_torch.models.online import OnlineLogisticRegression
    from flink_ml_tpu_torch.observability import drift, evaluation, server
    from flink_ml_tpu_torch.servable import DataFrame, DataTypes, Row
    from flink_ml_tpu_torch.serving import (BatcherConfig, LoadGenConfig,
                                            MicroBatcher, ModelRegistry,
                                            compile_count, publish_model,
                                            run_loadgen, warm)

    log("phase 13: the serving path on the card")
    spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    ftrl_params = spec["stage"]["paramMap"]
    lr_params = runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))[
        "logisticregression"]["stage"]["paramMap"]
    n = 1_000_000
    K.reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(n, d, generator=gen, device="cuda")
    truth = np.random.default_rng(37).normal(size=d)
    margin = x @ torch.as_tensor(truth, dtype=torch.float32, device="cuda")
    thr = float(margin.median())
    table = Table.from_columns(features=x,
                               label=(margin > thr).to(torch.float32))
    del margin
    with _armed(FLINK_ML_TPU_DRIFT=1, FLINK_ML_TPU_QUALITY=1):
        t0 = time.perf_counter()
        v1 = LogisticRegression(
            max_iter=lr_params["maxIter"], reg=lr_params["reg"],
            elastic_net=lr_params["elasticNet"],
            learning_rate=lr_params["learningRate"],
            global_batch_size=lr_params["globalBatchSize"],
            tol=lr_params["tol"]).fit(table)
        torch.cuda.synchronize()
        v1_ms = (time.perf_counter() - t0) * 1e3
        fit_launches = dict(K.launch_counts)
        assert fit_launches["sgd_batch_terms"] > 0, fit_launches
        ftrl = OnlineLogisticRegression(
            global_batch_size=ftrl_params["globalBatchSize"],
            reg=ftrl_params["reg"], elastic_net=ftrl_params["elasticNet"],
            alpha=ftrl_params["alpha"], beta=ftrl_params["beta"])
        v2 = ftrl.warm_start(np.zeros(d)).fit(table)
    for model in (v1, v2):
        assert model.drift_baseline is not None
        assert model.quality_baseline is not None
    log(f"  producer fits on {n} x {d}: LR {v1_ms:.1f} ms "
        f"({fit_launches['sgd_batch_terms']} sgd_batch_terms launches), "
        f"FTRL {ftrl.last_execution_path} version {v2.model_version}; "
        f"training AUC LR {v1.quality_baseline.sketch.auc():.4f}, FTRL "
        f"{v2.quality_baseline.sketch.auc():.4f}")
    del table, x
    torch.cuda.empty_cache()
    coefs = {1: np.asarray(v1.coefficients, np.float64),
             2: np.asarray(v2.coefficients, np.float64)}

    workdir = tempfile.mkdtemp(prefix="serving-")
    watch = os.path.join(workdir, "models")
    faults = _Counting()
    api_log = logging.getLogger("flink_ml_tpu_torch.servable.api")
    api_log.addHandler(faults)
    served = {}   # request ordinal -> (version, served dots)
    ticks = []    # (version, thread, rows, ms, product ms) per transform
    loader = _recording_loader(served, ticks)

    def frame_rows(i):
        return np.random.default_rng(1000 + i).normal(
            size=(SERVE_SIZES[i % len(SERVE_SIZES)], d))

    def frame(i):
        return DataFrame(["features"], [DataTypes.vector()],
                         [Row([DenseVector(r)]) for r in frame_rows(i)])

    reg = batcher = None
    try:
        publish_model(watch, [coefs[1]], 1, baseline=v1.drift_baseline,
                      quality_baseline=v1.quality_baseline)
        reg = ModelRegistry(watch, loader, model="lr",
                            probe=lambda: frame(10**6),
                            poll_interval_s=0.01)
        adopted = reg.poll()
        assert adopted and reg.version == 1, (
            "v1 was not adopted", _serving_group().snapshot().get(
                "counters", {}))
        batcher = MicroBatcher(reg, BatcherConfig(buckets=(8, 32, 128),
                                                  window_ms=1.0)).start()
        report = warm(batcher)
        builds_after_warmup = compile_count()
        assert report["thread"] == "device-stage", report
        srv = server.maybe_start(0)
        assert srv is not None
        code, health_doc = _get_json(srv.port, "/healthz")
        assert code == 200 and health_doc["status"] == "ok", health_doc
        code, serving_doc = _get_json(srv.port, "/serving")
        assert serving_doc["serving"]["servable"] == "lr@v1", serving_doc
        log(f"  warmup: {json.dumps(report, sort_keys=True)}; /healthz "
            f"{health_doc['status']}, /serving "
            f"{serving_doc['serving']['servable']}")

        # the first ticks after warmup, one 1-row request each: warmed on
        # the batcher's device thread, then on the caller's thread (a
        # second batcher warmed before it started); the whole transform
        # and its device product (copy in, product, fetch) apart
        def first_ticks(b, label):
            start = len(ticks)
            for i in range(20):
                b.submit(frame(2 * 10**6 + i)).result(timeout=30)
            mine = ticks[start:]
            out = {}
            for key, col in (("transform", 3), ("product", 4)):
                ms = [t[col] for t in mine]
                out[key] = {"first_ms": ms[0],
                            "rest_median_ms": statistics.median(ms[1:]),
                            "rest_max_ms": max(ms[1:])}
            log(f"  first tick after warmup on the {label}: transform "
                f"{out['transform']['first_ms']:.3f} ms (the next 19: "
                f"median {out['transform']['rest_median_ms']:.3f}, max "
                f"{out['transform']['rest_max_ms']:.3f}), its product "
                f"{out['product']['first_ms']:.3f} ms (median "
                f"{out['product']['rest_median_ms']:.3f}, max "
                f"{out['product']['rest_max_ms']:.3f})")
            return out

        tick_probe = {"device-stage": first_ticks(batcher, "device stage")}
        other = MicroBatcher(reg, BatcherConfig(buckets=(8, 32, 128),
                                                window_ms=1.0))
        assert warm(other, gate=False)["thread"] == "caller"
        other.start()
        try:
            tick_probe["caller"] = first_ticks(other, "caller's thread")
        finally:
            other.stop()

        # the load run: 400 requests from 64 callers; v2 is published
        # after the 100th response and the watcher swaps it in under load
        reg.start_watcher()
        results = {}
        swap = {}

        def feedback(i, frm, fut):
            out = fut.result()
            results[i] = (fut.request_id, out)
            xs = frame_rows(i)
            evaluation.record_feedback(
                fut.request_id, (xs @ truth > thr).astype(np.float64))

        def tick(done):
            if done == 100:
                swap["published_ms"] = time.perf_counter()
                publish_model(watch, [coefs[2]], 2,
                              baseline=v2.drift_baseline,
                              quality_baseline=v2.quality_baseline)
                deadline = time.monotonic() + 30
                while reg.version != 2 and time.monotonic() < deadline:
                    time.sleep(0.001)
                swap["adopt_ms"] = (time.perf_counter()
                                    - swap["published_ms"]) * 1e3

        cfg = LoadGenConfig(mode="closed", requests=400, concurrency=64)
        load_start = len(ticks)
        batched = run_loadgen(batcher.submit, frame, cfg, tick=tick,
                              feedback=feedback)
        builds_after_load = compile_count()
        load_ticks = [t for t in ticks[load_start:]
                      if t[1] == "flink-ml-tpu-batcher-dev"]
        per_request_preds = {}

        def keep(i, frm, fut):
            per_request_preds[i] = fut.result().get("prediction").values

        per_request = run_loadgen(lambda f: reg.active.transform(f), frame,
                                  cfg, feedback=keep)
    finally:
        if batcher is not None:
            batcher.stop()
        if reg is not None:
            reg.stop()
        server.stop()
        api_log.removeHandler(faults)
        shutil.rmtree(workdir, ignore_errors=True)

    # gates
    for name, res in (("batched", batched), ("per-request", per_request)):
        assert res["ok"] == 400 and res["errors"] == 0 and \
            res["rejected"] == 0, (name, res)
    assert reg.version == 2, reg.version
    assert sorted(results) == list(range(400)), len(results)
    versions, near_zero, worst = _check_responses(
        [(seq, frame_rows(i), out) for i, (seq, out) in results.items()],
        served, coefs)
    assert set(versions) == {1, 2}, versions
    for i, pred in per_request_preds.items():
        host = frame_rows(i) @ coefs[2]
        clear = np.abs(host) >= SERVE_ATOL
        near_zero += int((~clear).sum())
        assert np.array_equal(np.asarray(pred)[clear], (host[clear] >= 0)
                              .astype(np.float64)), i
    assert len(per_request_preds) == 400
    assert builds_after_load == builds_after_warmup, (
        builds_after_warmup, builds_after_load)
    assert not faults.faults, faults.faults
    grp = _serving_group()
    rejected_swaps = {k: v for k, v in grp.snapshot().get(
        "counters", {}).items() if k.startswith("swapRejected")}
    assert not rejected_swaps, rejected_swaps
    drift_psi, auc = {}, {}
    for version in (1, 2):
        name = f"lr@v{version}"
        verdict = drift.evaluate(name, emit=False)
        drift_psi[name] = verdict["series"]["prediction"]["psi"]
        auc[name] = evaluation.evaluate(name, emit=False)["live"]["auc"]
        assert math.isfinite(drift_psi[name]), verdict
        assert math.isfinite(auc[name]), auc
    fills = {}
    for version in (1, 2):
        labels = {"servable": f"lr@v{version}"}
        fills[f"lr@v{version}"] = {
            "batchFill": grp.get_gauge("batchFill", labels=labels),
            "paddingWaste": grp.get_gauge("paddingWaste", labels=labels)}
    tick_ms = [t[3] for t in load_ticks]
    product_ms = [t[4] for t in load_ticks]
    summary = {
        "card": card_line, "rows": n, "dim": d,
        "producer": {"lr_fit_ms": v1_ms,
                     "sgd_batch_terms": fit_launches["sgd_batch_terms"],
                     "ftrl_path": ftrl.last_execution_path},
        "warmup": report, "first_ticks": tick_probe,
        "batched": {k: batched[k] for k in ("throughput_rps", "rows_per_s",
                                            "latency_ms", "wall_s")},
        "per_request": {k: per_request[k] for k in (
            "throughput_rps", "rows_per_s", "latency_ms", "wall_s")},
        "load_ticks": {"count": len(tick_ms),
                       "rows": sum(t[2] for t in load_ticks),
                       "median_ms": statistics.median(tick_ms),
                       "max_ms": max(tick_ms),
                       "product_median_ms": statistics.median(product_ms),
                       "product_share": sum(product_ms) / sum(tick_ms)},
        "served_by_version": versions, "swap_adopt_ms": swap.get("adopt_ms"),
        "near_zero_rows": near_zero, "max_abs_dot_err": worst,
        "builds": {"after_warmup": builds_after_warmup,
                   "after_load": builds_after_load},
        "telemetry_faults": len(faults.faults), "drift_psi": drift_psi,
        "live_auc": auc, "fill": fills}
    for name, res in (("batched", batched), ("per-request", per_request)):
        lat = res["latency_ms"]
        log(f"  {name}: {res['throughput_rps']} requests/s, "
            f"{res['rows_per_s']} rows/s, p50 {lat['p50']} ms, p90 "
            f"{lat['p90']} ms, p99 {lat['p99']} ms")
    log(f"  served by version: {versions}; v2 adopted "
        f"{swap.get('adopt_ms', float('nan')):.1f} ms after its publish; "
        f"rows with |dot| < {SERVE_ATOL}: {near_zero}; max |dot err| "
        f"{worst:.3g}; kernel builds after warmup / after load "
        f"{builds_after_warmup} / {builds_after_load}")
    log(f"  load ticks: {len(tick_ms)}, median {statistics.median(tick_ms):.3f}"
        f" ms, max {max(tick_ms):.3f} ms, the device product "
        f"{100 * sum(product_ms) / sum(tick_ms):.1f}% of their time; fill {json.dumps(fills)}; drift "
        f"psi {json.dumps(drift_psi)}; live AUC {json.dumps(auc)}")
    log(f"  {card_line}")
    log("  serving:", json.dumps(summary, sort_keys=True, default=str))
    counts = dict(K.launch_counts)
    for kern in PATH_KERNELS["serving"]:
        assert counts[kern] >= 1, counts
    return counts


def _check_responses(responses, served, coefs):
    """Hold every response against the host float64 predict of the
    version that served it (phase 13's tolerances); returns (versions
    served, rows with |dot| < SERVE_ATOL, max |dot err|)."""
    versions, near_zero, worst = {}, 0, 0.0
    for seq, rows, out in responses:
        version, dots = served[seq]
        versions[version] = versions.get(version, 0) + 1
        host = rows @ coefs[version]
        np.testing.assert_allclose(dots, host, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL)
        worst = max(worst, float(np.max(np.abs(dots - host))))
        pred = np.asarray(out.get("prediction").values)
        clear = np.abs(host) >= SERVE_ATOL
        near_zero += int((~clear).sum())
        assert np.array_equal(pred[clear], (host[clear] >= 0)
                              .astype(np.float64)), (seq, version)
    return versions, near_zero, worst


def phase_ops_loop(K, runner, card_line, device="cuda"):
    """Phase 14: the ops loop on the card (item 14 of the module
    docstring). ``device`` is the card; ``"cpu"`` runs the same logic on
    the plain kernels, a rehearsal that launches no kernel and takes the
    CPU's sparse engine."""
    import collections
    import contextlib
    import io

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.device import synchronize
    from flink_ml_tpu_torch.models.classification import LogisticRegression
    from flink_ml_tpu_torch.observability import (exporters, fleet,
                                                  flightrecorder, server,
                                                  slo, tracing)
    from flink_ml_tpu_torch.serving import controller as controller_mod

    log("phase 14: the ops loop on the card")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    retrain_path = "cuda-csr-batches" if on_card else "torch-csr-batches"
    spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    ftrl_params = spec["stage"]["paramMap"]
    lr_params = runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))[
        "logisticregression"]["stage"]["paramMap"]
    # sum(w_true) == 0: the labels stay balanced under any mean shift of
    # the features, so a candidate predicting one class is drift, and an
    # honest refit never is
    mags = np.resize([1.0, 2.0, 1.5], d // 2)
    w_true = np.stack([mags, -mags], axis=1).ravel()
    root = tempfile.mkdtemp(prefix="ops-loop-")
    trace_dir = os.path.join(root, "trace")
    fleet_dir = os.path.join(root, "fleet")
    env = {
        # fit-time baselines; drift judged by the controller's own
        # evaluations (the per-observation cadence is left long), on at
        # least OPS_MIN_COUNT observations a series: 33 series of 32
        # bins sit well under the thresholds on same-distribution
        # windows of that size
        "FLINK_ML_TPU_DRIFT": 1, "FLINK_ML_TPU_QUALITY": 1,
        "FLINK_ML_TPU_DRIFT_INTERVAL_S": 3600,
        "FLINK_ML_TPU_DRIFT_MIN_COUNT": OPS_MIN_COUNT,
        "FLINK_ML_TPU_FLEET_DIR": fleet_dir,
        "FLINK_ML_TPU_FLEET_BEACON_S": 0.2,
        # every incident of the run gets its bundle (a drift verdict and
        # the rollback it causes fire one step apart), each with a short
        # profile window
        "FLINK_ML_TPU_INCIDENT_DEBOUNCE_S": 0,
        "FLINK_ML_TPU_INCIDENT_MAX": 64,
        "FLINK_ML_TPU_INCIDENT_PROFILE_MS": 50}
    K.reset_launch_counts()
    cli_out = io.StringIO()  # the CLIs' reports, shown when a gate fails
    quiet = contextlib.redirect_stdout(cli_out)
    with _armed(**env):
        tracing.tracer.configure(trace_dir)
        srv = server.maybe_start(0)
        assert srv is not None
        try:
            # v1: an LR fit on the card of seeded rows from the unshifted
            # distribution, with drift and quality baselines
            gen = torch.Generator(device=dev).manual_seed(43)
            x = torch.randn(OPS_V1_ROWS, d, generator=gen, device=dev)
            w = torch.as_tensor(w_true, dtype=torch.float32, device=dev)
            table = Table.from_columns(features=x,
                                       label=((x @ w) > 0).to(torch.float32))
            t0 = time.perf_counter()
            v1 = LogisticRegression(
                max_iter=lr_params["maxIter"], reg=lr_params["reg"],
                elastic_net=lr_params["elasticNet"],
                learning_rate=lr_params["learningRate"],
                global_batch_size=lr_params["globalBatchSize"],
                tol=lr_params["tol"], device=dev).fit(table)
            synchronize(dev)
            v1_ms = (time.perf_counter() - t0) * 1e3
            v1_launches = K.launch_counts["sgd_batch_terms"]
            assert v1.drift_baseline is not None
            assert v1.quality_baseline is not None
            del table, x
            coef1 = np.asarray(v1.coefficients, np.float64)
            log(f"  v1: LR fit of {OPS_V1_ROWS} x {d} in {v1_ms:.1f} ms "
                f"({v1_launches} sgd_batch_terms launches), training AUC "
                f"{v1.quality_baseline.sketch.auc():.4f}")

            runs = [_ops_scenario(
                i, threaded=(i == 2), d=d, dev=dev, w_true=w_true,
                coef1=coef1, v1=v1, root=root, ftrl_params=ftrl_params,
                retrain_path=retrain_path, K=K, on_card=on_card,
                fleet_dir=fleet_dir, srv=srv, quiet=quiet)
                for i in (1, 2)]
            assert runs[0]["det"] == runs[1]["det"], (
                "chaos runs at one seed diverged", runs[0]["det"],
                runs[1]["det"])

            # an impossible latency SLO, evaluated emitting, is an incident
            (impossible,) = slo.evaluate_slos(
                [slo.SLO(name="impossible-latency", kind="latency",
                         threshold_ms=1e-6)], emit=True)
            assert not impossible["ok"], impossible
        finally:
            server.stop()
            tracing.tracer.shutdown()
        exporters.dump_metrics(trace_dir)
        with quiet:
            controller_rc = controller_mod.main([trace_dir, "--check"])
            incident_rc = flightrecorder.main([trace_dir, "--check"])
            flightrecorder.main([trace_dir, "--ack"])
            acked_rc = flightrecorder.main([trace_dir, "--check"])
        bundles = flightrecorder.read_incidents(trace_dir,
                                                include_spans=False)
        beacons, invalid = fleet.read_beacons(fleet_dir)
    shutil.rmtree(root, ignore_errors=True)
    kinds = collections.Counter(b["kind"] for b in bundles)
    profiled = sum(1 for b in bundles if b.get("device_profile"))
    report = cli_out.getvalue()[-4000:]
    assert controller_rc == 0, (controller_rc, report)
    assert (incident_rc, acked_rc) == (4, 0), (incident_rc, acked_rc)
    # the fleet --check ran while the serving and controller roles were
    # alive (cycle 4); a stopped member reads dead two intervals later
    fleet_rc = runs[1]["report"]["threaded"]["fleet_check"]
    assert fleet_rc == 0 and invalid == 0, (fleet_rc, invalid)
    assert kinds["rollback"] == 2 and kinds["slo"] >= 1, kinds
    counts = dict(K.launch_counts)
    summary = {"card": card_line, "dim": d, "v1_rows": OPS_V1_ROWS,
               "v1_fit_ms": v1_ms, "v1_sgd_batch_terms": v1_launches,
               "runs": [r["report"] for r in runs],
               "incidents": dict(kinds), "incident_profiles": profiled,
               "incident_subjects": [
                   [b["kind"], b["attrs"].get("servable",
                                              b["attrs"].get("slo"))]
                   for b in bundles],
               "beacons": len(beacons), "launches": counts,
               "exits": {"controller": controller_rc,
                         "incident": incident_rc, "incident_acked": acked_rc,
                         "fleet": fleet_rc}}
    for r in runs:
        rep = r["report"]
        for c in rep["cycles"]:
            log(f"  run {rep['run']} cycle {c['cycle']}: {c['outcome']} in "
                f"{c['wall_ms']:.1f} ms wall ({c['steps']} steps), "
                f"publish-to-swap "
                + (f"{c['publish_to_swap_ms']:.1f} ms"
                   if c["publish_to_swap_ms"] is not None else "-"))
        for t in rep["retrains"]:
            log(f"  run {rep['run']} retrain on {t['thread']}: {t['path']},"
                f" {t['ms']:.1f} ms, {t['launches']} segment_reduce_sum "
                f"launches")
        ramp = rep["ramp"]
        log(f"  run {rep['run']} ramp: {ramp['drives']} drives, "
            f"{ramp['requests_per_s']:.1f} batched requests/s, p99 "
            f"{ramp['p99_ms']:.3f} ms (worst drive); {rep['requests']} "
            f"requests, 0 errors, 0 rejections; served by version "
            f"{rep['served_by_version']}; max |dot err| "
            f"{rep['max_abs_dot_err']:.3g}")
    log(f"  incident bundles: {dict(kinds)} ({profiled} with a profile); "
        f"beacons: {len(beacons)}; controller --check {controller_rc}, "
        f"incident --check {incident_rc} then {acked_rc} after --ack, "
        f"fleet --check {fleet_rc}")
    log(f"  {card_line}")
    log("  ops loop:", json.dumps(summary, sort_keys=True, default=str))
    if on_card:
        for kern in PATH_KERNELS["ops"]:
            assert counts[kern] >= 1, counts
    return counts


def _ops_scenario(run, threaded, d, dev, w_true, coef1, v1, root,
                  ftrl_params, retrain_path, K, on_card, fleet_dir, srv,
                  quiet):
    """One run of phase 14's scenario under the seeded chaos plan: a
    drift-triggered cycle that swaps, a rigged cycle that the bake rolls
    back, an honest cycle that swaps; with ``threaded``, then a fourth
    cycle on the controller's own thread. Returns the run's
    deterministic shape (``det``) and its report."""
    import collections
    import dataclasses
    import threading as th

    import scipy.sparse as sp

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.common.metrics import metrics
    from flink_ml_tpu_torch.device import synchronize
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.linalg.vectors import DenseVector
    from flink_ml_tpu_torch.models.online import OnlineLogisticRegression
    from flink_ml_tpu_torch.observability import drift, evaluation
    from flink_ml_tpu_torch.resilience import RetryPolicy, faults
    from flink_ml_tpu_torch.servable import DataFrame, DataTypes, Row
    from flink_ml_tpu_torch.serving import (BatcherConfig, ControllerConfig,
                                            LoadGenConfig, MicroBatcher,
                                            ModelRegistry, OpsController,
                                            compile_count, publish_model,
                                            run_loadgen, warm)
    from flink_ml_tpu_torch.serving.controller import (BAKING, PUBLISHING,
                                                       RAMPING, WATCHING)

    metrics.clear()
    drift.clear()
    evaluation.clear()
    rng = np.random.default_rng(7)
    watch = os.path.join(root, f"models-{run}")
    buffer = collections.deque(maxlen=2 * OPS_DRIVE_ROWS)
    buffer_lock = th.Lock()
    served, coefs, retrains, responses, ramp_drives = {}, {}, [], [], []
    totals = {"requests": 0, "errors": 0, "rejected": 0}
    rigged = {"on": False}

    def frames_of(x):
        return [DataFrame(["features"], [DataTypes.vector()],
                          [Row([DenseVector(r)])
                           for r in x[i:i + OPS_REQUEST_ROWS]])
                for i in range(0, len(x), OPS_REQUEST_ROWS)]

    def drive(shift):
        x = rng.normal(size=(OPS_DRIVE_ROWS, d)) + shift
        y = (x @ w_true > 0).astype(np.float64)
        with buffer_lock:
            buffer.extend(zip(x, y))
        frames = frames_of(x)

        def feedback(i, frm, fut):
            rows = slice(OPS_REQUEST_ROWS * i, OPS_REQUEST_ROWS * (i + 1))
            responses.append((fut.request_id, x[rows], fut.result()))
            evaluation.record_feedback(fut.request_id, y[rows])

        res = run_loadgen(batcher.submit, lambda i: frames[i],
                          LoadGenConfig(mode="closed", requests=len(frames),
                                        concurrency=OPS_CALLERS),
                          feedback=feedback)
        for key in totals:
            totals[key] += res[key]
        return res

    def retrain(trigger):
        active = reg.active
        before = np.array(active.model_data.coefficient, copy=True)
        with buffer_lock:
            rows = list(buffer)
        # a few passes over the buffer: one pass of FTRL's per-coordinate
        # steps learns little more than the shift itself
        xb = np.concatenate([np.stack([r for r, _ in rows])]
                            * OPS_RETRAIN_PASSES)
        yb = np.tile([label for _, label in rows], OPS_RETRAIN_PASSES)
        est = OnlineLogisticRegression(
            global_batch_size=OPS_RETRAIN_BATCH, reg=ftrl_params["reg"],
            elastic_net=ftrl_params["elasticNet"],
            alpha=ftrl_params["alpha"], beta=ftrl_params["beta"],
            device=dev).warm_start(before, model_version=reg.version or 0)
        start = K.launch_counts["segment_reduce_sum"]
        t0 = time.perf_counter()
        model = est.fit(Table.from_columns(
            features=sparse.CsrVectorColumn(sp.csr_matrix(xb)), label=yb))
        synchronize(dev)
        retrains.append({
            "path": est.last_execution_path,
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": K.launch_counts["segment_reduce_sum"] - start,
            "thread": th.current_thread().name,
            # the refit wrote nothing into what the serving version holds
            "serving_untouched": bool(np.array_equal(
                active.model_data.coefficient, before))})
        coef = np.asarray(model.coefficients, np.float64)
        if rigged["on"]:
            rigged["on"] = False
            # finite garbage: passes the probe, predicts one class on
            # any mean-shifted traffic
            coef = np.abs(coef) * 10.0 + 1.0
        return [coef], model.drift_baseline, model.quality_baseline

    cfg = ControllerConfig(
        ramp_stages=(0.25, 0.5, 1.0), stage_min_requests=8,
        bake_min_requests=8, stage_timeout_s=600.0, cooldown_s=0.0,
        max_error_ratio=0.02,
        policy=RetryPolicy(max_restarts=8, backoff_s=0.01,
                           max_backoff_s=0.05))
    cycles = []

    def run_cycle(shift, max_steps=120):
        before = dict(ctrl._outcomes)
        t_trigger = t_publish = t_swap = None
        for step in range(max_steps):
            res = drive(shift)
            state0 = ctrl.state
            if state0 == RAMPING:
                ramp_drives.append(res)
            t = time.perf_counter()
            state = ctrl.step()
            if state0 == WATCHING and state != WATCHING:
                t_trigger, first = t, step
            if state0 == PUBLISHING and t_publish is None:
                t_publish = t
            if state == BAKING and state0 != BAKING:
                t_swap = time.perf_counter()
            if state == WATCHING and ctrl._outcomes != before:
                outcome = [k for k, v in ctrl._outcomes.items()
                           if v > before.get(k, 0)][0]
                cycles.append({
                    "cycle": ctrl.cycle, "outcome": outcome,
                    "steps": step - first + 1,
                    "wall_ms": (time.perf_counter() - t_trigger) * 1e3,
                    "publish_to_swap_ms": (
                        (t_swap - t_publish) * 1e3 if t_swap else None)})
                return outcome
        raise AssertionError(f"no cycle ended within {max_steps} steps: "
                             f"{ctrl.state}, {ctrl.transitions[-5:]}")

    publish_model(watch, [coef1], 1, baseline=v1.drift_baseline,
                  quality_baseline=v1.quality_baseline)
    reg = ModelRegistry(watch, _recording_loader(served, [], coefs, dev),
                        model="lr", probe=lambda: frames_of(
                            rng.normal(size=(4, d)))[0])
    ctrl = OpsController(reg, retrain, cfg)
    batcher = None
    try:
        with faults.chaos(seed=OPS_CHAOS_SEED, rate=OPS_CHAOS_RATE,
                          sites=faults.CONTROLLER_SITES):
            for _ in range(50):
                if reg.poll():
                    break
            assert reg.version == 1, reg.version
            batcher = MicroBatcher(reg, BatcherConfig(
                buckets=(8, 32, 128), window_ms=1.0)).start()
            with faults.suppressed():
                report = warm(batcher)
            builds = compile_count()
            # 1: the traffic shifts; drift triggers a cycle that swaps
            assert run_cycle(OPS_SHIFT) == "swapped", ctrl.transitions
            assert reg.version == 2, reg.version
            drive(OPS_SHIFT)
            v2_drift = drift.evaluate("lr@v2", emit=False)
            assert not v2_drift["drifted"], v2_drift
            # 2: a rigged refit; promoted straight after its probe, so
            # the bake judges it, and the rollback restores v2
            rigged["on"] = True
            ctrl.config = dataclasses.replace(cfg, ramp_stages=())
            assert run_cycle(-OPS_SHIFT) == "rolled-back", ctrl.transitions
            ctrl.config = cfg
            assert reg.version == 2 and 3 in reg._rejected, reg.version
            assert drift.baseline_for("lr@v3") is None
            # 3: an honest cycle swaps a healthy version in
            assert run_cycle(-OPS_SHIFT) == "swapped", ctrl.transitions
            assert reg.version == 4, reg.version
            drive(-OPS_SHIFT)
            v4_drift = drift.evaluate("lr@v4", emit=False)
            assert not v4_drift["drifted"], v4_drift
        det = {"transitions": [(t["from"], t["to"], t["cycle"])
                               for t in ctrl.transitions],
               "outcomes": dict(ctrl._outcomes),
               "final_version": reg.version,
               "rejected": sorted(reg._rejected)}
        threaded_report = None
        if threaded:
            threaded_report = _ops_threaded_cycle(
                ctrl, cfg, reg, drive, retrains, cycles, fleet_dir, srv,
                quiet, on_card)
        builds_after = compile_count()
    finally:
        if batcher is not None:
            batcher.stop()
        ctrl.stop()
        reg.stop()
    assert totals["errors"] == 0 and totals["rejected"] == 0, totals
    assert builds_after == builds, (builds, builds_after)
    for r in retrains:
        assert r["path"] == retrain_path, retrains
        assert r["serving_untouched"], retrains
        if on_card:
            assert r["launches"] >= 1, retrains
    versions, near_zero, worst = _check_responses(responses, served, coefs)
    ramp = {"drives": len(ramp_drives),
            "requests_per_s": statistics.mean(
                r["throughput_rps"] for r in ramp_drives),
            "p99_ms": max(r["latency_ms"]["p99"] for r in ramp_drives)}
    return {"det": det, "report": {
        "run": run, "cycles": cycles, "retrains": retrains, "ramp": ramp,
        "requests": totals["requests"], "served_by_version": versions,
        "near_zero_rows": near_zero, "max_abs_dot_err": worst,
        "builds_after_warmup": builds_after - builds, "warmup": report,
        "transitions": len(det["transitions"]),
        "outcomes": det["outcomes"], "threaded": threaded_report}}


def _ops_threaded_cycle(ctrl, cfg, reg, drive, retrains, cycles, fleet_dir,
                        srv, quiet, on_card):
    """Cycle 4 of phase 14 on the controller's own thread: the traffic
    shifts back, the thread names the card, retrains on it and swaps,
    while this thread keeps serving. The fleet, SLO, incident and
    controller routes are read while it runs."""
    import dataclasses

    from flink_ml_tpu_torch.observability import fleet
    from flink_ml_tpu_torch.serving.controller import WATCHING

    ctrl.config = dataclasses.replace(cfg, check_interval_s=0.05)
    for _ in range(2):  # the refit's buffer holds only the new traffic
        drive(OPS_SHIFT)
    before = dict(ctrl._outcomes)
    version = reg.version
    t0 = time.perf_counter()
    ctrl.start()
    routes, fleet_rc, roles = {}, None, []
    try:
        deadline = time.monotonic() + 120.0
        while not (ctrl.state == WATCHING and ctrl._outcomes != before):
            assert time.monotonic() < deadline, ctrl.transitions[-5:]
            drive(OPS_SHIFT)
            if not routes:
                for route in ("/slo", "/incidents", "/fleet",
                              "/controller"):
                    code, _ = _get_json(srv.port, route)
                    routes[route] = code
                with quiet:
                    fleet_rc = fleet.main([fleet_dir, "--check"])
                roles = [(row["role"], row["state"]) for row in
                         fleet.FleetView(fleet_dir).membership()]
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ctrl.stop()
    outcome = [k for k, v in ctrl._outcomes.items()
               if v > before.get(k, 0)][0]
    bound = ctrl._bound_device
    cycles.append({"cycle": ctrl.cycle, "outcome": outcome, "steps": None,
                   "wall_ms": wall_ms, "publish_to_swap_ms": None,
                   "thread": True})
    assert outcome == "swapped" and reg.version == version + 1, (
        outcome, reg.version, ctrl.transitions[-6:])
    assert retrains[-1]["thread"] == "flink-ml-tpu-ops-controller", retrains
    assert set(routes.values()) == {200}, routes
    assert fleet_rc == 0, fleet_rc
    assert any("serving" in role and "controller" in role
               and state == "alive" for role, state in roles), roles
    if on_card:
        assert bound == reg.active.device, (bound, reg.active.device)
    return {"outcome": outcome, "wall_ms": wall_ms, "routes": routes,
            "fleet_check": fleet_rc, "roles": roles, "bound": str(bound)}


@contextlib.contextmanager
def _uncounted(K):
    """Launches inside are a reference's, not the path's: the counts are
    put back as they were when the block ends."""
    saved = dict(K.launch_counts)
    try:
        yield
    finally:
        K.launch_counts.update(saved)


@contextlib.contextmanager
def _no_off_ramp(Table):
    """Within the block, a Table read that would bring a tensor column to
    the host fails: the pipelines' stages must keep such a column on its
    device (their statistics, a few numbers, may come to the host)."""
    real = {name: getattr(Table, name)
            for name in ("vectors", "scalars", "_host_column")}

    def guarded(name):
        def read(self, col, *args, **kwargs):
            out = real[name](self, col, *args, **kwargs)
            raw = self.column(col)
            assert not (isinstance(raw, torch.Tensor)
                        and not isinstance(out, torch.Tensor)), (
                f"Table.{name}({col!r}) took a tensor column to the host")
            return out
        return read

    with mock.patch.multiple(Table, **{n: guarded(n) for n in real}):
        yield


def _synced_ms(fn):
    """(result, host ms) of ``fn()``, ended by ``torch.cuda.synchronize()``
    (where there is a card)."""
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - start) * 1e3


def _f64_moments(x, chunk=1_000_000):
    """Per-column float64 mean and centered sum of squares of a tensor
    (n, d), in plain PyTorch float64 over row chunks on its device (give
    it a host copy for a reference off the card)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    total = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for i in range(0, n, chunk):
        total += x[i:i + chunk].double().sum(0)
    mean = total / n
    varsum = torch.zeros_like(mean)
    for i in range(0, n, chunk):
        varsum += ((x[i:i + chunk].double() - mean) ** 2).sum(0)
    return mean.cpu().numpy(), varsum.cpu().numpy()


def _fit_spy(est, col):
    """Record what ``est.fit`` is handed in column ``col`` by the stage
    before it."""
    seen, real_fit = [], est.fit

    def fit(table):
        seen.append(table.column(col))
        return real_fit(table)

    est.fit = fit
    return seen


def _assert_on(seen, device, tag):
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor), (tag, seen)
    assert seen[0].device.type == device, tag
    assert seen[0].dtype == torch.float32, tag


def _pipeline_readme(K, runner, Table, F, Pipeline, PipelineModel, device):
    """(a) StandardScaler → LogisticRegression at the LR config's width."""
    spec = runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))[
        "logisticregression"]
    max_iter = spec["stage"]["paramMap"]["maxIter"]
    table = runner.build_generator(spec, device).get_data()
    n, d = table.column("features").shape
    lr = runner.build_stage(spec, device).set_features_col("scaled")
    seen = _fit_spy(lr, "scaled")
    pipe = Pipeline([F.StandardScaler(input_col="features",
                                      output_col="scaled", with_mean=True,
                                      with_std=True, device=device), lr])
    with _no_off_ramp(Table):
        before = K.launch_counts["sgd_batch_terms"]
        model, fit_ms = _synced_ms(lambda: pipe.fit(table))
        fit_launches = K.launch_counts["sgd_batch_terms"] - before
        out, transform_ms = _synced_ms(lambda: model.transform(table)[0])
        with tempfile.TemporaryDirectory() as tmp:
            def save_load():
                model.save(tmp)
                return PipelineModel.load(tmp, device=device)
            loaded, save_load_ms = _synced_ms(save_load)
        again = loaded.transform(table)[0]
        with _uncounted(K):
            # the scaler alone, for the byte bounds (best of three each)
            scaler = F.StandardScaler(input_col="features",
                                      output_col="scaled", with_mean=True,
                                      with_std=True, device=device)
            scaler_fit_ms = min(_synced_ms(lambda: scaler.fit(table))[1]
                                for _ in range(3))
            smodel = model.stages[0]
            scaler_transform_ms = min(
                _synced_ms(lambda: smodel.transform(table))[1]
                for _ in range(3))
            scaled = smodel.transform(table)[0]
            alone = runner.build_stage(spec, device) \
                .set_features_col("scaled").fit(scaled)
    _assert_on(seen, device, "README pipeline")
    assert fit_launches == (max_iter if device == "cuda" else 0), fit_launches
    assert out["scaled"].device.type == device
    pred = out["prediction"]
    assert pred.device.type == device and pred.shape == (n,)
    assert torch.equal(pred, again["prediction"]), "the reloaded model differs"
    assert torch.equal(out["rawPrediction"], again["rawPrediction"])
    mean64, varsum64 = _f64_moments(
        torch.as_tensor(table.column("features")).cpu())
    std64 = np.sqrt(varsum64 / (n - 1))
    mean_err = float(np.max(np.abs(smodel.mean - mean64) / np.abs(mean64)))
    std_err = float(np.max(np.abs(smodel.std - std64) / np.abs(std64)))
    assert mean_err <= STAT_RTOL and std_err <= STAT_RTOL, (mean_err, std_err)
    coeffs, plain = model.stages[1].coefficients, alone.coefficients
    assert np.all(np.abs(coeffs - plain)
                  <= COEFF_RTOL * np.abs(plain) + COEFF_ATOL)
    row = {"rows": n, "width": d, "fit_ms": fit_ms,
           "transform_ms": transform_ms, "save_load_ms": save_load_ms,
           "sgd_launches": fit_launches, "scaler_fit_ms": scaler_fit_ms,
           "scaler_transform_ms": scaler_transform_ms,
           "stat_rel_err": max(mean_err, std_err),
           "coeff_max_diff": float(np.abs(coeffs - plain).max())}
    log(f"  (a) README pipeline, {n} x {d}: fit {fit_ms:.3f} ms "
        f"({fit_launches} sgd launches), transform {transform_ms:.3f} ms, "
        f"save/load {save_load_ms:.3f} ms; scaler alone: fit "
        f"{scaler_fit_ms:.3f} ms, transform {scaler_transform_ms:.3f} ms; "
        f"statistics within {row['stat_rel_err']:.3g} of float64; "
        f"coefficients within {row['coeff_max_diff']:.3g} of LR alone")
    return row


def _pipeline_kmeans(K, runner, Table, F, Pipeline, device):
    """(b) MinMaxScaler → KMeans at the KMeans config's width."""
    spec = runner.load_config(str(CONFIG))["KMeans"]
    table = runner.build_generator(spec, device).get_data()
    km = runner.build_stage(spec, device).set_features_col("scaled")
    seen = _fit_spy(km, "scaled")
    pipe = Pipeline([F.MinMaxScaler(input_col="features",
                                    output_col="scaled", device=device), km])
    with _no_off_ramp(Table):
        before = dict(K.launch_counts)
        model, fit_ms = _synced_ms(lambda: pipe.fit(table))
        out, transform_ms = _synced_ms(lambda: model.transform(table)[0])
        launches = {k: K.launch_counts[k] - before[k]
                    for k in PATH_KERNELS["kmeans"]}
        with _uncounted(K):
            scaled = model.stages[0].transform(table)[0]
            alone = runner.build_stage(spec, device) \
                .set_features_col("scaled")
            alone_model = alone.fit(scaled)
            want = alone_model.transform(scaled)[0]["prediction"]
    _assert_on(seen, device, "MinMaxScaler → KMeans")
    assert device != "cuda" or all(v >= 1 for v in launches.values()), \
        launches
    got = out["prediction"]
    assert got.device.type == device and got.shape == (table.num_rows,)
    c = torch.as_tensor(alone_model.centroids, dtype=torch.float32,
                        device=device)
    ties = tie_rows_ok(scaled.column("scaled"), c, got, want)
    row = {"fit_ms": fit_ms, "transform_ms": transform_ms,
           "launches": launches, "tie_flips": ties}
    log(f"  (b) MinMaxScaler → KMeans, {table.num_rows} x 100, k = "
        f"{spec['stage']['paramMap']['k']}: fit {fit_ms:.3f} ms, transform "
        f"{transform_ms:.3f} ms, launches {launches}; labels against KMeans "
        f"alone: tie-flips={ties}")
    return row


def _graph_example(K, runner, Table, F, GraphBuilder, GraphModel,
                   LogisticRegression, device):
    """(c) examples/graph_example.py's DAG on 200,000 seeded rows."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(GRAPH_ROWS, 3)) * 5
    y = (x @ [1.0, -1.0, 2.0] > 0).astype(np.float64)
    table = Table.from_columns(features=x, label=y)
    lr_params = dict(features_col="scaled", max_iter=20,
                     global_batch_size=GRAPH_ROWS, device=device)
    builder = GraphBuilder()
    source = builder.create_table_id()
    (scaled_id,) = builder.add_estimator(
        F.StandardScaler(input_col="features", output_col="scaled",
                         device=device), [source])
    lr = LogisticRegression(**lr_params)
    seen = _fit_spy(lr, "scaled")
    (pred_id,) = builder.add_estimator(lr, [scaled_id])
    graph = builder.build_estimator([source], [pred_id])
    with _no_off_ramp(Table):
        before = K.launch_counts["sgd_batch_terms"]
        model, fit_ms = _synced_ms(lambda: graph.fit(table))
        launches = K.launch_counts["sgd_batch_terms"] - before
        out, transform_ms = _synced_ms(lambda: model.transform(table)[0])
        with tempfile.TemporaryDirectory() as tmp:
            model.save(tmp)
            loaded = GraphModel.load(tmp, device=device)
        again = loaded.transform(table)[0]
        smodel = model.nodes[0].stage
        with _uncounted(K):
            alone = LogisticRegression(**lr_params).fit(
                smodel.transform(table)[0])
    _assert_on(seen, device, "graph")
    assert launches == (20 if device == "cuda" else 0), launches
    assert torch.equal(out["prediction"], again["prediction"])
    np.testing.assert_allclose(smodel.mean, x.mean(axis=0), rtol=STAT_RTOL)
    np.testing.assert_allclose(smodel.std, x.std(axis=0, ddof=1),
                               rtol=STAT_RTOL)
    coeffs, plain = model.nodes[1].stage.coefficients, alone.coefficients
    assert np.all(np.abs(coeffs - plain)
                  <= COEFF_RTOL * np.abs(plain) + COEFF_ATOL)
    accuracy = float((out["prediction"].cpu().numpy() == y).mean())
    row = {"fit_ms": fit_ms, "transform_ms": transform_ms,
           "sgd_launches": launches, "accuracy": accuracy}
    log(f"  (c) graph StandardScaler → LogisticRegression, {GRAPH_ROWS} x 3: "
        f"fit {fit_ms:.3f} ms, transform {transform_ms:.3f} ms, accuracy "
        f"{accuracy:.4f}; reloaded graph predicts the same")
    return row


def _head(col, n=FEATURE_ROWS):
    return col[:n].cpu() if isinstance(col, torch.Tensor) else col[:n]


def _near(x, edges):
    """Rows of ``x`` (CPU tensor) within EDGE_ATOL of any of ``edges``."""
    x = x.double()
    near = torch.zeros_like(x, dtype=torch.bool)
    for e in edges:
        near |= (x - float(e)).abs() <= EDGE_ATOL
    return near


def _check_continuous(got, want, tag):
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - FEATURE_RTOL * want.abs()
                    - FEATURE_ATOL).max())
    assert excess <= 0, f"{tag}: off by {excess} over tolerance"
    return err


def _selection_ok(got, p_ref, k, tag):
    order = np.argsort(p_ref, kind="stable")
    want = set(order[:k].tolist())
    cut = p_ref[order[k - 1]]
    swapped = want ^ set(int(i) for i in got)
    assert all(abs(p_ref[i] - cut) <= EDGE_ATOL for i in swapped), (
        tag, sorted(swapped))
    return len(swapped)


def _anova_p_reference(x, y, chunk=1_000_000):
    """float64 one-way ANOVA p-values of a card tensor against its labels,
    in plain PyTorch float64 on the card (row chunks) and scipy."""
    from scipy import stats as sstats

    classes, yi = torch.unique(y, return_inverse=True)
    c, (n, d) = int(classes.shape[0]), x.shape
    sums = torch.zeros((c, d), dtype=torch.float64, device=x.device)
    sq = torch.zeros_like(sums)
    for i in range(0, n, chunk):
        xc = x[i:i + chunk].double()
        sums.index_add_(0, yi[i:i + chunk], xc)
        sq.index_add_(0, yi[i:i + chunk], xc * xc)
    counts = torch.bincount(yi, minlength=c).double()[:, None]
    sums, sq, counts = (t.cpu().numpy() for t in (sums, sq, counts))
    means = sums / counts
    ssw = (sq - sums * means).sum(axis=0)
    grand = sums.sum(axis=0) / n
    ssb = (counts * (means - grand) ** 2).sum(axis=0)
    f = (ssb / (c - 1)) / (ssw / (n - c))
    return sstats.f.sf(f, c - 1, n - c)


def _check_feature_row(name, spec, runner, Table, F, convert, NaiveBayes,
                       device):
    """Run the config's stage once more on the same generated table, and hold
    its output against the port on the CPU on the first FEATURE_ROWS rows
    of a host copy (statistics against float64 references over all rows)."""
    from flink_ml_tpu_torch.api.stage import Estimator

    table = runner.build_generator(spec, device).get_data()
    stage = runner.build_stage(spec, device)
    head = Table.from_columns(**{c: _head(table.column(c))
                                 for c in table.column_names})
    with _no_off_ramp(Table):
        if isinstance(stage, Estimator):
            model, stage_ms = _synced_ms(lambda: stage.fit(table))
            out = (model.transform(table)[0]
                   if name != "naivebayes" else None)
        else:
            out, stage_ms = _synced_ms(lambda: stage.transform(table)[0])
    check = {"stage_ms": stage_ms}
    n = table.num_rows
    if name in ("standardscaler", "minmaxscaler", "maxabsscaler",
                "robustscaler"):
        x = table.column(stage.input_col)
        if name == "standardscaler":
            mean, varsum = _f64_moments(x)
            ref = {"mean": mean, "std": np.sqrt(varsum / (n - 1))}
            build = convert.standard_scaler_model_from_arrays
        elif name == "minmaxscaler":
            lo, hi = torch.aminmax(x, dim=0)
            ref = {"data_min": lo.double().cpu().numpy(),
                   "data_max": hi.double().cpu().numpy()}
            build = convert.min_max_scaler_model_from_arrays
        elif name == "maxabsscaler":
            ref = {"max_abs": x.abs().amax(0).double().cpu().numpy()}
            build = convert.max_abs_scaler_model_from_arrays
        else:
            qs = [torch.kthvalue(x, int(np.floor(q * (n - 1))) + 1, dim=0)
                  .values.double().cpu().numpy()
                  for q in (stage.lower, 0.5, stage.upper)]
            ref = {"medians": qs[1], "ranges": qs[2] - qs[0]}
            build = convert.robust_scaler_model_from_arrays
        worst = 0.0
        for key, want in ref.items():
            got = getattr(model, key)
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
            worst = max(worst, float(rel.max()))
        assert worst <= STAT_RTOL, (name, worst)
        check["stat_rel_err"] = worst
        cpu_model = model.copy_params_to(build(
            *(getattr(model, k) for k in model.STAT_NAMES), device="cpu"))
        got = _head(out.column(model.output_col))
        assert out.column(model.output_col).device.type == device
        want = cpu_model.transform(head)[0].column(model.output_col)
        check["max_abs_err"] = _check_continuous(got, want, name)
    elif name == "variancethresholdselector":
        _, varsum = _f64_moments(table.column(stage.input_col))
        variances = varsum / (n - 1)
        thr = stage.variance_threshold
        want = np.nonzero(variances > thr)[0]
        edge = np.abs(variances - thr) <= EDGE_ATOL
        assert set(model.indices) ^ set(want) <= set(np.nonzero(edge)[0])
        cpu_model = model.copy_params_to(
            convert.variance_threshold_selector_model_from_arrays(
                model.indices, device="cpu"))
        got = _head(out.column(model.output_col))
        assert torch.equal(got, cpu_model.transform(head)[0]
                           .column(model.output_col)), name
        check["selected"] = len(model.indices)
    elif name == "univariatefeatureselector":
        p_ref = _anova_p_reference(table.column(stage.features_col),
                                   table.column(stage.label_col))
        k = int(stage.selection_threshold or 50)
        check["swapped"] = _selection_ok(model.indices, p_ref, k, name)
        cpu_model = model.copy_params_to(
            convert.univariate_feature_selector_model_from_arrays(
                model.indices, device="cpu"))
        got = _head(out.column(model.output_col))
        assert torch.equal(got, cpu_model.transform(head)[0]
                           .column(model.output_col)), name
        check["selected"] = len(model.indices)
    elif name == "naivebayes":
        host = Table.from_columns(
            **{c: table.column(c).cpu() for c in table.column_names})
        cpu_model = NaiveBayes(device="cpu").fit(host)
        for key in ("pi", "floors", "labels"):
            np.testing.assert_allclose(getattr(model, key),
                                       getattr(cpu_model, key),
                                       rtol=STAT_RTOL)
        assert all(m.keys() == c.keys() and np.allclose(
            [m[v] for v in m], [c[v] for v in m], rtol=STAT_RTOL)
            for row_m, row_c in zip(model.theta, cpu_model.theta)
            for m, c in zip(row_m, row_c))
        with _no_off_ramp(Table):
            pred, check["predict_ms"] = _synced_ms(
                lambda: model.transform(table)[0].column(
                    model.prediction_col))
        assert pred.device.type == device
        want = cpu_model.transform(head)[0].column(model.prediction_col)
        assert torch.equal(_head(pred), want), name
    else:
        cpu_stage = runner.build_stage(spec, device="cpu")
        want_table = cpu_stage.transform(head)[0]
        cols = (stage.output_cols if hasattr(stage, "OUTPUT_COLS")
                else [stage.output_col])
        ins = (stage.input_cols if hasattr(stage, "INPUT_COLS")
               else [stage.input_col])
        assert out.num_rows == n, (name, out.num_rows)
        errs = []
        for i, col in enumerate(cols):
            full = out.column(col)
            assert isinstance(full, torch.Tensor), (name, col)
            assert full.device.type == device, (name, col)
            got, want = _head(full), want_table.column(col)
            if name in ("binarizer", "bucketizer"):
                edges = ([stage.thresholds[i]] if name == "binarizer"
                         else stage.splits_array[i])
                far = ~_near(head.column(ins[i]), edges)
                assert torch.equal(got[far], want[far]), (name, col)
                check["near_edge"] = int((~far).sum())
            else:
                errs.append(_check_continuous(got, want, f"{name} {col}"))
        if errs:
            check["max_abs_err"] = max(errs)
    del table, out
    if device == "cuda":
        torch.cuda.empty_cache()
    return check


def phase_pipelines(K, runner, Table, device="cuda"):
    """Phase 15: Pipeline, Graph and the dense feature transformers on the
    card (see the module docstring). ``device`` is the card; ``"cpu"``
    runs the same logic on the CPU, without launch counts (a rehearsal,
    with ``runner.load_config`` patched to cut the rows)."""
    from flink_ml_tpu_torch import convert
    from flink_ml_tpu_torch.api import (GraphBuilder, GraphModel, Pipeline,
                                        PipelineModel)
    from flink_ml_tpu_torch.models import feature as F
    from flink_ml_tpu_torch.models.classification import (LogisticRegression,
                                                          NaiveBayes)

    log("phase 15: pipelines, graphs and the dense feature transformers "
        "on the card")
    started = time.perf_counter()
    K.reset_launch_counts()
    summary = {
        "readme": _pipeline_readme(K, runner, Table, F, Pipeline,
                                   PipelineModel, device),
        "kmeans": _pipeline_kmeans(K, runner, Table, F, Pipeline, device),
        "graph": _graph_example(K, runner, Table, F, GraphBuilder,
                                GraphModel, LogisticRegression, device)}
    if device == "cuda":
        torch.cuda.empty_cache()
    # the pipelines' own fits and transforms, their references uncounted
    counts = dict(K.launch_counts)
    if device == "cuda":
        own = {"sgd_batch_terms": summary["readme"]["sgd_launches"]
               + summary["graph"]["sgd_launches"],
               **summary["kmeans"]["launches"]}
        assert {k: v for k, v in counts.items() if v} == own, (counts, own)
    rows = {}
    for name in FEATURE_CONFIGS:
        ((key, spec),) = runner.load_config(
            str(CONFIGS / f"{name}-benchmark.json")).items()
        with _no_off_ramp(Table):
            row = runner.best_of(key, spec, runs=1, device=device)
        check = _check_feature_row(name, spec, runner, Table, F, convert,
                                   NaiveBayes, device)
        rows[name] = {k: row[k] for k in ("totalTimeMs", "executeTimeMs",
                                          "achievedGBps", "deviceName",
                                          "inputRecordNum")}
        rows[name].update(check)
        log(f"  (d) {name}: " + json.dumps(rows[name], sort_keys=True))
    summary["configs"] = rows
    # the runner rows and their checks launch no kernel of the port
    assert dict(K.launch_counts) == counts, (counts, dict(K.launch_counts))
    log(f"  launches in the pipelines run: {counts}")
    log(f"  phase 15: {time.perf_counter() - started:.1f} s")
    log("  pipelines:", json.dumps(summary, sort_keys=True))
    for kern in PATH_KERNELS["pipeline"]:
        assert device != "cuda" or counts[kern] >= 1, counts
    return counts


# -- phase 16: the text, discrete and misc feature transformers ---------------

def _sparse_text_example(K, Table, device):
    """(a) examples/sparse_text_pipeline_example.py's chain on the port:
    3,000 docs, HashingTF at 2^18, FTRL with a batch of 500."""
    from flink_ml_tpu_torch.common.table import as_dense_vector_column
    from flink_ml_tpu_torch.models import feature as F
    from flink_ml_tpu_torch.models import online

    rng = np.random.default_rng(8)
    good = ["great", "excellent", "love", "wonderful", "best"]
    bad = ["terrible", "awful", "hate", "worst", "broken"]
    neutral = ["the", "a", "product", "it", "was", "very"]

    def doc(label):
        pool = (good if label else bad) + neutral
        return " ".join(rng.choice(pool, size=8))

    labels = rng.integers(0, 2, 3000).astype(np.float64)
    texts = np.asarray([doc(label) for label in labels])
    table = Table.from_columns(text=texts, label=labels)
    tokens = F.Tokenizer(input_col="text", output_col="words",
                         device=device).transform(table)[0]
    hashed = F.HashingTF(input_col="words", output_col="features",
                         device=device).transform(tokens)[0]
    m = hashed.column("features").to_csr()
    dim = m.shape[1]
    init = Table.from_columns(
        coefficient=as_dense_vector_column(np.zeros((1, dim))),
        modelVersion=np.asarray([0]))
    runs = {}
    threshold = online.FTRL_SPARSE_MIN_NNZ
    # as written, a 500-doc batch holds about 2,900 stored values, below
    # the device engine's floor: the host engine runs it. Then the same
    # chain with the floor under the batches' size, through cuda-csr
    per_batch = int(np.diff(m.indptr[::500]).min())
    for name, floor in (("as_written", threshold), ("card", per_batch)):
        online.FTRL_SPARSE_MIN_NNZ = floor
        try:
            before = K.launch_counts["segment_reduce_sum"]
            est = online.OnlineLogisticRegression(
                global_batch_size=500, alpha=0.5, beta=1.0, device=device)
            model, fit_ms = _synced_ms(
                lambda: est.set_initial_model_data(init).fit(hashed))
            launches = K.launch_counts["segment_reduce_sum"] - before
        finally:
            online.FTRL_SPARSE_MIN_NNZ = threshold
        out = model.transform(hashed)[0]
        acc = float(np.mean(np.asarray(out["prediction"]) == labels))
        assert acc > 0.9, (name, acc)
        runs[name] = {"engine": est.last_execution_path, "fit_ms": fit_ms,
                      "accuracy": acc, "segment_launches": launches,
                      "versions": model.model_version}
    assert dim == 1 << 18 and runs["card"]["engine"] == (
        "cuda-csr-batches" if device == "cuda" else "torch-csr-batches")
    assert device != "cuda" or runs["card"]["segment_launches"] >= 12
    log(f"  (a) sparse text example, 3,000 docs x 2^18: "
        + json.dumps(runs, sort_keys=True))
    return runs


def _text_labels(col, seed):
    """Labels of a one-character token matrix: a seeded half of its
    distinct tokens counts +1, the rest -1, and a row is 1 when its sum is
    positive (0 on a tie)."""
    assert col.dtype == np.dtype("<U1"), col.dtype
    cps = col.view(np.int32)
    distinct = np.flatnonzero(np.bincount(cps.reshape(-1)))
    rng = np.random.default_rng(seed)
    plus = rng.permutation(distinct)[: len(distinct) // 2]
    weight = np.full(int(distinct.max()) + 1, -1, np.int8)
    weight[plus] = 1
    return (weight[cps].sum(axis=1, dtype=np.int64) > 0).astype(np.float64)


@contextlib.contextmanager
def _never_densified(sparse):
    """Within the block, densifying a CSR column (or its matrix) fails."""
    import scipy.sparse as sp

    def refuse(*args, **kwargs):
        raise AssertionError("a hashed column was densified")

    with mock.patch.object(sparse.CsrVectorColumn, "to_dense", refuse), \
            mock.patch.object(sp.csr_matrix, "toarray", refuse), \
            mock.patch.object(sp.csr_matrix, "todense", refuse):
        yield


def _hashed_stream(K, runner, Table, device, keep=None):
    """(b) HashingTF → IDF → FTRL at the hashingtf config's full width.
    With ``keep`` (a dict), the HashingTF column and its labels are left
    there for phase 17 (c)."""
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.models import feature as F
    from flink_ml_tpu_torch.models import online

    ((key, spec),) = runner.load_config(
        str(CONFIGS / "hashingtf-benchmark.json")).items()
    seed = spec["inputData"]["paramMap"]["seed"]
    table, gen_ms = _synced_ms(
        lambda: runner.build_generator(spec, device).get_data())
    col = table.column("input")
    n, w = col.shape
    labels, label_ms = _synced_ms(lambda: _text_labels(col, seed))
    tf = runner.build_stage(spec, device).set_output_col("tf")
    stages = {"datagen_ms": gen_ms, "labels_ms": label_ms}
    before = dict(K.launch_counts)
    with _never_densified(sparse):
        hashed, stages["hashingtf_ms"] = _synced_ms(
            lambda: tf.transform(table)[0])
        idf = F.IDF(input_col="tf", output_col="tfidf", device=device)
        idf_model, stages["idf_fit_ms"] = _synced_ms(lambda: idf.fit(hashed))
        scored, stages["idf_transform_ms"] = _synced_ms(
            lambda: idf_model.transform(hashed)[0])
        stream = Table.from_columns(features=scored.column("tfidf"),
                                    label=labels)
        m = stream.column("features").to_csr()
        dim = m.shape[1]

        def fit(rows=None):
            data = stream if rows is None else stream.take(slice(0, rows))
            est = online.OnlineLogisticRegression(
                global_batch_size=TEXT_BATCH, alpha=0.5, beta=1.0,
                device=device).warm_start(np.zeros(dim))
            model, ms = _synced_ms(lambda: est.fit(data))
            return model, est.last_execution_path, ms

        model, engine, stages["ftrl_fit_ms"] = fit()
        launches = K.launch_counts["segment_reduce_sum"] - \
            before["segment_reduce_sum"]
        # where the fit's time goes: the host's batching and packing alone
        from flink_ml_tpu_torch.iteration import streaming

        def pack():
            for b in streaming.generate_batches(
                    streaming.StreamTable.from_table(stream, TEXT_BATCH),
                    TEXT_BATCH):
                online._pack_csr_shards(
                    sparse.features_matrix(b, "features"),
                    b.scalars("label", np.float64),
                    np.ones(b.num_rows), 1)
        _, stages["ftrl_pack_alone_ms"] = _synced_ms(pack)
        out, stages["ftrl_transform_ms"] = _synced_ms(
            lambda: model.transform(stream)[0])
        with _uncounted(K):
            again, _, _ = fit()
            prefix = min(n, TEXT_PREFIX_BATCHES * TEXT_BATCH)
            head_model, head_engine, _ = fit(prefix)
            threshold = online.FTRL_SPARSE_MIN_NNZ
            online.FTRL_SPARSE_MIN_NNZ = 1 << 62
            try:
                host_model, host_engine, stages["host_prefix_fit_ms"] = \
                    fit(prefix)
            finally:
                online.FTRL_SPARSE_MIN_NNZ = threshold
    batches = -(-n // TEXT_BATCH)
    assert engine == ("cuda-csr-batches" if device == "cuda"
                      else "torch-csr-batches"), engine
    assert head_engine == engine and host_engine == "host-csr-batches"
    assert model.model_version == batches
    assert device != "cuda" or launches >= 2 * batches, launches
    assert np.array_equal(again.coefficients, model.coefficients), (
        "the hashed stream's fit differs on a rerun")
    diff = np.abs(head_model.coefficients - host_model.coefficients)
    excess = diff - CSR_RTOL * np.abs(host_model.coefficients) - CSR_ATOL
    assert excess.max() <= 0, float(excess.max())
    accuracy = float(np.mean(np.asarray(out["prediction"]) == labels))
    assert accuracy > TEXT_ACCURACY, accuracy
    row = {"rows": n, "tokens_per_row": w, "dim": dim, "nnz": int(m.nnz),
           "batches": batches, "engine": engine,
           "segment_launches": launches, "accuracy": accuracy,
           "host_engine_max_diff": float(diff.max()),
           "nonzero_coefficients": int((model.coefficients != 0).sum()),
           **stages}
    log(f"  (b) HashingTF → IDF → FTRL, {n} x {w} tokens, 2^18 wide: "
        + json.dumps(row, sort_keys=True))
    if keep is not None:
        keep["hashed"], keep["labels"] = hashed.column("tf"), labels
    del table, hashed, scored, stream, out
    return row


def _token_rows(col):
    """The head rows of a token column as a ragged object column (rows are
    token lists), which the text ops take row by row."""
    out = np.empty(len(col), dtype=object)
    out[:] = [list(map(str, row)) for row in col]
    return out


def _string_rows(col):
    return np.asarray([str(v) for v in col], dtype=object)


def _cells_equal(got, want, tag):
    got = [list(map(str, r)) for r in got]
    want = [list(map(str, r)) for r in want]
    assert got == want, tag


def _csr_equal(got, want, tag, rtol=0.0):
    g = got.to_csr() if hasattr(got, "to_csr") else got
    w = want.to_csr() if hasattr(want, "to_csr") else want
    assert g.shape == w.shape, (tag, g.shape, w.shape)
    assert np.array_equal(g.indptr, w.indptr), tag
    assert np.array_equal(g.indices, w.indices), tag
    np.testing.assert_allclose(g.data, w.data, rtol=rtol, atol=0,
                               err_msg=tag)


def _host_table(head):
    """A Table of host copies of ``head``'s columns (numpy, as the host
    path takes them)."""
    from flink_ml_tpu_torch import Table

    return Table.from_columns(**{
        c: (head.column(c).cpu().numpy()
            if isinstance(head.column(c), torch.Tensor) else head.column(c))
        for c in head.column_names})


def _check_text_row(name, spec, runner, Table, device):
    """Run the config's stage once more on a generated table: the card's
    output (or the vectorized host path's) on the first FEATURE_ROWS rows
    against the port's host path on a host copy of those rows (card
    stages), or against the row-at-a-time path (host stages)."""
    from flink_ml_tpu_torch.api.stage import Estimator
    from flink_ml_tpu_torch.models import feature as F
    from flink_ml_tpu_torch.models.feature import text

    table = runner.build_generator(spec, device).get_data()
    stage = runner.build_stage(spec, device)
    head = table.take(slice(0, FEATURE_ROWS))
    host = _host_table(head)
    check = {}
    if isinstance(stage, Estimator):
        model, check["fit_ms"] = _synced_ms(lambda: stage.fit(table))
        with mock.patch.object(text, "_device_token_counts",
                               _recording(text._device_token_counts)) as rec:
            out, check["transform_ms"] = _synced_ms(
                lambda: model.transform(table)[0])
        cpu_model = model.copy_params_to(type(model)(device="cpu"))
        cpu_model.set_model_data(*model.get_model_data())
    else:
        out, check["transform_ms"] = _synced_ms(
            lambda: stage.transform(table)[0])
        cpu_model = runner.build_stage(spec, "cpu")
    if name == "countvectorizer":
        got = _head(out.column(model.output_col))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert out.column(model.output_col).device.type == device
        ragged = Table.from_columns(input=_token_rows(head.column("input")))
        want = cpu_model.transform(ragged)[0].column(model.output_col)
        assert torch.equal(got, torch.as_tensor(
            want.to_csr().toarray(), dtype=torch.float32)), name
        head_fit = F.CountVectorizer(input_col="input", device="cpu")
        assert (head_fit.fit(host).vocabulary
                == head_fit.fit(ragged).vocabulary), name
        check["vocabulary"] = len(model.vocabulary)
        # the dense counts: the call the transform made (the ids' copies to
        # the card included), then the same ids already on the card, timed
        # with CUDA events (the card's work alone), against the byte bound
        ((ids1, u, min_tf, binary, w, dev), ms) = rec.calls[0]
        check["dense_counts_ms"] = ms
        check["dense_counts_device_ms"] = _device_counts_ms(
            text, ids1, (u, min_tf, binary, w, dev), device)
        nbytes = ids1.nbytes + 4 * ids1.shape[0] * u
        check["dense_bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        del ids1, rec.calls[:]
    elif name == "idf":
        x = table.column(stage.input_col)
        df = (x != 0).sum(dim=0).cpu().numpy()
        assert np.array_equal(model.doc_freq, df), name
        got = _head(out.column(model.output_col))
        want = cpu_model.transform(host)[0].column(model.output_col)
        check["max_abs_err"] = _check_continuous(got, want, name)
    elif name in ("kbinsdiscretizer", "vectorindexer", "imputer",
                  "sqltransformer"):
        if name == "kbinsdiscretizer":
            sub = table.column(stage.input_col)[:stage.sub_samples] \
                .double().cpu().numpy()
            for j, edges in enumerate(model.bin_edges):
                want = np.unique(np.linspace(sub[:, j].min(),
                                             sub[:, j].max(),
                                             stage.num_bins + 1))
                assert np.array_equal(edges, want), (name, j)
        if name == "vectorindexer":
            # the card's screen and the host's fit on a copy of the head
            # rows find the same categorical dimensions there
            head_maps = F.VectorIndexer(
                input_col=stage.input_col, max_categories=stage.max_categories,
                device="cpu").fit(host).category_maps
            assert set(model.category_maps) <= set(head_maps), name
            check["categorical_dims"] = sorted(model.category_maps)
            check["head_categorical_dims"] = sorted(head_maps)
        if name == "imputer":
            for c, s in zip(stage.input_cols, model.surrogates):
                mean, _ = _f64_moments(table.column(c)[:, None])
                assert abs(s - mean[0]) <= STAT_RTOL * abs(mean[0]), (c, s)
        outs = (out.column_names if name == "sqltransformer"
                else getattr(model, "output_cols", None)
                or [model.output_col])
        want_table = cpu_model.transform(host)[0]
        errs = []
        for c in outs:
            full = out.column(c)
            assert isinstance(full, torch.Tensor), (name, c)
            assert full.device.type == device, (name, c)
            got = _head(full).double()
            want = torch.as_tensor(np.asarray(want_table.column(c)),
                                   dtype=torch.float64)
            if name == "imputer":
                errs.append(_check_continuous(got, want, f"{name} {c}"))
            else:
                assert torch.equal(got, want), (name, c)
        check["max_abs_err"] = max(errs) if errs else 0.0
    elif name == "featurehasher":
        got = out.column(stage.output_col)[:FEATURE_ROWS]
        want = stage.copy_params_to(F.FeatureHasher(device="cpu")) \
            .transform(host)[0].column(stage.output_col)
        _csr_equal(got, want, name)
        check["nnz_per_row"] = out.column(stage.output_col).to_csr().nnz \
            / table.num_rows
    elif name == "stringindexer":
        ragged = Table.from_columns(
            **{c: _string_rows(head.column(c)) for c in stage.input_cols})
        got = _head(out.column(model.output_cols[0]))
        want = cpu_model.transform(ragged)[0].column(model.output_cols[0])
        assert out.num_rows == table.num_rows
        assert np.array_equal(got, want), name
        head_fit = runner.build_stage(spec, "cpu")
        assert (head_fit.fit(host).string_arrays
                == head_fit.fit(ragged).string_arrays), name
        check["vocabulary"] = len(model.string_arrays[0])
    elif name == "onehotencoder":
        vals = np.asarray(head.column(model.input_cols[0]), np.float64)
        size = model.category_sizes[0] - (1 if model.drop_last else 0)
        rows, cols = [], []
        for i, v in enumerate(vals):
            if int(v) < size:
                rows.append(i)
                cols.append(int(v))
        import scipy.sparse as sp

        want = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                             shape=(len(vals), size))
        _csr_equal(out.column(model.output_cols[0])[:FEATURE_ROWS], want,
                   name)
        check["categories"] = model.category_sizes[0]
    else:
        # tokenizer, regextokenizer, ngram, stopwordsremover, hashingtf:
        # the vectorized path against the row-at-a-time path
        cols = (stage.output_cols if hasattr(stage, "OUTPUT_COLS")
                else [stage.output_col])
        ins = (stage.input_cols if hasattr(stage, "INPUT_COLS")
               else [stage.input_col])
        ragged = Table.from_columns(**{
            c: (_token_rows(head.column(c)) if head.column(c).ndim == 2
                else _string_rows(head.column(c))) for c in ins})
        want_table = cpu_model.transform(ragged)[0]
        for c in cols:
            got = out.column(c)
            if name == "hashingtf":
                _csr_equal(got[:FEATURE_ROWS], want_table.column(c), name)
                check["nnz_per_row"] = got.to_csr().nnz / table.num_rows
            else:
                _cells_equal(got[:FEATURE_ROWS], want_table.column(c), name)
                check["form"] = ("token matrix" if isinstance(got, np.ndarray)
                                 and got.ndim == 2 else "object column")
    check["rows"] = table.num_rows
    del table, out
    if device == "cuda":
        torch.cuda.empty_cache()
    return check


def _recording(fn):
    """``fn`` wrapped to keep each call's arguments and its synchronized
    host ms in ``.calls``."""
    def call(*args):
        out, ms = _synced_ms(lambda: fn(*args))
        call.calls.append((args, ms))
        return out
    call.calls = []
    return call


def _device_counts_ms(text, ids1, args, device):
    """Device ms of the dense counts on ids already on the card (CUDA
    events around one call after a warmup; host ms on the CPU)."""
    ids = torch.from_numpy(ids1).to(device)
    text._device_token_counts(ids, *args)
    if device != "cuda":
        return _synced_ms(lambda: text._device_token_counts(ids, *args))[1]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = text._device_token_counts(ids, *args)
    end.record()
    end.synchronize()
    del out, ids
    return start.elapsed_time(end)


def _host_machinery(K, runner, cv_table):
    """(d) the native kernels and the host pool, after CUDA is up."""
    import csv as _csv

    from flink_ml_tpu_torch import Table as PortTable
    from flink_ml_tpu_torch import native
    from flink_ml_tpu_torch.common import hostpool
    from flink_ml_tpu_torch.models.feature import text
    from flink_ml_tpu_torch.resilience import faults
    from flink_ml_tpu_torch.resilience.policy import WorkerTimeout

    row = {}
    keys = np.random.default_rng(16).integers(-(1 << 40), 1 << 40,
                                              HOST_KEYS) % 1_000_003
    def factorize():
        got = native.factorize_i64(keys)
        assert got is not None, "factorize_i64: past its distinct cap"
        return got

    (uniq, codes), row["factorize_ms"] = _synced_ms(factorize)
    u, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    assert np.array_equal(codes, rank[inv.reshape(-1)]), "factorize codes"
    assert np.array_equal(uniq, u[order]), "factorize uniq"
    row["factorize_distinct"] = len(uniq)

    rng = np.random.default_rng(17)
    data = np.round(rng.normal(size=(HOST_CSV_ROWS, 5)) * 1e3, 3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "numbers.csv")
        with open(path, "w", newline="") as f:
            writer = _csv.writer(f)
            writer.writerow([f"c{i}" for i in range(5)])
            writer.writerows(data.tolist())
        with open(path, newline="") as f:
            rows = list(_csv.reader(f))[1:]
        want = np.asarray([[float(v) for v in r] for r in rows])
        with open(path, "rb") as f:
            raw = f.read()
        body = raw[raw.index(b"\n") + 1:]
        def parse():
            got = native.csv_parse_numeric(body, 5)
            assert got is not None, "csv_parse_numeric: not all numeric"
            return got

        parsed, row["csv_parse_ms"] = _synced_ms(parse)
        assert np.array_equal(parsed, want), "csv_parse_numeric"
        t = PortTable.from_csv(path)
        assert all(np.array_equal(t.column(f"c{i}"), want[:, i])
                   for i in range(5)), "Table.from_csv"

    col = cv_table.column("input")[:HOST_POOL_ROWS]
    fn = lambda lo, hi: text._cv_shard_counts(col, lo, hi)  # noqa: E731
    serial, row["pool_serial_ms"] = _synced_ms(
        lambda: text._merge_shard_counts(hostpool.map_row_shards(
            fn, len(col), workers=1)))
    pooled, row["pool_forked_ms"] = _synced_ms(
        lambda: text._merge_shard_counts(hostpool.map_row_shards(
            fn, len(col), workers=hostpool.host_parallelism(),
            shard_cap=len(col) // 8)))
    assert all(np.array_equal(a, b) for a, b in zip(serial, pooled))
    row["pool_workers"] = hostpool.host_parallelism()
    assert row["pool_workers"] >= 2, row

    pids, real_fork = [], os.fork

    def fork():
        pid = real_fork()
        if pid:
            pids.append(pid)
        return pid

    start = time.perf_counter()
    with mock.patch.object(hostpool.os, "fork", fork), \
            faults.chaos(at={"hostpool-hang": [1]}):
        try:
            hostpool.map_row_shards(lambda lo, hi: hi - lo, 100_000,
                                    workers=2, min_rows=16,
                                    timeout_s=HANG_DEADLINE_S)
            raise AssertionError("the wedged worker did not time out")
        except WorkerTimeout:
            pass
    row["hang_timeout_ms"] = (time.perf_counter() - start) * 1e3
    assert row["hang_timeout_ms"] < HANG_DEADLINE_S * 1e3 + 10_000
    for pid in pids:
        try:
            os.waitpid(pid, os.WNOHANG)
            raise AssertionError(f"child {pid} was left behind")
        except ChildProcessError:
            pass
    row["hang_children_reaped"] = len(pids)
    log("  (d) host machinery after CUDA is up: "
        + json.dumps(row, sort_keys=True))
    return row


def _benchmark_demo(K, runner, device, keep=None):
    """``benchmark-demo.json`` through the port's runner: its KMeans rows
    run, and its two broken rows are reported as the JAX runner reports
    them. Its KMeans launches are phase 4's path, not counted here."""
    with _uncounted(K):
        results = runner.run_benchmarks(
            runner.load_config(str(CONFIGS / "benchmark-demo.json")),
            device=device)
    if keep is not None:  # phase 20 draws them, broken rows included
        keep.setdefault("runner_results", {}).update(results)
    failed = {name: e["exception"] for name, e in results.items()
              if "exception" in e}
    assert failed == DEMO_FAILURES, failed
    rows = {name: e["results"]["totalTimeMs"] for name, e in results.items()
            if "results" in e}
    assert len(rows) == len(results) - 2
    log("  benchmark-demo.json: " + json.dumps(
        {"rows": rows, "failed": failed}, sort_keys=True))
    return {"rows": len(rows), "failed": sorted(failed)}


def phase_text(K, runner, Table, device="cuda", keep=None):
    """Phase 16: the text, discrete and misc feature transformers on the
    card, with the host pool and the native host kernels (see the module
    docstring). ``device`` is the card; ``"cpu"`` runs the same logic on
    the CPU, without launch counts (a rehearsal, with
    ``runner.load_config`` patched to cut the rows). ``keep`` receives the
    hashed stream's column and labels for phase 17."""
    log("phase 16: the text, discrete and misc feature transformers on "
        "the card")
    started = time.perf_counter()
    K.reset_launch_counts()
    summary = {"sparse_example": _sparse_text_example(K, Table, device),
               "hashed_stream": _hashed_stream(K, runner, Table, device,
                                               keep)}
    if device == "cuda":
        torch.cuda.empty_cache()
    counts = dict(K.launch_counts)
    rows, cv_table = {}, None
    for name in TEXT_CONFIGS:
        ((key, spec),) = runner.load_config(
            str(CONFIGS / f"{name}-benchmark.json")).items()
        row = runner.best_of(key, spec, runs=1, device=device)
        check = _check_text_row(name, spec, runner, Table, device)
        rows[name] = {k: row[k] for k in ("totalTimeMs", "dataGenTimeMs",
                                          "executeTimeMs", "deviceName",
                                          "inputRecordNum", "nativeThreads")}
        rows[name].update(check)
        log(f"  (c) {name}: " + json.dumps(rows[name], sort_keys=True))
        if device == "cuda":
            assert row["deviceName"] == torch.cuda.get_device_name(0)
    summary["configs"] = rows
    # the runner rows and their checks launch no kernel of the port
    assert dict(K.launch_counts) == counts, (counts, dict(K.launch_counts))
    ((_, cv_spec),) = runner.load_config(
        str(CONFIGS / "countvectorizer-benchmark.json")).items()
    cv_spec["inputData"]["paramMap"]["numValues"] = min(
        HOST_POOL_ROWS, cv_spec["inputData"]["paramMap"]["numValues"])
    cv_table = runner.build_generator(cv_spec, device).get_data()
    summary["host"] = _host_machinery(K, runner, cv_table)
    summary["demo"] = _benchmark_demo(K, runner, device, keep=keep)
    assert dict(K.launch_counts) == counts, (counts, dict(K.launch_counts))
    log(f"  launches in the text run: {counts}")
    log(f"  phase 16: {time.perf_counter() - started:.1f} s")
    log("  text:", json.dumps(summary, sort_keys=True, default=str))
    for kern in PATH_KERNELS["text"]:
        assert device != "cuda" or counts[kern] >= 1, counts
    return counts


# -- phase 17: the online estimators, CSR-fed linear models and host algorithms --

def _decayed_update(c, w, sums, counts, decay):
    """The JAX package's OnlineKMeans update (its ``models/online.py``
    :1051-1060) in float64 numpy, from a batch's sums and counts."""
    w = w * decay
    hit = counts > 0
    w = np.where(hit, w + counts, w)
    lam = np.where(hit, counts / np.where(hit, w, 1.0), 0.0)
    means = sums / np.maximum(counts, 1.0)[:, None]
    c = np.where(hit[:, None],
                 (1.0 - lam)[:, None] * c + lam[:, None] * means, c)
    return c, w


def _replay_online_kmeans(x, centroids, weights, batch, decay):
    """The JAX package's OnlineKMeans fit (its ``models/online.py``
    :1043-1060) in float64 numpy over the rows of ``x``, batch by batch:
    float64 distances, first-minimum assignment, float64 sums."""
    c, w = centroids.astype(np.float64), weights.astype(np.float64)
    k = c.shape[0]
    for lo in range(0, x.shape[0] - batch + 1, batch):
        xb = x[lo:lo + batch]
        d2 = ((xb * xb).sum(1)[:, None] - 2.0 * xb @ c.T
              + (c * c).sum(1)[None, :])
        assign = np.argmin(d2, axis=1)
        counts = np.bincount(assign, minlength=k).astype(np.float64)
        sums = np.zeros_like(c)
        np.add.at(sums, assign, xb)
        c, w = _decayed_update(c, w, sums, counts, decay)
    return c, w


class _StateRecorder:
    """A stream listener keeping the host state after every batch."""

    def __init__(self):
        self.states = []

    def on_epoch_watermark_incremented(self, batch, state):
        self.states.append(tuple(np.array(a) for a in state))

    def on_iteration_terminated(self, state):
        pass


def _online_kmeans_steps(K, x, init_c, init_w, states, device):
    """Every batch's update of a fit, held from the same state against
    (1) the plain one: the plain partials of the batch's rows on the
    float32 centroids the fit scored, then the float64 update; and (2) the
    JAX package's: float64 distances to the float64 centroids, float64
    sums, the float64 update. Rows assigned otherwise than by the kernel
    must be ties (TIE_RTOL); a batch without such rows is held by
    STEP_ATOL, one with them by CENTROID_ATOL. → {"plain"/"f64":
    (largest difference, tie rows)}."""
    prev_c, prev_w = init_c, init_w
    out = {"plain": (0.0, 0), "f64": (0.0, 0)}
    ones = torch.ones(STREAM_BATCH, dtype=torch.float32, device=device)
    for b, (c, w) in enumerate(states):
        xb = x[b * STREAM_BATCH:(b + 1) * STREAM_BATCH]
        c32 = torch.as_tensor(prev_c, dtype=torch.float32, device=device)
        c64 = torch.as_tensor(prev_c, dtype=torch.float64, device=device)
        labels = K.assign_nearest(xb, c32).long()
        packed = K.lloyd_partial_sums_plain(xb, ones, c32).double().cpu()
        plain = (packed[:, :-1].numpy(), packed[:, -1].numpy(),
                 tie_rows_ok(xb, c32, labels,
                             K.assign_nearest_plain(xb, c32).long()))
        xd = xb.double()
        d2 = ((xd * xd).sum(1)[:, None] - 2.0 * xd @ c64.T
              + (c64 * c64).sum(1)[None, :])
        l64 = torch.argmin(d2, dim=1)
        sums = torch.zeros_like(c64).index_add_(0, l64, xd)
        counts = torch.bincount(l64, minlength=c64.shape[0]).double()
        f64 = (sums.cpu().numpy(), counts.cpu().numpy(),
               tie_rows_ok(xb, c64, labels, l64))
        for name, (sums, counts, flips) in (("plain", plain), ("f64", f64)):
            want_c, _ = _decayed_update(prev_c, prev_w, sums, counts,
                                        STREAM_DECAY)
            diff = float(np.abs(c - want_c).max())
            assert diff <= (CENTROID_ATOL if flips else STEP_ATOL), (
                name, b, diff, flips)
            worst, ties = out[name]
            out[name] = (max(worst, diff), ties + flips)
        prev_c, prev_w = c, w
    return out


def _online_kmeans(K, runner, Table, device):
    """(a) OnlineKMeans over the KMeans config's table in STREAM_BATCH-row
    batches, from KMeansModelDataGenerator's initial model."""
    from flink_ml_tpu_torch.benchmark import datagen
    from flink_ml_tpu_torch.models import online

    spec = runner.load_config(str(CONFIG))["KMeans"]
    data = spec["inputData"]["paramMap"]
    k, d = spec["stage"]["paramMap"]["k"], data["vectorDim"]
    table = runner.build_generator(spec, device).get_data()
    n = table.num_rows
    gen = datagen.KMeansModelDataGenerator(device=device)
    gen.params_from_json({"arraySize": k, "vectorDim": d,
                          "seed": data["seed"]}, strict=True)
    init = gen.get_data()
    batches = n // STREAM_BATCH

    def fit(rows, dev):
        est = online.OnlineKMeans(
            k=k, global_batch_size=STREAM_BATCH, decay_factor=STREAM_DECAY,
            device=dev).set_initial_model_data(init)
        model, ms = _synced_ms(lambda: est.fit(rows))
        return est, model, ms

    before = dict(K.launch_counts)
    est, model, fit_ms = fit(table, device)
    launches = {name: K.launch_counts[name] - before[name]
                for name in ("lloyd_partial_sums", "reduce_partials",
                             "assign_nearest")}
    x = table.column("features")
    init_c = init.vectors("centroid", np.float64)
    init_w = init.scalars("weight", np.float64)
    c0 = torch.as_tensor(init_c, dtype=torch.float32, device=device)
    ones = torch.ones(STREAM_BATCH, dtype=torch.float32, device=device)
    head = table.take(slice(0, STREAM_REPLAY_BATCHES * STREAM_BATCH))
    with _uncounted(K):
        _, again, warm_ms = fit(table, device)
        # the first batch's partials against the plain version (TIE_RTOL)
        check_lloyd(K, x[:STREAM_BATCH], ones, c0, "online kmeans batch 0")
        batch_ms = (time_ms(lambda: K.lloyd_partial_sums(
            x[:STREAM_BATCH], ones, c0)) if device == "cuda" else None)
        # every batch's update against the plain one from the same state
        recorder = _StateRecorder()
        steps = online.OnlineKMeans(
            k=k, global_batch_size=STREAM_BATCH, decay_factor=STREAM_DECAY,
            device=device).set_initial_model_data(init)
        recorded = steps.set_iteration_config(
            None, listeners=[recorder]).fit(table)
        steps = _online_kmeans_steps(K, x, init_c, init_w, recorder.states,
                                     device)
        _, head_model, _ = fit(head, device)
    host_head = head.column("features").cpu()
    _, cpu_model, cpu_ms = fit(Table.from_columns(features=host_head), "cpu")
    replay_c, replay_w = _replay_online_kmeans(
        host_head.double().numpy(), init_c, init_w, STREAM_BATCH,
        STREAM_DECAY)
    path = "cuda-lloyd-stream" if device == "cuda" else "torch-lloyd-stream"
    assert est.last_execution_path == path, est.last_execution_path
    for other in (again, recorded):
        assert np.array_equal(other.centroids, model.centroids) and \
            np.array_equal(other.weights, model.weights), (
                "OnlineKMeans differs on a rerun")
    assert len(recorder.states) == batches
    assert model.centroids.shape == (k, d) and \
        np.isfinite(model.centroids).all()
    # independent runs on these structureless rows part at their first
    # tie flip and then drift apart, so the whole-prefix differences are
    # reported; the steps above are what is held
    cpu_diff = float(np.abs(head_model.centroids - cpu_model.centroids).max())
    replay_diff = float(np.abs(head_model.centroids - replay_c).max())
    if device == "cuda":
        assert launches == {"lloyd_partial_sums": batches,
                            "reduce_partials": batches,
                            "assign_nearest": 0}, launches
    row = {"rows": n, "dim": d, "k": k, "batches": batches,
           "path": est.last_execution_path, "fit_ms": fit_ms,
           "ms_per_batch": fit_ms / batches, "rerun_fit_ms": warm_ms,
           "rerun_ms_per_batch": warm_ms / batches,
           "lloyd_call_ms_at_batch": batch_ms, "launches": launches,
           "max_step_diff_vs_plain": steps["plain"][0],
           "step_tie_rows_vs_plain": steps["plain"][1],
           "max_step_diff_vs_f64": steps["f64"][0],
           "step_tie_rows_vs_f64": steps["f64"][1],
           "prefix_batches": STREAM_REPLAY_BATCHES,
           "prefix_cpu_fit_ms": cpu_ms,
           "prefix_max_centroid_diff_vs_cpu": cpu_diff,
           "prefix_max_centroid_diff_vs_f64_replay": replay_diff,
           "weight_sum": float(model.weights.sum())}
    log("  (a) OnlineKMeans: " + json.dumps(row, sort_keys=True))
    del table, x, host_head, head
    return row


def _online_scaler(K, runner, Table, device):
    """(b) OnlineStandardScaler over the LR config's table: count windows,
    the same with a constant offset (the cancellation case), and event-time
    tumbling windows on a seeded timestamp column."""
    from flink_ml_tpu_torch.common.window import (
        CountTumblingWindows,
        EventTimeTumblingWindows,
    )
    from flink_ml_tpu_torch.iteration.streaming import StreamTable
    from flink_ml_tpu_torch.models import online

    spec = runner.load_config(
        str(LINEAR_CONFIGS["logisticregression"]))["logisticregression"]
    x = runner.build_generator(spec, device).get_data().column("features")
    n = x.shape[0]

    def fit(data, windows, **kwargs):
        est = online.OnlineStandardScaler(
            input_col="features", output_col="scaled", windows=windows,
            device=device)
        return _synced_ms(lambda: est.fit(data, **kwargs))

    def check(model, ref, tag, std_rtol):
        mean, varsum = ref
        std = np.sqrt(varsum / (n - 1))
        mean_err = float(np.max(np.abs(model.mean - mean) / np.abs(mean)))
        std_err = float(np.max(np.abs(model.std - std) / std))
        assert mean_err <= SCALER_MEAN_RTOL, (tag, mean_err)
        assert std_err <= std_rtol, (tag, std_err)
        return {"mean_rel_err": mean_err, "std_rel_err": std_err}

    row = {"rows": n, "dim": x.shape[1]}
    windows = CountTumblingWindows.of(SCALER_WINDOW)
    model, row["count_fit_ms"] = fit(Table.from_columns(features=x), windows)
    again, row["count_rerun_ms"] = fit(Table.from_columns(features=x),
                                       windows)
    assert np.array_equal(again.std, model.std)
    assert len(model.history) == n // SCALER_WINDOW
    assert model.model_version == n // SCALER_WINDOW - 1
    row["ms_per_window"] = row["count_fit_ms"] / len(model.history)
    row["rerun_ms_per_window"] = row["count_rerun_ms"] / len(model.history)
    ref = _f64_moments(x)
    row["count"] = check(model, ref, "count windows", SCALER_STD_RTOL)
    head = x[:FEATURE_ROWS]
    out = model.transform(Table.from_columns(features=head))[0]["scaled"]
    assert out.dtype == torch.float32 and out.device == head.device
    want = head.double() / torch.as_tensor(model.std, device=head.device)
    within_sum_tol(out.double(), want, "online scaler transform")

    shifted = x + SCALER_OFFSET
    model, row["offset_fit_ms"] = fit(Table.from_columns(features=shifted),
                                      windows)
    row["offset"] = check(model, _f64_moments(shifted), "offset",
                          SCALER_OFFSET_STD_RTOL)
    del shifted
    if device == "cuda":
        torch.cuda.empty_cache()

    ts = np.cumsum(np.random.default_rng(SCALER_TS_SEED).integers(
        0, 3, n)).astype(np.int64)
    stream = StreamTable.from_table(Table.from_columns(features=x, ts=ts),
                                    SCALER_WINDOW)
    model, row["event_fit_ms"] = fit(
        stream, EventTimeTumblingWindows.of(SCALER_EVENT_MS),
        timestamp_col="ts")
    ends = ((np.unique(ts // SCALER_EVENT_MS) + 1) * SCALER_EVENT_MS)
    assert model.history_timestamps == ends.tolist()
    row["event_windows"] = len(model.history)
    row["event"] = check(model, ref, "event-time windows", SCALER_STD_RTOL)
    log("  (b) OnlineStandardScaler: " + json.dumps(row, sort_keys=True))
    del x, stream, head, out
    return row


def phase_online(K, runner, Table, device="cuda"):
    """Phase 17, the online path: (a) OnlineKMeans and (b)
    OnlineStandardScaler on the card (see the module docstring).
    ``device="cpu"`` runs the same logic on the CPU, without launch counts
    (a rehearsal, with ``runner.load_config`` patched to cut the rows)."""
    log("phase 17: the online estimators on the card")
    started = time.perf_counter()
    K.reset_launch_counts()
    summary = {"online_kmeans": _online_kmeans(K, runner, Table, device)}
    summary["online_scaler"] = _online_scaler(K, runner, Table, device)
    counts = dict(K.launch_counts)
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"  launches in the online run: {counts}")
    log(f"  phase 17 (a, b): {time.perf_counter() - started:.1f} s")
    log("  online:", json.dumps(summary, sort_keys=True, default=str))
    for kern in PATH_KERNELS["online"]:
        assert device != "cuda" or counts[kern] >= 1, counts
    return counts


class _Crash(Exception):
    pass


def _hashed_table(runner, Table, device, keep):
    """The hashingtf config's table through HashingTF (2^18 wide) with
    phase 16 (b)'s labels: ``keep``'s copy when phase 16 left one."""
    if keep and "hashed" in keep:
        return keep.pop("hashed"), keep.pop("labels")
    ((_, spec),) = runner.load_config(
        str(CONFIGS / "hashingtf-benchmark.json")).items()
    table = runner.build_generator(spec, device).get_data()
    labels = _text_labels(table.column("input"),
                          spec["inputData"]["paramMap"]["seed"])
    tf = runner.build_stage(spec, device).set_output_col("tf")
    return tf.transform(table)[0].column("tf"), labels


def phase_sparse_linear(K, runner, Table, device="cuda", keep=None):
    """Phase 17 (c): LogisticRegression and LinearSVC on the hashed CSR
    column, on the card's segment kernel (see the module docstring)."""
    from flink_ml_tpu_torch.iteration import (
        CheckpointManager,
        IterationConfig,
        IterationListener,
    )
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.models import classification

    log("phase 17 (c): CSR-fed linear models on the card")
    started = time.perf_counter()
    spec = runner.load_config(
        str(LINEAR_CONFIGS["logisticregression"]))["logisticregression"]
    pm = spec["stage"]["paramMap"]
    params = dict(max_iter=pm["maxIter"], reg=pm["reg"],
                  elastic_net=pm["elasticNet"],
                  learning_rate=pm["learningRate"],
                  global_batch_size=pm["globalBatchSize"], tol=pm["tol"])
    (col, labels), prep_ms = _synced_ms(
        lambda: _hashed_table(runner, Table, device, keep))
    data = Table.from_columns(features=col, label=labels)
    m = col.to_csr()
    n, dim = m.shape

    class CrashAt(IterationListener):
        def on_epoch_watermark_incremented(self, epoch, carry):
            if epoch == SPARSE_CRASH_ROUND:
                raise _Crash()

    def fit(cls, dev=device, config=None, listeners=()):
        est = cls(device=dev, **params)
        if config is not None:
            est.set_iteration_config(config, listeners)
        model, ms = _synced_ms(lambda: est.fit(data))
        return est, model, ms

    path = "cuda-csr" if device == "cuda" else "torch-csr"
    row = {"rows": n, "dim": dim, "nnz": int(m.nnz), "prep_ms": prep_ms}
    K.reset_launch_counts()
    with _never_densified(sparse):
        est, model, row["lr_fit_ms"] = fit(classification.LogisticRegression)
        row["lr_launches"] = K.launch_counts["segment_reduce_sum"]
        out, row["lr_transform_ms"] = _synced_ms(
            lambda: model.transform(data)[0])
        pred = out["prediction"].cpu().numpy()
        row["lr_accuracy"] = float(np.mean(pred == labels))
        svc, svc_model, row["svc_fit_ms"] = fit(classification.LinearSVC)
        svc_pred = svc_model.transform(data)[0]["prediction"].cpu().numpy()
        row["svc_accuracy"] = float(np.mean(svc_pred == labels))
        with tempfile.TemporaryDirectory() as tmp:
            cfg = IterationConfig(mode="host",
                                  checkpoint_interval=SPARSE_CKPT_INTERVAL,
                                  checkpoint_manager=CheckpointManager(tmp))
            try:
                fit(classification.LogisticRegression, config=cfg,
                    listeners=[CrashAt()])
                raise AssertionError("the host-rounds fit did not crash")
            except _Crash:
                pass
            rounds, resumed, row["resumed_fit_ms"] = fit(
                classification.LogisticRegression, config=cfg)
        counts = dict(K.launch_counts)
        with _uncounted(K):
            _, again, _ = fit(classification.LogisticRegression)
            row.update(_csr_split(K, m, labels, params, device))
        _, cpu_model, row["cpu_fit_ms"] = fit(
            classification.LogisticRegression, dev="cpu")
    assert est.last_execution_path == path, est.last_execution_path
    assert svc.last_execution_path == path, svc.last_execution_path
    assert rounds.last_execution_path == path + "-rounds"
    rounds_per_fit = params["max_iter"]
    if device == "cuda":
        assert row["lr_launches"] == 2 * rounds_per_fit, row["lr_launches"]
    assert np.array_equal(again.coefficients, model.coefficients), (
        "the CSR fit differs on a rerun")
    assert np.array_equal(resumed.coefficients, model.coefficients), (
        "the resumed host-rounds fit differs from the uninterrupted one")
    diff = np.abs(model.coefficients - cpu_model.coefficients)
    excess = diff - BIG_FIT_RTOL * np.abs(cpu_model.coefficients) - \
        BIG_FIT_ATOL
    assert excess.max() <= 0, float(excess.max())
    assert row["lr_accuracy"] >= SPARSE_ACCURACY, row["lr_accuracy"]
    assert row["svc_accuracy"] >= SPARSE_ACCURACY, row["svc_accuracy"]
    row.update({"path": est.last_execution_path,
                "max_coeff_diff_vs_cpu": float(diff.max()),
                "nonzero_coefficients": int((model.coefficients != 0).sum()),
                "launches": counts})
    log("  (c) CSR linear fits: " + json.dumps(row, sort_keys=True))
    log(f"  phase 17 (c): {time.perf_counter() - started:.1f} s")
    del data, col, m, out
    for kern in PATH_KERNELS["sparse_linear"]:
        assert device != "cuda" or counts[kern] >= 1, counts
    return counts


def _csr_split(K, m, labels, params, device):
    """Where a CSR fit's time goes: the matrix's placement on the device,
    the rounds alone on the placed data, and the two segment sums of the
    first window (the per-row dots, then the gradient over the feature
    width), eagerly."""
    from flink_ml_tpu_torch.ops import losses, optimizer
    from flink_ml_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([torch.device(device)])
    data, place_ms = _synced_ms(
        lambda: optimizer.ShardData.place_csr(mesh, m, labels))
    prm = optimizer.SGDParams(
        learning_rate=params["learning_rate"],
        global_batch_size=params["global_batch_size"],
        max_iter=params["max_iter"], tol=params["tol"], reg=params["reg"],
        elastic_net=params["elastic_net"])
    dim = m.shape[1]

    def rounds():
        return optimizer._masked_rounds(
            optimizer.csr_batch_terms, losses.BinaryLogisticLoss.NAME, prm,
            mesh, False, data, torch.zeros(dim, device=device), (),
            np.zeros(1, np.int32), prm.max_iter)

    _, rounds_ms = _synced_ms(rounds)
    shard = data.x.parts[0]
    lb = min(prm.global_batch_size, m.shape[0])
    hi = int(shard.indptr_host[lb])
    vals, cols = shard.data[:hi], shard.indices[:hi]
    local = shard.rows[:hi]
    out = {"place_ms": place_ms, "rounds_ms": rounds_ms,
           "rounds_ms_per_round": rounds_ms / prm.max_iter,
           "window_values": hi}
    if device == "cuda":
        out["dots_call_ms"] = time_ms(
            lambda: K.segment_reduce_sum(vals, local, lb))
        out["grad_call_ms"] = time_ms(
            lambda: K.segment_reduce_sum(vals, cols, dim))
    return out


def _swing_log(seed, users, items, per_user):
    rng = np.random.default_rng(seed)
    user = np.repeat(np.arange(users, dtype=np.int64), per_user)
    item = rng.integers(0, items, users * per_user).astype(np.int64)
    return user, item


def phase_host_algorithms(K, runner, Table, device="cuda"):
    """Phase 17 (d, e): the agglomerativeclustering config through
    ``run_benchmarks``, and Swing's native scorer; neither launches a
    kernel of the port."""
    from flink_ml_tpu_torch.models.recommendation import Swing

    log("phase 17 (d, e): AgglomerativeClustering and Swing")
    started = time.perf_counter()
    counts = dict(K.launch_counts)
    config = runner.load_config(
        str(CONFIGS / "agglomerativeclustering-benchmark.json"))
    ((name, entry),) = runner.run_benchmarks(config, device).items()
    assert "exception" not in entry, entry
    res = entry["results"]
    want_name = (torch.cuda.get_device_name(0) if device == "cuda"
                 else "cpu")
    assert res["deviceName"] == want_name, res["deviceName"]
    n = config[name]["inputData"]["paramMap"]["numValues"]
    assert res["inputRecordNum"] == n and res["outputRecordNum"] == 2 * n - 1
    agg = {k: res[k] for k in ("totalTimeMs", "dataGenTimeMs",
                               "executeTimeMs", "deviceName",
                               "inputRecordNum", "outputRecordNum")}
    log(f"  (d) {name}: " + json.dumps(agg, sort_keys=True))

    user, item = _swing_log(SWING_SEED, SWING_USERS, SWING_ITEMS,
                            SWING_PER_USER)
    op = Swing(device=device)
    out, swing_ms = _synced_ms(lambda: op.transform(
        Table.from_columns(user=user, item=item))[0])
    # the oracle on a prefix of the log: the same groupings, both scorers
    head = SWING_PREFIX_USERS * SWING_PER_USER
    groups = op._groupings(user[:head], item[:head])
    native_ranked = op._score_native(*groups, op.alpha2)
    assert native_ranked == op._score_python(*groups, op.alpha2), (
        "the native Swing scorer differs from the Python oracle")
    full_groups = op._groupings(user, item)
    _, native_ms = _synced_ms(lambda: op._score_native(*full_groups,
                                                       op.alpha2))
    recs = list(out.column(op.output_col))
    assert out.num_rows > 0 and all(
        len(r.split(";")) <= op.k for r in recs)
    swing = {"purchases": int(user.size), "users": SWING_USERS,
             "items": SWING_ITEMS, "prefix_purchases": head,
             "prefix_items_checked": len(native_ranked),
             "output_rows": out.num_rows, "transform_ms": swing_ms,
             "native_scorer_ms": native_ms}
    log("  (e) Swing: " + json.dumps(swing, sort_keys=True))
    log(f"  phase 17 (d, e): {time.perf_counter() - started:.1f} s")
    assert dict(K.launch_counts) == counts, (counts, dict(K.launch_counts))
    return {"agglomerative": agg, "swing": swing}


def _cli(argv):
    """(exit code, ms) of one ``flink-ml-tpu-torch-trace`` view, run in
    this process with its output kept off the smoke's stdout."""
    import io

    from flink_ml_tpu_torch.observability import cli

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = cli.main(list(argv))
    return rc, (time.perf_counter() - t) * 1e3


def _shard_series(snap, name, kind="gauges"):
    """``{shard: value}`` of one ``ml.shard`` series of a snapshot."""
    from flink_ml_tpu_torch.observability.health import _parse_labels

    out = {}
    for key, value in ((snap.get("ml.shard") or {}).get(kind) or {}).items():
        base, _, rest = key.partition("{")
        if base == name:
            out[int(_parse_labels(rest[:-1])["shard"])] = value
    return out


def phase_mesh_observability(K, runner, card_line, device="cuda"):
    """Phase 18: mesh telemetry, mesh-sharded serving and the trace CLI.
    (a) the KMeans config in host rounds and the LR config in segments of
    MESH_SEGMENT rounds, each fitted on MESH_SHARDS virtual shards traced
    with the lock watchdog armed, bit-identical to the same fit unarmed,
    then a KMeans transform; (b) phase 13's servable and traffic on
    SERVE_SHARDS shards and on one, traced; (c) the port's CLI over those
    trace dirs. Returns the path's launches."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.common.locks import LOCKCHECK_ENV
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.iteration.iteration import IterationConfig
    from flink_ml_tpu_torch.linalg.vectors import DenseVector
    from flink_ml_tpu_torch.models.classification import LogisticRegression
    from flink_ml_tpu_torch.observability import (exporters, meshstats, path,
                                                  profiling, tracing)
    from flink_ml_tpu_torch.parallel import collective as C
    from flink_ml_tpu_torch.parallel import create_mesh
    from flink_ml_tpu_torch.servable import DataFrame, DataTypes, Row
    from flink_ml_tpu_torch.serving import (BatcherConfig, LoadGenConfig,
                                            MicroBatcher, run_loadgen, warm)

    log("phase 18: mesh telemetry, sharded serving and the trace CLI")
    started = time.perf_counter()
    dev = torch.device(device)
    platform = "gpu" if dev.type == "cuda" else dev.type
    mesh = create_mesh((MESH_SHARDS,), devices=[dev] * MESH_SHARDS)
    tracer = tracing.tracer
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dirs = {}
    summary = {"card": card_line}
    K.reset_launch_counts()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def traced(tag, call, **env):
        """``call()`` into the trace dir ``tag`` (lock watchdog armed), from
        an empty registry → (result, host ms, ended by a synchronize)."""
        trace_dir = dirs[tag] = os.path.join(workdir, tag)
        exporters.metrics.clear()
        armed = {tracing.TRACE_DIR_ENV: trace_dir, LOCKCHECK_ENV: 1, **env}
        with _armed(**armed):
            sync()
            t = time.perf_counter()
            result = call()
            sync()
            ms = (time.perf_counter() - t) * 1e3
        tracer.shutdown()
        return result, ms

    def untraced(call):
        sync()
        t = time.perf_counter()
        result = call()
        sync()
        return result, (time.perf_counter() - t) * 1e3

    try:
        # (a) the two fits: unarmed, armed three times (the last two are
        # the warm pair `diff` holds), unarmed
        fits = {}
        cases = [
            ("kmeans", runner.load_config(str(CONFIG))["KMeans"],
             lambda est: est.set_iteration_config(IterationConfig(
                 mode="host"))),
            ("lr", runner.load_config(
                str(LINEAR_CONFIGS["logisticregression"]))[
                    "logisticregression"],
             None),
        ]
        for name, spec, setup in cases:
            table = runner.build_generator(spec, device=device).get_data()
            max_iter = spec["stage"]["paramMap"]["maxIter"]
            n = table.num_rows
            seq = itertools.count()

            def fit():
                est = runner.build_stage(spec, device=device, mesh=mesh)
                if setup is not None:
                    est = setup(est)
                else:
                    est.set_iteration_config(IterationConfig(
                        checkpoint_interval=MESH_SEGMENT,
                        checkpoint_manager=CheckpointManager(os.path.join(
                            workdir, f"{name}-ckpt-{next(seq)}"))))
                model = est.fit(table)
                return (np.concatenate([model.centroids.ravel(),
                                        model.weights])
                        if name == "kmeans" else model.coefficients), model

            (want, _), unarmed0 = untraced(fit)
            armed = []
            for i in range(3):
                (got, model), ms = traced(f"{name}-{i}", fit)
                assert np.array_equal(got, want), (
                    f"{name}: the armed fit differs from the unarmed one")
                armed.append(ms)
            (again, _), unarmed1 = untraced(fit)
            assert np.array_equal(again, want)
            trace = dirs[f"{name}-0"]
            snap = exporters.read_metrics(trace)
            topo = meshstats.read_mesh(trace)
            assert topo["device_count"] == MESH_SHARDS and \
                topo["platform"] == platform, topo
            rows = _shard_series(snap, "rows")
            assert rows == {s: n // MESH_SHARDS
                            for s in range(MESH_SHARDS)}, rows
            ready = _shard_series(snap, "readyMs", "histograms")
            rounds = (max_iter if name == "kmeans"
                      else max_iter // MESH_SEGMENT)
            assert sorted(ready) == list(range(MESH_SHARDS)) and all(
                h["count"] == rounds for h in ready.values()), ready
            ready_ms = sum(h["sum"] for h in ready.values())
            fits[name] = {
                "rows": n, "rows_per_shard": rows[0],
                "unarmed_ms": min(unarmed0, unarmed1),
                "armed_ms": min(armed), "armed_runs_ms": armed,
                "unarmed_runs_ms": [unarmed0, unarmed1],
                "ready_observations": rounds,
                "ready_wait_ms_per_observation": ready_ms / rounds,
                "ready_ms_by_shard": {s: h["sum"] / rounds
                                      for s, h in sorted(ready.items())}}
            if name == "kmeans":
                bad = _shard_series(snap, "nonFinite")
                assert bad == {s: 0 for s in range(MESH_SHARDS)}, bad
                # the transform of the fitted model (assign_nearest)
                labels = model.transform(table)[0].column(
                    model.prediction_col)
                assert labels.shape == (n,) and labels.device.type == \
                    dev.type
                # a placed copy with NaNs in shard 5 only
                x = table.vectors("features").clone()
                per = n // MESH_SHARDS
                x[5 * per + 7, 3] = float("nan")
                x[5 * per + per - 1, 0] = float("nan")
                counts = meshstats.record_input_health(
                    "KMeans", mesh, C.ensure_on_mesh(mesh, x))
                assert counts == [2 if s == 5 else 0
                                  for s in range(MESH_SHARDS)], counts
                fits[name]["nan_probe"] = counts
                del x
            log(f"  (a) {name} on {MESH_SHARDS} shards: "
                + json.dumps(fits[name], sort_keys=True))
            del table
        summary["fits"] = fits

        # the profiled LR fit on the mesh (efficiency)
        spec = cases[1][1]
        table = runner.build_generator(spec, device=device).get_data()
        profiling.reset()
        traced("lr-profiled", lambda: runner.build_stage(
            spec, device=device, mesh=mesh).fit(table),
            **{profiling.CAPTURE_ENV: 1})
        del table

        # (b) phase 13's servable and traffic, on SERVE_SHARDS shards and
        # one: an LR fit of 1,000,000 seeded rows with hyperplane labels
        spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
        d = spec["inputData"]["paramMap"]["vectorDim"]
        lr_params = cases[1][1]["stage"]["paramMap"]
        gen = torch.Generator(device=dev).manual_seed(31)
        x = torch.randn(SERVE_FIT_ROWS, d, generator=gen, device=dev)
        truth = np.random.default_rng(37).normal(size=d)
        margin = x @ torch.as_tensor(truth, dtype=torch.float32, device=dev)
        table = Table.from_columns(
            features=x, label=(margin > margin.median()).to(torch.float32))
        coef = np.asarray(LogisticRegression(
            device=device, max_iter=lr_params["maxIter"],
            global_batch_size=lr_params["globalBatchSize"],
            learning_rate=lr_params["learningRate"]).fit(table).coefficients,
            np.float64)
        del table, x, margin

        def frame_rows(i):
            return np.random.default_rng(1000 + i).normal(
                size=(SERVE_SIZES[i % len(SERVE_SIZES)], d))

        def frame(i):
            return DataFrame(["features"], [DataTypes.vector()],
                             [Row([DenseVector(r)]) for r in frame_rows(i)])

        # alternated, so neither mesh alone pays the first run's costs
        serving = {SERVE_SHARDS: [], 1: []}
        for run, shards in enumerate((SERVE_SHARDS, 1, 1, SERVE_SHARDS)):
            served, ticks, results = {}, [], {}
            sv = _recording_servable(coef, 1, served, ticks, device)
            sv.serving_name = f"lr@shards{shards}"
            smesh = create_mesh((shards,), devices=[dev] * shards)

            def feedback(i, frm, fut, results=results):
                results[i] = (fut.request_id, fut.result())

            def serve():
                batcher = MicroBatcher(sv, BatcherConfig(
                    buckets=(8, 32, 128), window_ms=1.0), mesh=smesh).start()
                try:
                    report = warm(batcher, gate=False)
                    start = len(ticks)
                    res = run_loadgen(batcher.submit, frame, LoadGenConfig(
                        mode="closed", requests=400, concurrency=64),
                        feedback=feedback)
                    return report, res, ticks[start:], batcher.status()
                finally:
                    batcher.stop()
                    # serving opens no stage span: snapshot the registry
                    # (and the lock dump) into the dir here
                    exporters.dump_metrics(tracer.trace_dir)

            (report, res, load_ticks, status), _ = traced(
                f"serve-{shards}-{run}", serve)
            assert res["ok"] == 400 and res["errors"] == 0 and \
                res["rejected"] == 0, res
            assert sorted(results) == list(range(400)), len(results)
            versions, near_zero, worst = _check_responses(
                [(seq, frame_rows(i), out)
                 for i, (seq, out) in results.items()], served, {1: coef})
            assert report["mesh_devices"] == shards, report
            assert report["sharded_buckets"] == (
                [8, 32, 128] if shards > 1 else []), report
            assert status["sharded_dispatch"] == (shards > 1), status
            tick_ms = [t[3] for t in load_ticks]
            serving[shards].append({
                "requests_per_s": res["throughput_rps"],
                "rows_per_s": res["rows_per_s"],
                "latency_ms": res["latency_ms"], "wall_s": res["wall_s"],
                "ticks": len(tick_ms),
                "tick_median_ms": statistics.median(tick_ms),
                "tick_max_ms": max(tick_ms),
                "product_median_ms": statistics.median(
                    t[4] for t in load_ticks),
                "near_zero_rows": near_zero, "max_abs_dot_err": worst,
                "warmup_ms": report["total_ms"]})
            lat = res["latency_ms"]
            log(f"  (b) run {run}, {shards} shard(s): "
                f"{res['throughput_rps']} requests/s, p50 {lat['p50']} ms, "
                f"p99 {lat['p99']} ms, tick median "
                f"{statistics.median(tick_ms):.3f} ms over {len(tick_ms)} "
                f"ticks; max |dot err| {worst:.3g}")
        paths = {}
        for tag in (f"serve-{SERVE_SHARDS}-0", f"serve-{SERVE_SHARDS}-3"):
            report = path.analyze_paths(exporters.read_spans(dirs[tag]))
            assert report["requests"]["count"] == 400, report["requests"]
            assert report["requests"]["coverage"] >= 0.9, report["requests"]
            snap = exporters.read_metrics(dirs[tag])
            assert sorted(_shard_series(snap, "rows")) == list(
                range(SERVE_SHARDS))
            paths[tag] = {k: report["requests"][k] for k in (
                "count", "coverage", "queue_share", "segment_share")}
        summary["serving"] = {
            **{f"{k}_shards": v for k, v in serving.items()},
            "path": paths}

        # (c) the CLI over those dirs, each view's exit code and wall ms
        fit_dirs = [dirs["kmeans-0"], dirs["lr-0"]]
        serve_dir = dirs[f"serve-{SERVE_SHARDS}-0"]
        gates = [
            (["summary", dirs["kmeans-0"], "--check"], 0),
            (["summary", serve_dir, "--check"], 0),
            *[(["shards", d_, "--check"], 0) for d_ in fit_dirs],
            (["shards", serve_dir, "--check"], 0),
            (["shards", dirs["serve-1-1"], "--check"], 2),
            (["path", serve_dir, "--check"], 0),
            (["path", dirs["kmeans-0"], "--json"], 0),
            (["locks", serve_dir, "--check"], 0),
            *[(["health", d_, "--check"], 0) for d_ in fit_dirs],
            (["efficiency", dirs["lr-profiled"]], 0),
            (["diff", dirs["kmeans-1"], dirs["kmeans-2"], "--budget",
              str(DIFF_BUDGET_PCT), "--min-ms", str(DIFF_MIN_MS)], 0),
            (["diff", dirs["lr-1"], dirs["lr-2"], "--budget",
              str(DIFF_BUDGET_PCT), "--min-ms", str(DIFF_MIN_MS)], 0),
        ]
        views = []
        for argv, want in gates:
            rc, ms = _cli(argv)
            views.append({"view": argv[0], "dir": os.path.basename(argv[1]),
                          "rc": rc, "ms": ms})
            assert rc == want, (argv, rc, want)
        # the module entry point, as a user runs it
        proc = subprocess.run(
            [sys.executable, "-m", "flink_ml_tpu_torch.observability.cli",
             "shards", dirs["kmeans-0"], "--check"],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(REPO)] + [p for p in os.environ.get(
                    "PYTHONPATH", "").split(os.pathsep) if p])))
        assert proc.returncode == 0, proc.stderr
        assert f"{MESH_SHARDS} device(s)" in proc.stdout, proc.stdout
        for tag in ("kmeans-0", "lr-0"):
            rc, _ = _cli(["locks", dirs[tag]])
            views.append({"view": "locks", "dir": tag, "rc": rc,
                          "ms": None})
        summary["cli"] = views
        log("  (c) CLI: " + json.dumps(views))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        profiling.reset()
    counts = dict(K.launch_counts)
    if dev.type == "cuda":  # the CPU runs the plain versions: no launches
        for kern in PATH_KERNELS["mesh_observability"]:
            assert counts[kern] >= 1, (kern, counts)
    summary["launches"] = {k: v for k, v in counts.items() if v}
    summary["seconds"] = time.perf_counter() - started
    log("  mesh observability:", json.dumps(summary, sort_keys=True,
                                            default=str))
    return counts


def _fit_ms(est, table, reps=2):
    """(model, best host ms of ``reps`` fits, launches of one fit)."""
    from flink_ml_tpu_torch.ops import kernels

    runs = []
    for _ in range(reps):
        before = dict(kernels.launch_counts)
        model, ms = _timed_fit(est, table)
        runs.append((ms, model, {k: v - before[k]
                                 for k, v in kernels.launch_counts.items()
                                 if v - before[k]}))
    ms, model, launched = min(runs, key=lambda r: r[0])
    return model, ms, launched


def _level_bytes():
    """(inter-level payload bytes, inter-level sums) recorded so far
    (``ml.collective levelPayloadBytes`` / ``levelOps``, level inter)."""
    from flink_ml_tpu_torch.common.metrics import metrics

    snap = metrics.snapshot().get("ml.collective", {})
    nbytes = sum(float(h.get("sum", 0.0))
                 for k, h in snap.get("histograms", {}).items()
                 if k.startswith("levelPayloadBytes")
                 and 'level="inter"' in k)
    ops = sum(float(v) for k, v in snap.get("counters", {}).items()
              if k.startswith("levelOps") and 'level="inter"' in k)
    return nbytes, ops


def _within(got, want, rtol, atol):
    """The largest excess of |got - want| over atol + rtol * |want| (<= 0
    when within), and max |got - want|."""
    diff = (got - want).abs()
    return (float((diff - (atol + rtol * want.abs())).max()),
            float(diff.max()))


def _attention_run(fn, reps=2):
    """(output, best ms, peak bytes above the memory held before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, times = None, []
    for _ in range(reps):
        out = None
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return out, min(times), torch.cuda.max_memory_allocated() - base


_SEQ_RANK_PROGRAM = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from flink_ml_tpu_torch.common.metrics import metrics
from flink_ml_tpu_torch.parallel import distributed
from flink_ml_tpu_torch.parallel.mesh import Mesh
from flink_ml_tpu_torch.parallel.sequence import sharded_attention

assert distributed.init_from_env()
rank = distributed.process_index()
dev = torch.device(os.environ[distributed.DEVICE_ENV])
mesh = Mesh([dev] * 2, ("seq",), group=dist.group.WORLD, rank=rank,
            processes=2)
data = np.load(sys.argv[1])
q, k, v = (torch.as_tensor(data[n], device=dev) for n in "qkv")
out = {}
for kind in ("ring", "ulysses"):
    for causal in (False, True):
        got = sharded_attention(mesh, q, k, v, kind=kind, causal=causal)
        out[f"{kind}-{int(causal)}"] = got.cpu().numpy()
np.savez(sys.argv[2] + f"-{rank}.npz", **out)
snap = metrics.snapshot().get("ml.collective", {}).get("counters", {})
print(json.dumps({"send_recv": int(sum(
    v for key, v in snap.items()
    if key.startswith("stagedOps") and 'op="send_recv"' in key))}))
dist.destroy_process_group()
"""


def phase_parallel_layer(K, runner, Table, card_line, device="cuda"):
    """Phase 19: the rest of the parallel layer, with the counts at 0:
    (a) the LR config on a (data 4, model 2) mesh of virtual shards; (b)
    the KMeans and LR configs on a (dcn 2, data 4) mesh, flat and
    two-level; (c) ring and Ulysses attention over SEQ_SHARDS ``seq``
    shards against full attention; (d) the gloo probe on two ranks that
    share the card, then ``run_elastic``: two ranks fit the LR config,
    rank 1 is killed at a boundary, one rank resumes. Returns the path's
    launches (the ranks' included)."""
    from flink_ml_tpu_torch.iteration.iteration import IterationConfig
    from flink_ml_tpu_torch.observability import exporters, fleet, tracing
    from flink_ml_tpu_torch.parallel import collective as C
    from flink_ml_tpu_torch.parallel import (create_hybrid_mesh, create_mesh,
                                             distributed, elastic)
    from flink_ml_tpu_torch.parallel.sequence import (full_attention,
                                                      sharded_attention)
    from flink_ml_tpu_torch.resilience import RetryPolicy

    log("phase 19: tensor-parallel and hybrid meshes, sequence attention, "
        "the elastic multi-process fit")
    started = time.perf_counter()
    dev = torch.device(device)
    K.reset_launch_counts()
    summary = {"card": card_line}
    lr_spec = runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))[
        "logisticregression"]
    rounds = lr_spec["stage"]["paramMap"]["maxIter"]
    lr_table = runner.build_generator(lr_spec).get_data()
    n, d = lr_table.num_rows, lr_table.vectors("features").shape[1]

    def lr_fit(mesh, reps=2):
        return _fit_ms(runner.build_stage(lr_spec, mesh=mesh), lr_table, reps)

    # (a) tensor parallelism: the 4 data shards each split over 2 model
    # shards; its rows per round are the 1-D 4-shard fit's, so that fit is
    # the one it equals up to the float32 reduce order
    tp_mesh = create_mesh((4, 2), ("data", "model"), devices=[dev] * 8)
    tp, tp_ms, tp_l = lr_fit(tp_mesh)
    # the CPU runs the plain versions: launches are counted on the card
    on_card = dev.type == "cuda"
    assert tp_l == {"reduce_partials": rounds * (4 + 1)} or not on_card, tp_l
    four, four_ms, four_l = lr_fit(create_mesh((4,), devices=[dev] * 4))
    eight, eight_ms, _ = lr_fit(create_mesh((8,), devices=[dev] * 8))
    diff = np.abs(tp.coefficients - four.coefficients)
    assert np.all(diff <= COEFF_RTOL * np.abs(four.coefficients)
                  + COEFF_ATOL), diff.max()
    summary["a"] = {
        "tp_ms": tp_ms, "p4_ms": four_ms, "p8_ms": eight_ms,
        "tp_launches": tp_l, "p4_launches": four_l,
        "max_diff_vs_p4": float(diff.max()),
        "max_diff_vs_p8": float(np.abs(tp.coefficients
                                       - eight.coefficients).max())}
    log(f"  (a) LR {n} x {d}, {rounds} rounds on (data 4, model 2): fit ms "
        f"{tp_ms:.3f} (1-D 4 shards {four_ms:.3f}, 8 shards "
        f"{eight_ms:.3f}); launches {tp_l}; max|diff| against 4 shards "
        f"{diff.max():.3g}, against 8 shards "
        f"{summary['a']['max_diff_vs_p8']:.3g} (other batches)")

    # (b) the hybrid mesh: flat equals the 1-D 8-shard fit bit for bit;
    # two-level within reassociation, its inter level 1/4 of the padded
    # flat payload
    hybrid = create_hybrid_mesh((4,), (2,), devices=[dev] * 8)
    flat8 = create_mesh((8,), devices=[dev] * 8)
    km_spec = runner.load_config(str(CONFIG))["KMeans"]
    km_table = runner.build_generator(km_spec).get_data()
    k_clusters = km_spec["stage"]["paramMap"]["k"]

    def km_fit(mesh, reps=2):
        return _fit_ms(runner.build_stage(km_spec, mesh=mesh), km_table,
                       reps)

    hyb, models = {}, {}
    for name, fit, width in (("KMeans", km_fit, k_clusters),
                             ("LR", lr_fit, d + 2)):
        with mock.patch.dict(os.environ, {C.HIER_ENV: "0"}):
            one_d, one_d_ms, _ = fit(flat8)
            before = _level_bytes()
            flat, flat_ms, flat_l = fit(hybrid, reps=1)
            after = _level_bytes()
        flat_bytes, flat_sums = (after[0] - before[0], after[1] - before[1])
        with mock.patch.dict(os.environ, {C.HIER_ENV: "1"}):
            before = _level_bytes()
            two, two_ms, two_l = fit(hybrid, reps=1)
            after = _level_bytes()
            _, two_best, _ = fit(hybrid, reps=1)
        two_bytes, two_sums = (after[0] - before[0], after[1] - before[1])
        if name == "KMeans":
            got_f, want_f = flat.centroids, one_d.centroids
            got_h = two.centroids
        else:
            got_f, want_f = flat.coefficients, one_d.coefficients
            got_h = two.coefficients
        assert np.array_equal(got_f, want_f), f"{name} flat hybrid differs"
        h_diff = float(np.abs(got_h - want_f).max())
        if name == "KMeans":
            assert h_diff <= CENTROID_ATOL, h_diff
        else:
            assert np.all(np.abs(got_h - want_f) <= COEFF_RTOL * np.abs(
                want_f) + COEFF_ATOL), h_diff
        # one inter-level observation a cross-shard sum; the two-level
        # route records ceil(width / 4) / width of the flat payload (dim 0
        # of the summed value padded to the 4 inner shards). In-process
        # nothing crosses a slow link: this is the JAX package's per-shard
        # accounting of a mesh of separate devices, not measured traffic
        assert two_sums == flat_sums >= 1, (flat_sums, two_sums)
        per_flat, per_two = flat_bytes / flat_sums, two_bytes / two_sums
        want_ratio = math.ceil(width / 4) / width
        assert abs(per_two / per_flat - want_ratio) < 1e-12, (
            per_two, per_flat, want_ratio)
        if name == "LR" and on_card:
            assert flat_l == {"sgd_batch_terms": 8 * rounds,
                              "reduce_partials": rounds}, flat_l
            assert two_l == {"sgd_batch_terms": 8 * rounds,
                             "reduce_partials": 2 * rounds}, two_l
        models[name] = flat
        hyb[name] = {"p8_ms": one_d_ms, "flat_ms": flat_ms,
                     "hier_ms": min(two_ms, two_best),
                     "flat_launches": flat_l, "hier_launches": two_l,
                     "per_shard_inter_bytes_flat": per_flat,
                     "per_shard_inter_bytes_hier": per_two,
                     "per_shard_inter_ratio": per_two / per_flat,
                     "hier_max_diff": h_diff}
        log(f"  (b) {name} on (dcn 2, data 4): flat {flat_ms:.3f} ms, "
            f"bit-identical to 8 shards ({one_d_ms:.3f} ms); two-level "
            f"{hyb[name]['hier_ms']:.3f} ms, max|diff| {h_diff:.3g}; "
            f"per-shard accounting of the inter level (not measured "
            f"traffic): {per_flat:g} B a sum flat, {per_two:g} B two-level "
            f"({per_two / per_flat:.4f}); launches flat {flat_l}, "
            f"two-level {two_l}")
    # the hybrid KMeans model's transform: one assignment
    before = K.launch_counts["assign_nearest"]
    labels = models["KMeans"].transform(km_table)[0]["prediction"]
    assert K.launch_counts["assign_nearest"] == before + on_card
    assert tuple(labels.shape) == (km_table.num_rows,)
    summary["b"] = hyb

    # (c) sequence parallelism on SEQ_SHARDS seq shards of the card
    del lr_table, km_table, labels, models
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn((SEQ_LEN, SEQ_HEADS, SEQ_DIM), generator=gen,
                           device=dev) for _ in range(3))
    seq = create_mesh((SEQ_SHARDS,), ("seq",), devices=[dev] * SEQ_SHARDS)
    att = {}
    for causal in (False, True):
        want, full_ms, full_mem = _attention_run(
            lambda: full_attention(q, k, v, causal=causal))
        row = {"full_ms": full_ms, "full_peak_bytes": full_mem}
        for kind in ("ring", "ulysses"):
            got, ms, mem = _attention_run(lambda: sharded_attention(
                seq, q, k, v, kind=kind, causal=causal))
            excess, worst = _within(got, want, SEQ_RTOL, SEQ_ATOL)
            assert excess <= 0.0, (kind, causal, excess, worst)
            row.update({f"{kind}_ms": ms, f"{kind}_peak_bytes": mem,
                        f"{kind}_max_abs_err": worst})
            del got
        del want
        torch.cuda.empty_cache()
        att["causal" if causal else "full"] = row
        log(f"  (c) attention L={SEQ_LEN} H={SEQ_HEADS} Dh={SEQ_DIM} "
            f"causal={causal} on {SEQ_SHARDS} seq shards: full "
            f"{full_ms:.2f} ms, peak {full_mem / 2**30:.2f} GiB; ring "
            f"{row['ring_ms']:.2f} ms, peak "
            f"{row['ring_peak_bytes'] / 2**30:.2f} GiB, max|err| "
            f"{row['ring_max_abs_err']:.3g}; ulysses {row['ulysses_ms']:.2f}"
            f" ms, peak {row['ulysses_peak_bytes'] / 2**30:.2f} GiB, max|err|"
            f" {row['ulysses_max_abs_err']:.3g}")
    assert all(r["ring_peak_bytes"] < r["full_peak_bytes"] / 4
               for r in att.values()) or not on_card, att
    summary["c"] = att
    del q, k, v
    torch.cuda.empty_cache()

    # (d) ranks that share the card: the launcher picks gloo; which gloo
    # collectives take CUDA tensors; then the elastic fit
    child_env = {"PYTHONPATH": os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    probe = distributed.launch(
        [sys.executable, str(REPO / "scripts" / "port_gloo_cuda_probe.py"),
         "--ops", ",".join(sorted(C.GLOO_CUDA_OPS))],
        2, env=child_env, timeout=180.0, device=device)
    assert [r["returncode"] for r in probe] == [0, 0], probe[0]["stderr"]
    table = json.loads(probe[0]["stdout"].strip().splitlines()[-1])
    assert table["backend"] == "gloo", table
    took = {op for op, res in table["ops"].items() if res == "ok"}
    assert took == C.GLOO_CUDA_OPS, (C.GLOO_CUDA_OPS, table)
    log("  (d) gloo on CUDA tensors: " + json.dumps(table["ops"]))
    summary["gloo_cuda"] = table

    workdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    # sequence attention over two gloo ranks that share the card: ring's
    # send/recv staged through pinned host buffers (gloo aborts on CUDA
    # send/recv), Ulysses' all-to-all direct
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v = (torch.randn((SEQ_RANK_LEN, SEQ_HEADS, SEQ_DIM), generator=gen,
                           device=dev) for _ in range(3))
    np.savez(f"{workdir}/qkv.npz", q=q.cpu().numpy(), k=k.cpu().numpy(),
             v=v.cpu().numpy())
    ranks = distributed.launch(
        [sys.executable, "-c", _SEQ_RANK_PROGRAM, f"{workdir}/qkv.npz",
         f"{workdir}/seq"], 2, env=child_env, timeout=180.0, device=device)
    assert [r["returncode"] for r in ranks] == [0, 0], ranks[0]["stderr"]
    seq_ranks = {}
    for causal in (False, True):
        want = full_attention(q, k, v, causal=causal)
        for rank in range(2):
            with np.load(f"{workdir}/seq-{rank}.npz") as got:
                for kind in ("ring", "ulysses"):
                    excess, worst = _within(torch.as_tensor(
                        got[f"{kind}-{int(causal)}"], device=dev), want,
                        SEQ_RTOL, SEQ_ATOL)
                    assert excess <= 0.0, (kind, causal, rank, worst)
                    seq_ranks[f"{kind}-{int(causal)}-err"] = max(
                        worst, seq_ranks.get(f"{kind}-{int(causal)}-err", 0))
    staged = json.loads(ranks[0]["stdout"].strip().splitlines()[-1])
    # one staged send/recv a ring hop on the card: (P - 1) hops a call,
    # two calls (masked and not); CPU tensors are never staged
    assert staged == {"send_recv": 2 * on_card}, staged
    seq_ranks["staged"] = staged
    summary["seq_ranks"] = seq_ranks
    log(f"  (d) attention L={SEQ_RANK_LEN} over two gloo ranks on the card: "
        f"ring and Ulysses within tolerance on both ranks "
        f"({json.dumps(seq_ranks)})")
    del q, k, v, want
    trace = f"{workdir}/trace"
    elastic.reset_stats()
    tracing.tracer.configure(trace)
    try:
        t0 = time.time()
        records = elastic.run_elastic(
            [sys.executable, str(REPO / "scripts" / "port_elastic_worker.py"),
             "--config", str(LINEAR_CONFIGS["logisticregression"]),
             "--interval", str(ELASTIC_INTERVAL), "--ckpt", f"{workdir}/ck",
             "--out", f"{workdir}/out"],
            num_processes=2, min_processes=1,
            env=dict(child_env, FLINK_ML_TPU_CHAOS="1",
                     FLINK_ML_TPU_CHAOS_AT=f"worker-loss:{ELASTIC_KILL_AT}"),
            policy=RetryPolicy(max_restarts=2, backoff_s=0.05),
            timeout=300.0, child_grace_s=10.0, device=device,
            heartbeat_dir=f"{workdir}/hb")
        wall_s = time.time() - t0
        beacon = fleet.write_beacon(f"{workdir}/fleet", role="driver")
    finally:
        tracing.tracer.configure(None)
    assert len(records) == 1 and records[0]["returncode"] == 0, records
    prov = elastic.provenance()
    assert prov["elasticEvents"] == 2, prov
    load = json.loads(open(beacon).read())["load"]
    assert load["elasticEvents"] == prov["elasticEvents"] and \
        load["participation"] == prov["participationMin"], load
    events = {}
    for sp in exporters.read_spans(trace):
        for ev in sp.get("events", []):
            events.setdefault(ev["name"], []).append(ev)
    assert "elastic.worker-lost" in events and "elastic.relaunch" in events
    lost = events["elastic.worker-lost"][0]
    assert lost["attrs"]["process"] == 1, lost
    relaunch = events["elastic.relaunch"][0]
    out = Path(workdir) / "out"
    result = json.loads((out / "result-attempt-1.json").read_text())
    assert result["processes"] == 1 and result["path"] == (
        "cuda" if on_card else "torch") + "-sgd-segments", result
    hb = sorted(Path(workdir, "hb", "attempt-0").glob("fleet-p1-*.json"))
    victim = json.loads(hb[0].read_text())
    assert victim["epoch"] == ELASTIC_INTERVAL * ELASTIC_KILL_AT, victim
    # each rank's launches as far as it wrote them (at each save and after
    # its fit): all three ranks launched the batch-terms kernel
    counts = dict(K.launch_counts)
    rank_launches = {}
    for path in sorted(out.glob("launches-attempt-*.json")):
        got = json.loads(path.read_text())
        rank_launches[path.stem] = got
        assert got.get("sgd_batch_terms", 0) >= on_card, (path.name, got)
        for kern, c in got.items():
            counts[kern] += c
    assert len(rank_launches) == 3, rank_launches
    # a one-rank fit in this process resumed from the snapshot the
    # relaunched rank resumed from: the same bits
    saved = dict(K.launch_counts)
    resumed = Path(workdir) / "resume"
    shutil.copytree(out / "frozen-attempt-1", resumed)
    mgr = elastic.ElasticCheckpointManager(str(resumed))
    est = runner.build_stage(lr_spec, mesh=create_mesh((1,), devices=[dev]))
    est.set_iteration_config(IterationConfig(
        checkpoint_interval=ELASTIC_INTERVAL, checkpoint_manager=mgr))
    ref = est.fit(runner.build_generator(lr_spec).get_data())
    K.launch_counts.update(saved)
    got = np.asarray(result["coef_bits"], np.int32).view(np.float32)
    assert np.array_equal(got, np.asarray(ref.coefficients, np.float32)), \
        "the resumed rank differs from a one-rank resume of its snapshot"
    assert not mgr.list_checkpoints()
    detect_ms = lost["ts_us"] / 1e3 - victim["time"] * 1e3
    relaunch_ms = result["started"] * 1e3 - relaunch["ts_us"] / 1e3
    summary["d"] = {
        "wall_s": wall_s, "detection_ms": detect_ms,
        "relaunch_to_start_ms": relaunch_ms,
        "lost_to_relaunch_ms": (relaunch["ts_us"] - lost["ts_us"]) / 1e3,
        "resume_fit_ms": result["fit_ms"], "rank_launches": rank_launches,
        "provenance": prov, "beacon_load": {
            k: load[k] for k in ("participation", "elasticEvents")}}
    log(f"  (d) run_elastic, 2 gloo ranks on one card, LR config: rank 1 "
        f"killed at epoch {victim['epoch']}, named; relaunched as 1 rank, "
        f"resumed bit-identical to a one-rank resume of its snapshot; "
        f"detection {detect_ms:.1f} ms, lost→relaunch "
        f"{summary['d']['lost_to_relaunch_ms']:.1f} ms, relaunch→start "
        f"{relaunch_ms:.1f} ms, resumed fit {result['fit_ms']:.1f} ms, "
        f"wall {wall_s:.1f} s; rank launches {rank_launches}")
    shutil.rmtree(workdir, ignore_errors=True)
    if on_card:
        for kern in PATH_KERNELS["parallel_layer"]:
            assert counts[kern] >= 1, (kern, counts)
    summary["launches"] = {k: v for k, v in counts.items() if v}
    summary["seconds"] = time.perf_counter() - started
    log("  parallel layer:", json.dumps(summary, sort_keys=True,
                                        default=str))
    return counts


def _lint_json(lint_cli, argv):
    """One in-process run of the port's linter CLI: (exit code, its JSON
    report)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lint_cli.main([*argv, "--format", "json"])
    return rc, json.loads(out.getvalue())


def phase_static_checks(card_line, keep):
    """Phase 20: the port's own static checks and the results chart, on
    the card's host. Launches no kernel."""
    log("phase 20: static checks on the card's host")
    started = time.perf_counter()
    from flink_ml_tpu_torch.analysis import cli as lint_cli
    from flink_ml_tpu_torch.benchmark import visualize

    targets = [str(REPO / "flink_ml_tpu_torch"), str(REPO / "chip_smoke.py"),
               *sorted(str(p) for p in (REPO / "scripts").glob("port_*.py"))]
    t0 = time.perf_counter()
    rc, report = _lint_json(lint_cli, targets)
    lint_ms = (time.perf_counter() - t0) * 1e3
    _, audit = _lint_json(lint_cli, ["--suppressions", *targets])
    unsuppressed = [f for f in report["findings"] if not f["suppressed"]]
    assert rc == 0 and report["counts"]["unsuppressed"] == 0, (
        "torchlint findings on the port: " + "; ".join(
            f"{f['path']}:{f['line']}: {f['rule']}" for f in unsuppressed))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flink_ml_tpu"))
    assert not leaked, f"the linter loaded {leaked}"
    by_rule = {}
    for f in report["findings"]:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    log(f"  (1) torchlint over {len(targets)} targets: exit {rc}, "
        f"counts {json.dumps(report['counts'], sort_keys=True)}, "
        f"suppressed by rule {json.dumps(by_rule, sort_keys=True)}, "
        f"{lint_ms:.1f} ms; no jax or flink_ml_tpu module loaded")
    stale = [s for s in audit["suppressions"] if not s["used"]]
    assert not stale and all(s["justification"]
                             for s in audit["suppressions"]), stale
    host_sync = {}
    for s in audit["suppressions"]:
        if "host-sync" in s["rules"]:
            rel = os.path.relpath(s["path"], REPO)
            host_sync[rel] = host_sync.get(rel, 0) + 1
    log("  (2) justified host-sync suppressions by module: "
        + json.dumps(host_sync, sort_keys=True))

    rows = keep["runner_results"]
    want = json.loads(json.dumps(
        {name: e["results"] for name, e in rows.items() if "results" in e}))
    broken = sorted(name for name, e in rows.items() if "exception" in e)
    assert want and broken, (sorted(want), broken)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "results.json")
        with open(path, "w") as f:
            json.dump(rows, f)
        loaded = visualize.load_results(path)
        assert loaded == want, sorted(loaded)
        log(f"  (3) visualize.load_results: {len(loaded)} rows of "
            f"{len(rows)} ({', '.join(sorted(loaded))}), the broken "
            f"{broken} skipped, each equal to its runner row")
        chart = os.path.join(tmp, "chart.png")
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            try:
                visualize.main([path, "--output-file", chart])
            except ImportError as e:
                assert "matplotlib" in str(e) and "viz" in str(e), e
                assert not os.path.exists(chart)
                drawn = f"no matplotlib here: the named ImportError ({e})"
            else:
                raise AssertionError("visualize drew without matplotlib")
        else:
            assert visualize.main([path, "--output-file", chart]) == 0
            assert os.path.getsize(chart) > 0
            drawn = f"a {os.path.getsize(chart)}-byte PNG"
    log(f"  (4) the chart: {drawn}")
    summary = {"lint_ms": lint_ms, "counts": report["counts"],
               "host_sync": host_sync,
               "seconds": time.perf_counter() - started}
    log("  static checks:", json.dumps(summary, sort_keys=True),
        f"on the host of {card_line}")


def _rank_results(out, n):
    return [json.loads((Path(out) / f"result-p{r}.json").read_text())
            for r in range(n)]


def _launch_mesh_worker(distributed, jobs, n, local, workdir, tag, env,
                        device):
    """``scripts/port_mesh_worker.py`` on ``n`` ranks of ``local``
    positions each → every rank's result, after every rank exited 0."""
    path = Path(workdir) / f"{tag}.json"
    path.write_text(json.dumps(jobs))
    records = distributed.launch(
        [sys.executable, str(REPO / "scripts" / "port_mesh_worker.py"),
         "--jobs", str(path), "--out", f"{workdir}/{tag}"], n,
        local_devices=local, env=env, timeout=300.0, device=device)
    assert [r["returncode"] for r in records] == [0] * n, (
        tag, [r["stderr"][-2000:] for r in records])
    return _rank_results(f"{workdir}/{tag}", n)


def phase_meshes_over_processes(K, runner, card_line, device="cuda"):
    """Phase 21: meshes over processes, with the counts at 0: (a) the LR
    config on four gloo ranks of a (data 2, model 2) mesh, one position a
    rank; (b) on two ranks of two positions on (data 2, model 2) and of
    one on (data 1, model 2); (c) ring and Ulysses attention on (seq 4)
    over the same two ranks. Each against the same mesh shape in this
    process. Returns the ranks' launches."""
    from flink_ml_tpu_torch.parallel import create_mesh, distributed
    from flink_ml_tpu_torch.parallel.sequence import (full_attention,
                                                      sharded_attention)

    log("phase 21: meshes over processes: tensor-parallel fits and "
        "sequence attention over gloo ranks that share the card")
    started = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    K.reset_launch_counts()
    summary = {"card": card_line}
    config = str(LINEAR_CONFIGS["logisticregression"])
    lr_spec = runner.load_config(config)["logisticregression"]
    rounds = lr_spec["stage"]["paramMap"]["maxIter"]
    shapes = {"a": (2, 2), "b_data2": (2, 2), "b_data1": (1, 2)}

    # the in-process fits on the same mesh shapes, the references; their
    # launches are not the path's
    saved = dict(K.launch_counts)
    table = runner.build_generator(lr_spec, dev).get_data()
    n, d = table.num_rows, table.vectors("features").shape[1]
    refs = {}
    for shape in set(shapes.values()):
        mesh = create_mesh(shape, ("data", "model"),
                           devices=[dev] * math.prod(shape))
        model, ms, _ = _fit_ms(runner.build_stage(lr_spec, dev, mesh), table)
        refs[shape] = (np.asarray(model.coefficients, np.float32), ms)
    del table, model
    torch.cuda.empty_cache()
    K.launch_counts.update(saved)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_meshes_")
    env = {"PYTHONPATH": os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    fit = dict(kind="fit", config=config, reps=2)
    four = _launch_mesh_worker(
        distributed, [dict(fit, name="a", shape=[2, 2], local=1)], 4, 1,
        workdir, "four", env, device)
    two = _launch_mesh_worker(
        distributed,
        [dict(fit, name="b_data2", shape=[2, 2], local=2),
         dict(fit, name="b_data1", shape=[1, 2], local=1),
         dict(kind="attention", name="c", shape=[SEQ_SHARDS_PROC], local=2,
              L=SEQ_LEN, H=SEQ_HEADS, D=SEQ_DIM, seed=21, reps=2)],
        2, 2, workdir, "two", env, device)
    counts = dict(K.launch_counts)
    fits = {}
    for name, ranks in (("a", four), ("b_data2", two), ("b_data1", two)):
        shape = shapes[name]
        want, ref_ms = refs[shape]
        rows = {"mesh": {"data": shape[0], "model": shape[1]},
                "ranks": len(ranks), "in_process_ms": ref_ms, "rank_ms": [],
                "rank_peak_bytes": [], "launches": {}}
        for res in ranks:
            rec = res["jobs"][name]
            assert rec["path"] == ("cuda-tp" if on_card else "torch-tp"), rec
            got = np.asarray(rec["coef_bits"], np.int32).view(np.float32)
            diff = np.abs(got - want)
            assert np.all(diff <= MESH_PROC_RTOL * np.abs(want) + 1e-9), (
                name, res["process"], float(diff.max()))
            rows.setdefault("bit_equal", True)
            rows["bit_equal"] &= bool(np.array_equal(got, want))
            rows["max_abs_diff"] = max(rows.get("max_abs_diff", 0.0),
                                       float(diff.max()))
            rows["rank_ms"].append(rec["runs_ms"])
            rows["rank_peak_bytes"].append(rec["peak_bytes"])
            for kern, c in rec["launches"].items():
                rows["launches"][kern] = rows["launches"].get(kern, 0) + c
                counts[kern] += c
        # the column blocks a rank placed: its data shards' rows times its
        # model shards' columns (d = 100 splits evenly over 2)
        rec = ranks[0]["jobs"][name]
        rows["placed_bytes_a_rank"] = (
            len(rec["local_shards"]) * math.ceil(n / shape[0])
            * len(rec["local_models"]) * (d // shape[1]) * 4)
        rows["groups"] = rec["groups"]
        fits[name] = rows
        log(f"  ({name}) LR {n} x {d}, {rounds} rounds on (data "
            f"{shape[0]}, model {shape[1]}) over {len(ranks)} gloo ranks: "
            f"fit ms a rank, two runs each {rows['rank_ms']} "
            f"(in-process {ref_ms:.3f}); bit-equal to the in-process fit: "
            f"{rows['bit_equal']} (max|diff| {rows['max_abs_diff']:.3g}); "
            f"placed {rows['placed_bytes_a_rank'] / 1e9:.3f} GB a rank, peak "
            f"{[round(b / 2**30, 3) for b in rows['rank_peak_bytes']]} GiB; "
            f"launches {rows['launches']}; groups {rows['groups']}")
    assert fits["b_data2"]["launches"].get("reduce_partials", 0) >= (
        2 * rounds if on_card else 0), fits["b_data2"]["launches"]
    four_groups = fits["a"]["groups"]
    assert four_groups["data"]["group"] and four_groups["model"]["group"], \
        four_groups
    summary["fits"] = fits

    # (c) attention: the ranks' gathered output against full attention and
    # the in-process (seq 4) result on the same inputs
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn((SEQ_LEN, SEQ_HEADS, SEQ_DIM), generator=gen,
                           device=dev) for _ in range(3))
    seq = create_mesh((SEQ_SHARDS_PROC,), ("seq",),
                      devices=[dev] * SEQ_SHARDS_PROC)
    att = {}
    with np.load(f"{workdir}/two/c.npz") as saved_out:
        got_all = {key: saved_out[key] for key in saved_out.files}
    for causal in (False, True):
        want = full_attention(q, k, v, causal=causal)
        for kind in ("ring", "ulysses"):
            key = f"{kind}-{int(causal)}"
            got = torch.as_tensor(got_all[key], device=dev)
            worst = float((got - want).abs().max())
            assert worst <= MESH_PROC_ATT_ATOL, (key, worst)
            local = sharded_attention(seq, q, k, v, kind=kind, causal=causal)
            recs = [res["jobs"]["c"][key] for res in two]
            assert len({r["sha256"] for r in recs}) == 1, key
            att[key] = {"max_abs_err": worst,
                        "bit_equal_in_process": bool(torch.equal(got, local)),
                        "rank_ms": [r["ms"] for r in recs],
                        "rank_peak_bytes": [r["peak_bytes"] for r in recs],
                        "staged_send_recv": [r["staged_send_recv"]
                                             for r in recs]}
            del got, local
        del want
        torch.cuda.empty_cache()
    # one staged hop a ring step across ranks, (P - 1) steps a call, each
    # variant run twice; the all-to-all takes CUDA tensors as they are;
    # CPU tensors never stage
    for key, row in att.items():
        hops = (2 * (SEQ_SHARDS_PROC - 1) * on_card if key.startswith("ring")
                else 0)
        assert row["staged_send_recv"] == [hops, hops], (key, row)
        log(f"  (c) {key} attention L={SEQ_LEN} H={SEQ_HEADS} Dh={SEQ_DIM} "
            f"on (seq {SEQ_SHARDS_PROC}) over 2 gloo ranks, 2 shards a rank: "
            f"ms a rank {[round(x, 2) for x in row['rank_ms']]}, peak "
            f"{[round(b / 2**30, 3) for b in row['rank_peak_bytes']]} GiB, "
            f"max|err| {row['max_abs_err']:.3g} against full attention, "
            f"bit-equal to in-process: {row['bit_equal_in_process']}, "
            f"staged send/recv {row['staged_send_recv']}")
    summary["attention"] = att
    del q, k, v
    torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    if on_card:
        for kern in PATH_KERNELS["meshes_processes"]:
            assert counts[kern] >= 1, (kern, counts)
    summary["launches"] = {k: v for k, v in counts.items() if v}
    summary["seconds"] = time.perf_counter() - started
    log("  meshes over processes:", json.dumps(summary, sort_keys=True,
                                               default=str))
    return counts


def _serving_group():
    from flink_ml_tpu_torch.common.metrics import metrics

    return metrics.group("ml", "serving")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.models.clustering import kmeans as kmeans_mod
    from flink_ml_tpu_torch.ops import kernels as K
    from flink_ml_tpu_torch.observability import compilestats
    from flink_ml_tpu_torch.ops import optimizer

    # build accounting (ml.compile) sees phase 1's builds; it records
    # builds only, so the unarmed phases 4-11 record nothing
    compilestats.install()
    phase_build(K)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("card:", card)
    measured = phase_kernels(K)
    measured.update(phase_sgd_kernels(K))
    # each path is driven with the counts at 0 and read just after; a
    # path's count of another path's kernels is 0
    keep = {}
    counts = {"kmeans": phase_main_path(K, runner, kmeans_mod),
              "linear": phase_linear_main_path(K, runner, optimizer, Table,
                                               keep=keep)}
    measured.update(phase_knn_kernel(K))
    measured.update(phase_segment_kernel(K))
    counts["knn"] = phase_knn_main_path(K, runner, Table)
    counts["ftrl"] = phase_ftrl_main_path(K, runner, Table)
    counts["iteration"] = phase_iteration_modes(K, runner, Table)
    counts["parallel"] = phase_parallel(K, runner, optimizer, Table)
    counts["observability"] = phase_observability(K, runner)
    counts["serving"] = phase_serving(K, runner, card)
    counts["ops"] = phase_ops_loop(K, runner, card)
    counts["pipeline"] = phase_pipelines(K, runner, Table)
    counts["text"] = phase_text(K, runner, Table, keep=keep)
    counts["online"] = phase_online(K, runner, Table)
    counts["sparse_linear"] = phase_sparse_linear(K, runner, Table, keep=keep)
    phase_host_algorithms(K, runner, Table)
    counts["mesh_observability"] = phase_mesh_observability(K, runner, card)
    counts["parallel_layer"] = phase_parallel_layer(K, runner, Table, card)
    phase_static_checks(card, keep)
    counts["meshes_processes"] = phase_meshes_over_processes(K, runner,
                                                             card)

    # step 22: the kernels line
    line = {"kernels": [
        {"name": name, **{key: K.KERNELS[name][key]
                          for key in ("route", "source", "replaces")},
         "launches": sum(c[name] for c in counts.values()),
         "launches_by_path": {path: c[name] for path, c in counts.items()
                              if c[name]},
         **measured[name]}
        for name in K.KERNELS]}
    missing = [r["name"] for r in line["kernels"] if r["launches"] < 1]
    assert not missing, f"kernels the main paths never launched: {missing}"
    for path, path_counts in counts.items():
        others = {k for p, ks in PATH_KERNELS.items() if p != path
                  for k in ks} - set(PATH_KERNELS[path])
        assert not any(path_counts[k] for k in others), (path, path_counts)
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
