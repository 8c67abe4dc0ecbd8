#!/usr/bin/env python3
"""Drive the PyTorch port (sagemaker_xgboost_container_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. build the CUDA kernels from csrc/ with nvcc (into build/torch_kernels/,
   or under GRAFT_COMPILE_CACHE_DIR),
   printing the build time, the -Xptxas -v report of the hist_* and totals_*
   kernels and the atomic instructions they compiled to (the totals_*
   kernels must have none);
2. hist_kernel (the hist_* kernels behind level_histogram) against its plain
   PyTorch version: timed at 1M x 28 uint16 bins, B=257, with nodes drawn
   from [-1, W) at W=1 and W=64, with level 7's left children (half the
   rows at -1, W=64) and with a lossguide split step's child (W=1, 1/64 of
   the rows in the node; CUDA events around the wrapper, torch.profiler's
   device time, the plain version, torch.bincount over the keys, the bound);
   untimed with every row in one node, half the nodes
   empty, no row active, fewer rows than hist_kernel CTAs, W=130, n=0, an
   unaligned n and uint8 bins with B=256; then the class axis (C classes'
   [C, n] gradients sharing the bins, one launch): timed at CoverType's
   shape, 581,012 x 54 uint16 bins, B=257, C=7, nodes drawn from [-1, 64)
   per class (CUDA events around the wrapper, torch.profiler's device time,
   the plain version, torch.bincount over the folded keys, the bound counting
   the bins once); untimed at C=2 with one class without an active row,
   C=7 with W=1, fewer entries than CTAs and uint8 bins with B=256; then
   tree_method=exact's width: the main path's rows rounded to multiples of
   2^-9 and binned at every distinct value (B printed: 3,906), timed
   at W=64 with level 7's left children; untimed at B=8,193 (one feature a
   CTA) and B=20,001 (bins tiled, two CTAs a feature), 1M x 28;
3. totals_kernel (totals_partial and totals_reduce behind node_totals)
   against its plain version, and two calls against each other bitwise:
   timed at n=1M, W=256 with nodes drawn from [-1, W) (CUDA events around
   the wrapper, and the kernels' device time from torch.profiler over a
   second run of the timed loop); untimed at W=1, W=4096, with every row in
   one node, no row active, n=100 and n=0; then the class axis, bitwise
   equal on a second call too: timed at C=7, W=256, n=581,012; untimed at
   C=2 with one class without an active row, C=7 with W=1 and fewer
   entries than CTAs;
4. the slice: train 5 rounds of binary:logistic, max_depth=8, max_bin=256 on
   1M x 28 synthetic rows with 100k validation rows, checking the launch
   counts and a falling validation logloss; save the model, load it back and
   predict 10k rows on the GPU against the CPU predict of the same model;
5. a small training run on the GPU against the same run on the CPU;
6. where a round's time goes: the main path again for 9 rounds, rounds 2-5
   timed on the host clock and rounds 6-9 under torch.profiler (device
   activity), giving device time per kernel, the histogram's (every hist_*
   kernel) and the totals' (every totals_* kernel) per round and the
   device's busy share;
7. the serve entry point: train 100 rounds of the main path's parameters on
   200k x 28 rows (best_iteration 79), save it as xgboost JSON and as
   UBJSON, start `serving_entrypoint(port=0, block=False)` and check over
   HTTP /ping, /execution-parameters, 10k rows as csv, libsvm and
   recordio-protobuf against every accept (within 1e-5 of the CPU predict
   of rounds 0-79), selectable inference, the UBJSON model and the
   204/415/406/400 answers; then p50/p95/p99 latency and requests/s of
   1-row and 100-row csv requests from 16 client threads and of 10k-row
   requests one after another, the clients in a child process (and the
   1-row load again from threads of the server's own process, which share
   its interpreter lock), each beside the in-process predict time,
   the device predict's H2D/traversal/D2H split (CUDA events), the
   batcher's counts, the host/device predict counts and the host
   predicts' traversal route (every one native), and the 100-row
   load once more under torch.profiler for the device's busy share and
   kernel launches per device predict; then SIGTERM with a request in
   flight, which must still be answered before the listener closes. Last,
   the csv decode and the host predict path timed in two child processes
   at once, one with OMP_NUM_THREADS=1 and one without. The serve path
   launches neither kernel; its launch counts are printed;
8. the train entry point: a SageMaker tree in a tempdir (hyperparameters
   with all-string values: the main path's parameters, eta 0.2, 30 rounds,
   eval_metric logloss,auc, early stopping after 10 rounds on
   validation:auc; csv train and validation channels of 200,000 and
   50,000 x 28 rows of the same formula, seed 5, 2 % missing values as
   empty fields; a checkpoint LocalPath), pointed at by the SM_* env.
   `python -m sagemaker_xgboost_container_tpu_torch.training.entry` runs
   in a child process: exit 0, `xgboost-model` written, one HPO-regex line
   per round for validation-logloss and validation-auc, logloss falling
   over the first 5 rounds, checkpoints present. Then
   `training.algorithm_train.sagemaker_train` runs the same job in this
   process: 8 hist_kernel and 1 totals_kernel launches a round, the wall
   time split into channel read, binning and upload, rounds and model
   save, and the model against the child's. Then a spot interruption
   (its two children run one after the other, beside the first child):
   SIGTERM to a child with save_model_on_termination after round 5 leaves
   an intermediate model and checkpoints, and a rerun on the same
   checkpoint dir resumes from the last checkpoint, keeps its trees
   unchanged and ends with the uninterrupted run's rounds. Two GPU runs
   of one job are different models of the same quality (the histograms'
   f32 atomics add in a varying order, and near-tie splits go either
   way), so the runs are held to ENTRY_METRIC_TOL on every last-round
   metric and ENTRY_DP_TOL on the mean probability difference, and the
   trees that agree are counted. Last, the trained model behind
   `serving_entrypoint`: 10k validation rows as csv within 1e-5 of the
   CPU predict;
9. multiclass at full width: BASELINE.md config #3, CoverType-shaped
   multi:softmax (581,012 x 54 rows of bench.py's BENCH_TASK=multiclass
   formula, seed 0, 7 classes; 58,101 validation rows, seed 1; max_depth 8,
   max_bin 256, eta 0.3, 10 rounds, eval_metric mlogloss,merror): 8
   hist_kernel and 1 totals_kernel launches a round (one launch a level for
   all 7 classes), validation mlogloss falling every round, rounds/s on the
   host clock over rounds 1-4 and, over rounds 5-8 under torch.profiler,
   device ms a round, the histogram's and the totals' share and the
   device's busy share; the model saved, loaded and predicting 10k
   validation rows on the GPU against the CPU (margins within 1e-5, the
   same classes) and served once through `serving_entrypoint` (1,000 csv
   rows). Then every objective beyond the main path trains 3 rounds on
   20,000 x 9 rows on the GPU and on the CPU (the ranking ones with queries
   of 100 rows; lossguide with binary:logistic and multi:softprob at 31
   leaves): the last-round training metric within SWEEP_METRIC_TOL, and the
   identical trees counted;
10. ranking and lossguide at full width. 10a: BASELINE.md config #4 shaped
   like MSLR-WEB30K, rank:ndcg (2,000 training and 500 validation queries,
   lognormal query sizes with a mean of 120 cut at 1,250, 136 features,
   bench.py's BENCH_TASK=ranking relevance; max_depth 8, max_bin 256, eta
   0.1, 10 rounds, eval_metric ndcg@10,map@10): 8 hist_kernel and 1
   totals_kernel launches a round, validation ndcg@10 rising, rounds/s on
   the host clock over rounds 1-4 and device ms a round over rounds 5-8
   (torch.profiler), the gradient pass alone (CUDA events and device time,
   its share of a round), GPU against CPU gradients on 200 queries (within
   1e-5 of the largest |g| and |h|), the saved model predicting 10k
   validation rows on the GPU against the CPU; then `sagemaker_train` with
   rank:pairwise over libsvm channels with qid: tokens, one metric line a
   round, every libsvm file parsed by the native tokenizer. 10b: bench.py's
   BENCH_TASK=lossguide on the main path's rows
   (binary:logistic, max_leaves 255, max_depth 0, eta 0.2, 5 rounds): one
   hist_kernel launch for the root and one a split step (255 a tree), no
   totals_kernel launch, validation logloss falling every round, rounds/s
   over rounds 1-2 and device ms and torch launches a round over rounds
   3-4; the model saved, loaded and predicting 10k rows on the GPU against
   the CPU, and served once through `serving_entrypoint`;
11. sampling, bagging and cross-validation. First both kernels at the
   fold axis of fold-parallel CV against their plain versions and timed:
   u16 [250,000, 28], B=257, C=5 folds, W=16 for hist and W=32 for totals,
   each fold's held-out fifth at g=h=0. 11a: AWS's customer-churn example
   (`binary:logistic`, max_depth 5, eta 0.2, gamma 4, min_child_weight 6,
   subsample 0.8, max_bin 256) on the main path's rows for 10 rounds, and
   three variants adding colsample_bytree, colsample_bylevel or
   colsample_bynode 0.8: 5 hist_kernel and 1 totals_kernel launches a
   round, rounds/s over rounds 2-6 on the host clock and launches, device
   ms and busy share over rounds 7-9 (torch.profiler), the mask draw's
   device time, each round's kept share within 4 binomial sigma of 0.8, and
   validation logloss falling every round; then the four on 20,000 x 9
   rows on the GPU and on the CPU with the GPU's draws replayed (phase 9's
   rule for the last-round metric; predict within 1e-5). 11b: xgboost's
   random-forest recipe (num_parallel_tree 100, subsample 0.8,
   colsample_bynode 0.8, eta 1, max_depth 5, one round) on the main path's
   rows beside a single tree: wall s, 5 hist_kernel and 1 totals_kernel
   launches a tree, torch launches and device ms (torch.profiler), the
   validation logloss of each; the forest saved, predicting within 1e-5 of
   the CPU and served once. 11c: k-fold CV through the train entry point
   on phase 8's csv channels (depth 5, 20 rounds): `_kfold=5,
   _num_cv_round=2, eval_metric=logloss,auc` in this process, on the
   fold-parallel path (all 10 fold runs on the class axis: 5 hist_kernel
   and 1 totals_kernel launches a round), 10 models, predictions.csv of
   250,000 rows and three CV metric lines; then `eval_metric=accuracy,f1,
   auc`, `_num_cv_round=1` in a child process (the feval takes the
   sequential path: a line a round a fold with validation-accuracy and
   validation-f1); the two runs' CV means of auc within 1e-2;
12. the multi-model endpoint and the serving planes. Three server child
   processes on the card (`python -m ...serving.server` with
   SAGEMAKER_MULTI_MODEL=true): the endpoint (SAGEMAKER_MAX_MODELS=3,
   SM_SERVING_METRICS=true) loads the models of phases 4, 11b, 9 and 10a
   (the CoverType one with a manifest from `write_manifest`), the fourth
   load evicting the forest (404, GET /models lists three); each resident
   model answers 1, 100 and 1,000 csv and libsvm rows within 1e-5 of the
   CPU predict; a model file with one byte flipped after its manifest
   answers POST /models 500 and counts model_verify_fail_total{stage=
   "digest"} once; p50 / p99 of 1-row and 100-row closed-loop loads (16
   client threads in a child process, over the 3 models) with the device's
   busy share (nvidia-smi utilization.gpu); DELETE retires the model's
   batcher series from /metrics; SIGTERM exits 0. The second child
   (SM_PREDICT_STUCK_S=1, a 4 s `batcher.dispatch` wedge): /ping and
   invokes 503 + Retry-After while stuck, 200 again after; then SIGTERM
   with 8 requests in flight (a 3 s `predict.dispatch` stall each): all 8
   answered 200, new ones 503 + Retry-After, exit 0. The third
   (SM_REQUEST_DEADLINE_S=0.5): a decode past it answers 503 +
   Retry-After and counts serving_deadline_exceeded_total{stage="decode"};
   a request wedged in its decode past SM_DRAIN_TIMEOUT_S=2 makes SIGTERM
   exit 83. Last, in this process, each model's device memory while
   resident in a ModelManager, and 20 load/unload cycles of the forest
   after which torch.cuda.memory_allocated() and threading.active_count()
   are what they were before the first;
13. the other boosters. 13a: dart on the main path's rows (rate_drop 0.1,
   one_drop, skip_drop 0, uniform sampling, normalize_type tree, 10
   rounds): 8 hist_kernel and 1 totals_kernel launches a round, validation
   logloss of round 10 below round 1's, rounds/s over rounds 2-6 on the host
   clock and launches, device ms and busy share over rounds 7-9
   (torch.profiler); the saved model predicting 10k rows on the GPU within
   1e-5 of the CPU; then normalize_type=forest and sample_type=weighted, 3
   rounds each on 20,000 x 9 rows on the GPU and on the CPU: the same
   dropped sets (printed), the last-round training metric by phase 9's
   rule, identical trees counted. 13b: gblinear on the same rows (eta 0.5,
   lambda 1, alpha 0.01, 10 rounds): rounds/s, torch launches and device
   ms a round, validation logloss falling, the weights against the CPU
   run's within GBLINEAR_WEIGHT_TOL, the model saved, loaded and served.
   13c: phase 4's model refreshed and pruned (gamma 1) on its training
   rows with 10 % of the labels flipped, on the GPU and on the CPU: trees
   equal in feature/threshold/is_leaf, leaf values within 1e-5, the splits
   pruned and the wall times. 13d: `training.entry` in a child process
   with booster=dart and with booster=gblinear on phase 8's channels, 10
   rounds (exit 0, one HPO-regex line a round); both models served 1,000
   csv rows through `serving_entrypoint`, the gblinear one also through
   the MME's POST /models + invoke, within 1e-5 of the CPU predict; last,
   manifests written beside the dart run's checkpoints and one digit of the
   newest changed: a rerun resumes from the checkpoint before it;
14. constraints and the exact and approx tree methods. 14a: the main path
   (phase 4's rows, depth 8, 10 rounds) with monotone_constraints +1 on
   feature 0 and interaction_constraints [[0,3],[1,2],[4..27]]: 8
   hist_kernel and 1 totals_kernel launches a round, logloss falling,
   every split on feature 0 with its children's base weights in order (the
   JAX code orders a split's two children only, so the model as a whole
   need not be monotone), every root-to-leaf path within one set, rounds/s
   over rounds 2-6 and launches, device ms and busy share over rounds 7-9;
   then 20,000 x 9 rows on the GPU and on the CPU by phase 9's rule. 14b:
   tree_method=exact on phase 2's rounded rows, 5 rounds: B, the
   histogram's share of device time, rounds/s, logloss falling; the saved
   model predicting 10k rows on the GPU within 1e-5 of the CPU; 20,000 x 9
   rounded rows GPU vs CPU. 14c: tree_method=approx on the main path,
   max_bin 256, 10 rounds with the 100k validation rows: the re-sketch on
   the card before every round (CUDA events; no host sketch inside a
   round) and its share of the round, rounds/s, the cuts of rounds 1 and 2
   differing, the incremental validation logloss within 5e-3 of a fresh
   predict of the saved model; GPU vs CPU on 20,000 x 9 rows with
   GRAFT_SKETCH_IMPL=device on both; dart + approx, 3 rounds on those rows
   on both devices, the same dropped sets. 14d: `training.entry` in a child
   process on phase 8's channels with tree_method=approx and
   interaction_constraints "[[0,1],[2,3,4,5,6,7]]", 10 rounds: exit 0, one
   HPO-regex line a round, every path within one set, the model served
   through `serving_entrypoint` within 1e-5 of the CPU predict;
15. models brought from xgboost and the rest of the train contract. 15a:
   phase 11b's forest (100 trees, 28 features) on the main path's 100k
   validation rows with features 0-7 coded to categories 0..999 (quantile
   buckets): F_num sets each split on them to k - 0.5 (k the code of its
   threshold), F_cat makes it a categorical split with the right-set
   {k..999}; F_cat must predict exactly what F_num predicts, pred_leaf
   included. Then 10 % of each set's membership flipped (seed 15) and 1 %
   of the coded cells set to -1, 1e10, inf or NaN: the card's margins within
   1e-5 of the CPU port's, pred_leaf equal, the numpy host path equal on the
   first 32 rows; the device ms of a 100k-row predict of F_num and F_cat
   (CUDA events, 20 calls) with their device time and kernel launches
   (torch.profiler) and the bitmask's bytes; F_cat behind the MME (POST
   /models with a manifest that verifies). 15b: phase 4's and phase 9's
   models saved as UBJ (`save_model("*.ubj")`), as legacy binary (this
   script's writer, `legacy_binary`, by the published C structs) and as
   pickled Boosters (pickle opcodes, `pickled_booster`) whose handles hold
   JSON, UBJ and CONFIG-offset + legacy bytes: each loaded on the card (load
   ms) and served 1 and 10k csv rows within 1e-5 of the JSON model's CPU
   predict. 15c: phase 4's model's get_score of all five types equal to a
   numpy recount from its JSON, get_dump(with_stats=True) a line a node.
   15d: a user script (`USER_SCRIPT`: TorchXGBRegressor on the card, depth
   8, max_bin 256, 10 rounds on phase 8's 200k x 28 csv channel; writes
   feature_importance.json and xgboost-model) through the train entry point
   with sagemaker_program in a child process: exit 0, 80 hist_kernel and
   10 totals_kernel launches in its fit (printed by the script), the model
   served within 1e-5 of its CPU predict; then, where pyarrow imports,
   phase 8's channels written as parquet: the DataMatrix bitwise equal to
   the csv channel's, and an algorithm-mode job on them (10 rounds) exits 0
   with one HPO line a round (where it does not, a line says the check did
   not run and why);
16. the training planes of one host. 16a: the main path (phase 4's rows,
   depth 8, max_bin 256, 10 rounds) twice through `get_callbacks`' stack,
   unarmed and with SM_MODEL_TELEMETRY, SM_DEVICE_TELEMETRY,
   SM_HBM_SAMPLE_EVERY=1, SM_TRACE + SM_TRACE_DEVICE_SYNC=1 and
   SM_PROFILER_TRACE_DIR: 80 / 10 launches each; in the armed run 10
   training.round and 10 training.learning records, one summary,
   attribution (reading device_sync), roofline, compiled and trace record,
   every round with its host_dispatch and device_sync phases, the trace
   file's bytes, the validation logloss against the unarmed run's by phase
   9's rule, rounds/s over rounds 2-9 of both; the memory sample against
   memory_allocated; the learning stats' extra launches (torch.profiler) and
   host syncs (sync debug mode, must be 0) a round; the card's latency floor
   (the device time of a main-path round at 1,000 rows). 16b: the train
   entry point in child processes on phase 8's channels (8 rounds, a
   checkpoint dir): round 3 stalled by `training.round_end:sleep:60@4`
   under SM_ROUND_DEADLINE_S=5 exits 79 with one training.abort record,
   checkpoint 2 with a manifest that verifies and carries the fingerprint,
   and the flight recorder in the checkpoint dir; the restart, with
   `data.chunk:error@1` (the training channel, 67,249,980 bytes, is over
   SM_INGEST_CHUNK_BYTES' 64 MiB, so the job streams it; the child pins
   SM_INGEST_MODE=chunked), retries once, resumes at round 4, exits 0 and
   writes a model manifest with fingerprint, learning and drift baseline;
   max_depth 6 under SM_RESUME_STRICT=true exits non-zero naming max_depth;
   one read with `data.read:error@1` in this process counts one retry.
   16c, its two children at once and beside 16b's:
   `train.gradient_poison:nan@3` exits 87 with forensics naming round
   2; `chip_smoke.py --oom-child` caps the device memory so that the first
   round cannot allocate and exits 86 with hbm-forensics listing the
   largest blocks. 16d: 16b's model behind the single-model endpoint
   (SM_MODEL_TELEMETRY, SM_SERVING_METRICS): 1,000 rows drawn as the
   training rows keep model_drift_psi under 0.2, 1,000 with features 0-7
   shifted by 3 sigma drive it above and serving_state to degraded, the
   four runtime gauges on /metrics; the 1-row p50 of 1,000 requests with
   the monitor armed and unarmed. Every child prints its launch counts;
17. data-parallel training across ranks. 17a: the main path's rows split
   unevenly, 500,003 / 499,997, over two ranks, each a child process
   (`chip_smoke.py --rank-child`) on cuda:0, joined by a gloo process group
   (`parallel/distributed.init_process_group(..., backend="gloo")`: NCCL
   refuses two ranks on one device), each with half of the validation rows;
   10 rounds of `train(group=)`: the two saved models byte-equal, the
   validation logloss (every rank's partial sums combined) identical on
   both, falling every round and within ENTRY_METRIC_TOL of one rank's
   10 rounds on all rows; per rank: rounds/s over rounds 2-9, 8 / 1
   launches a round, the host syncs of one round (sync debug mode) beside
   its gloo collectives (each on CUDA tensors waits on the host), the
   bytes reduced a round against the count from the shapes (128 node
   histograms x 28 x 257 x 2 x 4 B + 2,048 B of totals = 7,370,752 B) and
   round_comm_plan, and the collectives' ms a round (host clock around the
   calls and waits). 17b: `training.entry` (`--entry-child`) in two child
   processes with SM_HOSTS ["127.0.0.1", "localhost"], each with its half
   of phase 8's channels (20 rounds), SM_PROCESS_GROUP_BACKEND=gloo,
   SM_TRACE, SM_FLEET_TRACE and SM_STATUS_PORT: both exit 0 with identical
   HPO lines, GET /status answers mid-run with the current round, SIGQUIT
   to rank 1 writes its dump and the job goes on, rank 0 alone writes
   xgboost-model and a trace-fleet.json with two rank lanes, 8 hist_kernel
   launches a round each. 17c: the same with SM_ABORT_ON_STALE and
   heartbeats every second, rank 1 SIGKILLed at its 3rd round end
   (`training.round_end:kill@3`): rank 0 exits 80 within the process
   group's timeout plus a margin, with one training.abort record and no
   model. NCCL and the reduce_scatter lowering do not run here: the box has
   one GPU, and gloo reduce-scatters no CUDA tensors;
18. the options that train across ranks, each on two gloo ranks on cuda:0
   (one pair of `chip_smoke.py --rank-child` processes for all of them, with
   GRAFT_HEARTBEAT_TIMEOUT_S=5 and heartbeats every second), each against
   one rank on all rows: the two models byte-equal, the metric lines
   identical, the last-round validation metric within OPTION_TOL x max(1,
   |metric|) of one rank's; per rank rounds/s over rounds 2 to the last,
   launches (8 / 1 a round where a tree grows, 0 for gblinear and update),
   collectives, their ms and their bytes a round by kind. 18f first: rank 1
   sleeps 12 s before the first collective while its heartbeat thread
   beats, and rank 0 must wait for it. 18a: tree_method=approx on phase
   17a's split, 6 rounds, with the re-sketch and the cut gather timed
   (CUDA-synchronized around `_resketch_bins`) and the candidate bytes
   gathered a round. 18b: dart (phase 13a's parameters, 6 rounds),
   gblinear (phase 13b's, 10 rounds) and update (refresh and prune, gamma
   1, of a 10-round hist model on the labels with 10 % flipped). 18c:
   phase 10a's MSLR-shaped rank:ndcg, whole queries to each rank (1,000 /
   1,000 and 250 / 250), 5 rounds. 18d: survival:cox with cox-nloglik on
   200k x 28 rows split 120,007 / 79,993 (20k validation rows split 11,003
   / 8,997), 6 rounds. 18e: `_kfold=3` through the train entry point on two
   hosts (17b's channels, 10 rounds a fold): both exit 0 with identical
   metric lines, rank 0 saves the three fold models, each host writes the
   out-of-fold predictions of its own rows.
19. streaming (chunked) ingest through the train entry point, in
   `--entry-child` processes (each under a launcher that reaps it with
   os.wait4 for its peak RSS, and with CHIP_SMOKE_INGEST_REPORT set, so
   that it prints the sha256 of the bins and cuts its session got and the
   chunks it read). 19a: the main path's 1M + 100k rows rounded to 2^-9
   (exact sketch) as csv channels of 366,000,000 + 36,600,000 bytes, 5
   rounds, SM_INGEST_MODE=whole and auto with 16 MiB chunks at once: auto
   streams (the channel is over 64 MiB), both sessions get the same bins
   and cuts, the models are byte-equal or within phase 8's tolerance (the
   card's histograms add in a varying order); each child's ingest time,
   chunks, time before the first round, rounds/s and peak RSS. 19b on
   phase 8's channels at 4 MiB chunks with a corrupt file beside the
   training file: skip exits 0 with ingest-quarantine.json and the same
   quarantine in the model's manifest, fail exits 85 with one
   training.abort, chunked with tree_method=approx exits 1 with the JAX
   package's refusal. 19c: two hosts, chunked, the channels split 120,007
   / 79,993 (30,001 / 19,999 validation): both exit 0, the same cuts,
   identical lines, byte-equal models (every rank saves a copy), the
   validation logloss within OPTION_TOL x max(1, |logloss|) of 19b's one
   host on the same rows.
20. the elastic shrink and the consensus guard through the train entry
   point: three `--entry-child` hosts of one box (127.0.0.1, 127.0.0.2,
   localhost) on cuda:0 over gloo, each with its third of the main path's
   1M + 100k rows (on 19a's 2^-9 grid), depth 8, max_bin 256, 12 rounds,
   SM_CONSENSUS_EVERY=1, heartbeats every 0.5 s (stale after 6), a
   checkpoint dir a host, every rank saving its model (MODEL_COPY). 20a:
   uninterrupted: all exit 0, byte-equal models, 12 checks a rank, 96 / 12
   launches; the consensus check's ms a round (the `consensus` phase of
   the round records) and rounds/s a rank. 20b: SM_ELASTIC=1 and rank 2
   SIGKILLed at its 5th round end: the survivors exit 0 with byte-equal
   12-round models, one 3 -> 2 transition (surviving ranks [0, 1]) in the
   records and the model's manifest, rounds 1-5 equal to rank 0's
   checkpoint of round 5, 8 / 1 launches a round after the reform, the
   validation logloss within ELASTIC_LOGLOSS_TOL of 20a's; the seconds from
   the kill to the new generation's first round and rounds/s a rank before
   and after. 20c (two hosts, rank 1's digest perturbed by the
   `consensus.check` fault) and 20d (20b's kill with `rendezvous.reform`
   faulted) at once: 20c exits 81 on both with one training.divergence
   record each carrying both digests, 20d's survivors exit 82 with a
   flight-recorder dump each.
21. one training process per local GPU through the train entry point
   (`--entry-child` processes; `SM_LOCAL_RANKS`, `parallel/local.py`) on
   19a's channels (the main path's 1M + 100k rows on the 2^-9 grid,
   whole-file ingest), 10 rounds. 21a: no SM_LOCAL_RANKS, one card: no
   process spawned, 80 / 10 launches, the model within phase 8's tolerance
   of 21b's. 21b: SM_LOCAL_RANKS=2 over gloo, both ranks on cuda:0: exit 0,
   one model, each HPO line once, 80 / 10 launches on each rank (the worker
   prints its own, `local_rank_child`), the session's cuts' sha256 equal to
   21a's, the validation logloss within OPTION_TOL x max(1, |logloss|) of
   21a's; rounds/s a rank over rounds 2-9, the histogram collective's ms a
   round, each process's peak RSS (the leader's os.wait4, and VmRSS sampled
   every 50 ms in each), the seconds from start to the first round. 21c:
   two entry hosts x SM_LOCAL_RANKS=2 (four gloo ranks on the card) on
   phase 8's channels halved: both exit 0, host 0 alone writes the model;
   at the same time the same job with host 1's local rank 1 SIGKILLed at
   its 3rd round end (`SM_LOCAL_FAULT_SPEC`): both hosts exit 80, the
   failure file names the dead rank, no worker is left. 21d, only with two
   GPUs: 21b over NCCL between two cards under both GRAFT_HIST_COMM
   lowerings; else it prints `nccl_local: not run (1 GPU)`.
22. the elastic shrink with local ranks: phase 20's three `--entry-child`
   hosts and channels, each host SM_ELASTIC=1 and SM_LOCAL_RANKS=2 (six
   gloo ranks on the card), host 2's local rank 1 SIGKILLed at its round-5
   end (`SM_LOCAL_FAULT_SPEC`): host 2 exits 80 and hosts 0-1 exit 0 with
   byte-equal 12-round models, one 3 -> 2 transition (surviving ranks [0,
   1]), rounds 1-5 equal to host 0's checkpoint of round 5, 8 / 1 launches
   a round after the reform on every surviving rank (each prints its
   counts as the reform begins), the validation logloss within
   ELASTIC_LOGLOSS_TOL of 20a's; rounds/s a rank before and after, the
   seconds from the kill to the new generation's first round, the
   histogram collective's ms a round and each process's peak RSS. NCCL's
   reform between local cards does not run here: it prints `nccl: not run
   (1 GPU)`.

23. the native data plane (data/native.py over native/fastdata.cpp): its
   cache removed, the library built with g++ (route and seconds printed;
   the run fails unless it loads); ~60 MB of seeded libsvm text (200k rows
   x 28 features with weights and qid:) parsed by the native tokenizer on
   its default threads and on one (GRAFT_PARSE_THREADS=1), a tenth of it by
   the Python tokenizer too: MB/s of each, the pieces equal; phase 7's
   model's 1-row and 32-row host predict_margin, native and
   GRAFT_HOST_PREDICT_IMPL=numpy: the median us of 200 calls each, the
   answers within 1e-6.

At the end, one wall-time line a phase. The second line from the end is
the kernels JSON line, the last line the device JSON line. Needs one CUDA
GPU; exits 2 without one.
"""

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
REPLACES = {
    "hist_kernel": "sagemaker_xgboost_container_tpu/ops/histogram.py:784",
    "totals_kernel": "sagemaker_xgboost_container_tpu/ops/histogram.py:505",
}
# main-path sizes (bench.py's binary workload)
N_TRAIN, N_VAL, N_FEATURES, N_SERVE, ROUNDS = 1_000_000, 100_000, 28, 10_000, 5
SMALL = (20_000, 12)
HIST_CASES = (  # n, d, W, B, bin dtype, node distribution, timed
    (1_000_000, 28, 1, 257, np.uint16, "random", True),
    (1_000_000, 28, 64, 257, np.uint16, "random", True),
    (1_000_000, 28, 64, 257, np.uint16, "left", True),
    # a lossguide split step's left child: 1/64 of the rows in the node
    (1_000_000, 28, 1, 257, np.uint16, "step", True),
    (1_000_000, 28, 64, 257, np.uint16, "one", False),
    (1_000_000, 28, 64, 257, np.uint16, "half_empty", False),
    (1_000_000, 28, 64, 257, np.uint16, "none", False),
    (100, 28, 8, 257, np.uint16, "random", False),
    (1_000_000, 28, 130, 257, np.uint16, "random", False),
    (0, 28, 4, 257, np.uint16, "random", False),
    (12_345, 5, 3, 33, np.uint16, "random", False),
    (1_000_003, 28, 128, 256, np.uint8, "random", False),
)
# the class axis (one launch for C classes sharing the bins), at CoverType's
# shape: n, d, W, B, bin dtype, node distribution, timed, C
HIST_CLASS_CASES = (
    (581_012, 54, 64, 257, np.uint16, "random", True, 7),
    (200_000, 54, 64, 257, np.uint16, "class_empty", False, 2),
    (581_012, 54, 1, 257, np.uint16, "random", False, 7),
    (20, 54, 8, 257, np.uint16, "random", False, 3),
    (581_012, 54, 64, 256, np.uint8, "random", False, 7),
)
# exact's width (phase 2): the main path's rows rounded to multiples of
# 2^-9, binned at every distinct value; then wider B against the plain
# version: 8,193 (one feature a CTA) and 20,001 (two bin tiles a feature)
EXACT_GRID = 2.0 ** -9
HIST_WIDE_CASES = (
    (1_000_000, 28, 64, 8_193, np.uint16, "left", False),
    (1_000_000, 28, 16, 20_001, np.uint16, "random", False),
)
# the timed hist case whose numbers go into the kernels line
HIST_MAIN = "hist W=64 left"
TOTALS_CASES = (  # n, W, node distribution, timed
    (1_000_000, 256, "random", True),
    (1_000_000, 1, "random", False),
    (1_000_000, 4096, "random", False),
    (1_000_000, 256, "one", False),
    (1_000_000, 256, "none", False),
    (100, 256, "random", False),
    (0, 256, "random", False),
)
TOTALS_CLASS_CASES = (  # n, W, node distribution, timed, C
    (581_012, 256, "random", True, 7),
    (200_000, 256, "class_empty", False, 2),
    (581_012, 1, "random", False, 7),
    (20, 256, "random", False, 3),
)
MAIN_PARAMS = {"objective": "binary:logistic", "max_depth": 8, "max_bin": 256,
               "eta": 0.2, "tree_method": "hist"}
# phase 9: BASELINE.md config #3, CoverType multi:softmax, at CoverType's
# published shape (bench.py's BENCH_TASK=multiclass labels)
COVTYPE_TRAIN, COVTYPE_VAL, COVTYPE_FEATURES, COVTYPE_ROUNDS = 581_012, 58_101, 54, 10
COVTYPE_PARAMS = {"objective": "multi:softmax", "num_class": 7, "max_depth": 8,
                  "max_bin": 256, "tree_method": "hist", "eta": 0.3,
                  "eval_metric": ["mlogloss", "merror"]}
N_COVTYPE_PREDICT, N_COVTYPE_SERVE = 10_000, 1_000
# phase 10a: BASELINE.md config #4, MSLR-WEB30K rank:ndcg (LambdaMART), at
# MSLR's 136 features and its spread of query sizes (a mean of about 120
# documents, a tail to about 1,250), with 2,000 of its 31,531 queries
# (bench.py's BENCH_TASK=ranking relevance)
RANK_QUERIES, RANK_VAL_QUERIES, RANK_FEATURES, RANK_ROUNDS = 2_000, 500, 136, 10
RANK_MEAN_GROUP, RANK_MAX_GROUP = 120, 1_250
RANK_PARAMS = {"objective": "rank:ndcg", "max_depth": 8, "max_bin": 256, "tree_method": "hist",
               "eta": 0.1, "eval_metric": ["ndcg@10", "map@10"]}
RANK_GRAD_QUERIES, N_RANK_PREDICT = 200, 10_000
# the train entry point on a libsvm channel with qid: tokens
RANK_ENTRY_QUERIES, RANK_ENTRY_HP = (60, 20), {
    "objective": "rank:pairwise", "num_round": "5", "max_depth": "6", "max_bin": "64",
    "eta": "0.3", "eval_metric": "ndcg@5,map@10"}
# phase 10b: bench.py's BENCH_TASK=lossguide on the main path's rows
LOSSGUIDE_PARAMS = {"objective": "binary:logistic", "grow_policy": "lossguide",
                    "max_leaves": 255, "max_depth": 0, "max_bin": 256, "tree_method": "hist",
                    "eta": 0.2}
LOSSGUIDE_ROUNDS, N_LOSSGUIDE_SERVE = 5, 1_000
# the GPU-vs-CPU sweep of the objectives beyond the main path: label kind
# (of a positive score S), extra parameters
SWEEP_SHAPE = (20_000, 9)
SWEEP = (
    ("reg:squaredlogerror", "score", {}),
    ("reg:pseudohubererror", "score", {}),
    ("reg:absoluteerror", "score", {}),
    ("reg:gamma", "score", {}),
    ("reg:tweedie", "score", {"tweedie_variance_power": 1.3}),
    ("binary:logitraw", "binary", {}),
    ("binary:hinge", "binary", {}),
    ("count:poisson", "count", {}),
    ("multi:softmax", "class", {"num_class": 3}),
    ("multi:softprob", "class", {"num_class": 3}),
    ("survival:aft", "score", {"base_score": 1.0}),
    ("survival:cox", "censored", {}),
    ("rank:pairwise", "rank", {}),
    ("rank:ndcg", "rank", {}),
    ("rank:map", "rank", {}),
    ("binary:logistic", "binary", {"grow_policy": "lossguide", "max_leaves": 31,
                                   "max_depth": 0}),
    ("multi:softprob", "class", {"num_class": 3, "grow_policy": "lossguide",
                                 "max_leaves": 31, "max_depth": 0}),
)
SWEEP_GROUP = 100  # the ranking objectives' query size in the sweep
# the last-round metric, GPU against CPU, relative to max(1, |metric|):
# phase 5's 1e-4 where every tree is the same; where a split differs (the
# GPU's f32 atomics add in another order, and a near-tie then goes either
# way: on an H100 reg:pseudohubererror once kept 1 of 3 trees alike, mphe
# 2.0e-4 apart) the spread of two GPU runs, phase 8's 1e-2
SWEEP_METRIC_TOL, SWEEP_SPLIT_TOL = 1e-4, 1e-2
# the served model: up to 511 nodes a tree, 80 of its 100 rounds served
SERVE_TRAIN_ROWS, SERVE_ROUNDS, SERVE_BEST_ITERATION = 200_000, 100, 79
SERVE_LOADS = ((1, 16, 50), (100, 16, 20), (10_000, 1, 10))  # rows, threads, requests each
SOURCES = {
    "hist_kernel": "sagemaker_xgboost_container_tpu_torch/csrc/hist_kernel.cu",
    "totals_kernel": "sagemaker_xgboost_container_tpu_torch/csrc/totals_kernel.cu",
}


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_tag():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters=20, warmup=3):
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


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log, prefix):
    """The -Xptxas -v lines (registers, shared memory, spills) of the kernels
    whose names hold `prefix`, one line per kernel."""
    out, name, facts = [], None, []

    def flush():
        if name is not None:
            out.append("ptxas {}: {}".format(name, "; ".join(facts)))

    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            flush()
            # the last match: the mangled name holds the file's name first
            found = re.findall(prefix + r"[a-z]+(?:I[a-z]?(?:Lb[01]E)?E)?", m.group(1))
            name, facts = (found[-1] if found else None), []
        elif name is not None and ("Used" in line or "spill" in line):
            facts.append(line.split(":", 1)[-1].strip() if "ptxas" in line else line.strip())
    flush()
    return out


def sass_atomics(lib_path, prefix):
    """The shared- and global-memory atomic instructions (ATOM*, RED*: SASS
    opcodes with their counts) of each kernel whose name holds `prefix`,
    from cuobjdump, as {kernel: {opcode: count}}; None without cuobjdump.
    f32 atomicAdd on shared memory shows up as a compare-and-swap loop."""
    from torch.utils.cpp_extension import CUDA_HOME

    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.findall(prefix + r"[a-z]+(?:I[a-z]?(?:Lb[01]E)?E)?", line)
            name = found[-1] if found else None
            if name is not None:
                ops.setdefault(name, {})
        elif name is not None and "*/" in line:
            op = [t for t in line.split("*/", 1)[1].split() if not t.startswith("@")]
            # REDUX is a warp reduction in registers, not an atomic
            if op and re.match(r"(ATOM|RED(?!UX))", op[0]):
                ops[name][op[0]] = ops[name].get(op[0], 0) + 1
    return ops


def report_kernels(k, prefix, atomic_free):
    """Print the ptxas and SASS lines of the kernels whose names hold
    `prefix`; with atomic_free, fail unless SASS shows them without any
    atomic instruction."""
    for line in ptxas_report(k.build_log, prefix):
        print("  " + line, flush=True)
    ops = sass_atomics(k.path, prefix)
    if ops is None:
        print("  cuobjdump not found: atomics not reported", flush=True)
        return
    for name, found in ops.items():
        print("  sass {}: {}".format(name, found or "no atomic instructions"), flush=True)
    if atomic_free:
        check(ops, "no {}* kernel found in the SASS".format(prefix))
        check(not any(ops.values()),
              "{}* kernels compiled to atomics: {}".format(prefix, ops))


# the model files phases 4, 9, 10a and 11b train, kept for phase 12's
# multi-model endpoint: {name: model dir}, under MODEL_ROOT (made on first use)
MODELS = {}
MODEL_ROOT = None


def keep_model(name, path):
    """Copy the model file at `path` to MODEL_ROOT/<name>/xgboost-model."""
    global MODEL_ROOT
    import shutil

    if MODEL_ROOT is None:
        MODEL_ROOT = tempfile.mkdtemp(prefix="chip_smoke_models_")
    d = os.path.join(MODEL_ROOT, name)
    os.makedirs(d, exist_ok=True)
    shutil.copyfile(path, os.path.join(d, "xgboost-model"))
    MODELS[name] = d


def make_data(n, d, seed=0):
    """The synthetic binary task of bench.py (same formula)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    logit = X[:, 0] * 0.8 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3]) - 0.2
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    return X, y


def node_distribution(rng, kind, n, W):
    """node_local of a hist case: "random" draws from [-1, W); "left" is a
    subtracted level's left children (children of 2W nodes, the right half
    at -1); "one" puts every row in one node; "half_empty" only in even
    nodes; "none" leaves no row active (-1, or W and beyond); "step" is a
    lossguide split step's child: 1/64 of the rows in node 0, the rest -1."""
    if kind == "random":
        return rng.randint(-1, W, n).astype(np.int32)
    if kind == "step":
        return np.where(rng.rand(n) < 1 / 64, 0, -1).astype(np.int32)
    if kind == "left":
        child = rng.randint(0, 2 * W, n)
        return np.where(child % 2 == 0, child // 2, -1).astype(np.int32)
    if kind == "one":
        return np.full(n, W // 2, dtype=np.int32)
    if kind == "half_empty":
        return (2 * rng.randint(0, (W + 1) // 2, n)).astype(np.int32)
    if kind == "none":
        return np.where(rng.rand(n) < 0.5, -1, W + rng.randint(0, 3, n)).astype(np.int32)
    raise ValueError(kind)


def class_nodes(rng, kind, n, W, classes):
    """node_local of a case: [n] for one class, else [C, n] with each class
    drawn on its own; "class_empty" leaves the last class no active row."""
    if classes == 1:
        return node_distribution(rng, kind, n, W)
    kinds = [kind] * classes
    if kind == "class_empty":
        kinds = ["random"] * (classes - 1) + ["none"]
    return np.stack([node_distribution(rng, k, n, W) for k in kinds])


def held_out_weights(n, classes):
    """[C, n]: 0 on class (fold) c's c-th C-th of the rows, 1 elsewhere: the
    weights of fold-parallel CV, whose held-out rows add g = h = 0."""
    w = np.ones((classes, n), np.float32)
    for c in range(classes):
        w[c, c * n // classes:(c + 1) * n // classes] = 0.0
    return w


def hist_case(torch, hist, n, d, W, B, np_dtype, kind, seed, timed, tag, classes=1,
              held_out=False, bins_np=None):
    """One hist_kernel check, on [n] or (classes > 1) [C, n] gradients (with
    ``held_out``, each class a CV fold whose held-out rows weigh 0), over
    uniform random bins or the [n, d] bins ``bins_np``; returns the
    measurement dict when timed."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    shape = (n,) if classes == 1 else (classes, n)
    if bins_np is None:
        bins_np = rng.randint(0, B, (n, d)).astype(np_dtype)
    bins = torch.as_tensor(bins_np, device=dev)
    fold_w = held_out_weights(n, classes) if held_out else np.ones(shape, np.float32)
    grad = torch.as_tensor(rng.randn(*shape).astype(np.float32) * fold_w, device=dev)
    hess = torch.as_tensor((rng.rand(*shape) + 0.1).astype(np.float32) * fold_w, device=dev)
    node = torch.as_tensor(class_nodes(rng, kind, n, W, classes), device=dev)

    G, H = hist.level_histogram(bins, grad, hess, node, W, B)
    Gp, Hp = hist._hist_plain(bins, grad, hess, node, W, B)
    torch.cuda.synchronize()
    err = max(float((G - Gp).abs().max()), float((H - Hp).abs().max())) if G.numel() else 0.0
    # f32 atomics sum in a varying order: allow 1e-4 of the largest cell
    scale = max(1.0, float(Gp.abs().max()) if G.numel() else 0.0,
                float(Hp.abs().max()) if G.numel() else 0.0)
    tol = 1e-4 * scale
    # integer-valued weights sum exactly in f32: the cells must match bitwise
    ones = torch.as_tensor(fold_w, device=dev)
    ints = torch.as_tensor(rng.randint(0, 4, shape).astype(np.float32) * fold_w, device=dev)
    Ge, He = hist.level_histogram(bins, ones, ints, node, W, B)
    Gq, Hq = hist._hist_plain(bins, ones, ints, node, W, B)
    exact = bool(torch.equal(Ge, Gq) and torch.equal(He, Hq))
    label = "hist_kernel n={} d={} {} B={} W={} nodes={}".format(n, d, bins.dtype, B, W, kind)
    if classes > 1:
        label += " C={}".format(classes)
    if held_out:
        label += " folds, held-out rows g=h=0"
    print("{} | {}: max_abs_err={:.3e} tol={:.3e} exact_integer_check={}".format(
        tag, label, err, tol, exact), flush=True)
    check(err <= tol, "{} disagrees with its plain version".format(label))
    check(exact, "{} integer histogram differs from its plain version".format(label))
    if not timed:
        return None

    # the folded keys (class * W + node) of the active entries
    node2, grad2, hess2 = node.reshape(-1, n), grad.reshape(-1, n), hess.reshape(-1, n)
    cls, rows = torch.nonzero((node2 >= 0) & (node2 < W), as_tuple=True)
    keys = cls * W + node2[cls, rows].long()
    ids = ((keys[:, None] * d + torch.arange(d, device=dev)) * B
           + hist.widen_rows(bins, rows)).reshape(-1)
    g_rep = grad2[cls, rows][:, None].expand(-1, d).reshape(-1).contiguous()
    h_rep = hess2[cls, rows][:, None].expand(-1, d).reshape(-1).contiguous()
    size = classes * W * d * B
    call = lambda: hist.level_histogram(bins, grad, hess, node, W, B)  # noqa: E731
    kernel = time_ms(torch, call)
    plain = time_ms(torch, lambda: hist._hist_plain(bins, grad, hess, node, W, B))
    library = time_ms(torch, lambda: (torch.bincount(ids, g_rep, minlength=size),
                                      torch.bincount(ids, h_rep, minlength=size)))
    # node read for every entry, grad and hess for the active ones, and the
    # bins once, of the rows active in some class
    n_active = int(rows.numel())
    bin_rows = int(torch.unique(rows).numel()) if classes > 1 else n_active
    nbytes = (classes * n * 4 + n_active * 8 + bin_rows * d * bins.element_size()
              + 2 * size * 4)
    b_ms, b_by = bound_ms(nbytes, 2 * n_active * d)
    out = {"max_abs_err": err, "ms": kernel, "plain_ms": plain,
           "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
           "shape": label}
    per = device_ms(torch, call, "hist_")
    out["device_ms"] = sum(per.values())
    dev_text = " device_ms={:.4f} (torch.profiler: {})".format(
        out["device_ms"], ", ".join("{} {:.4f}".format(k, v) for k, v in sorted(per.items())))
    print("{} | {}: kernel_ms={:.4f}{} plain_ms={:.4f} library_ms={:.4f} "
          "(torch.bincount with weights, G and H) bound_ms={:.4f} ({})".format(
              tag, label, kernel, dev_text, plain, library, b_ms, b_by), flush=True)
    return out


# a profiling session on an H100 machine now and then records no device
# activity at all (seen once; the same calls in the same order traced on
# the next machine): such a session is repeated
PROFILE_ATTEMPTS = 3


def profiled_kernels(torch, fn, iters, prefix=""):
    """The kernel events (name holding `prefix`) of `iters` calls of fn
    under torch.profiler (device activity), after one unprofiled call; the
    session is repeated while it records none."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if _kernel_time_us(torch, e) > 0 and prefix in e.key]
        if events:
            return events
        print("  torch.profiler recorded no {}* kernel (attempt {} of {})".format(
            prefix, attempt + 1, PROFILE_ATTEMPTS), flush=True)
    return []


def device_ms(torch, fn, prefix, iters=20):
    """Device time per call of each kernel whose name holds `prefix`."""
    per = {}
    for evt in profiled_kernels(torch, fn, iters, prefix):
        for name in re.findall(prefix + r"[a-z]+", evt.key)[-1:]:
            per[name] = per.get(name, 0.0) + _kernel_time_us(torch, evt) / 1e3 / iters
    return per


EXACT_ROWS = {}  # the rounded main-path rows, kept for phase 14b


def exact_rows():
    """The main path's rows (train, validation) rounded to EXACT_GRID: up to
    3,905 distinct values a feature, so exact binning's B is data-sized."""
    if not EXACT_ROWS:
        X, y = make_data(N_TRAIN + N_VAL, N_FEATURES, seed=0)
        Xr = (np.round(X / EXACT_GRID) * EXACT_GRID).astype(np.float32)
        EXACT_ROWS.update(X=Xr, y=y)
    return EXACT_ROWS["X"], EXACT_ROWS["y"]


def hist_exact_width(torch, hist, tag):
    """hist_kernel at tree_method=exact's width: the rounded main-path rows'
    exact bins (u16, B = distinct values + 1), level 7's left children
    timed. -> the measurement dict, with B."""
    from sagemaker_xgboost_container_tpu_torch.data.binning import bin_matrix
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    X, y = exact_rows()
    t = time.perf_counter()
    binned = bin_matrix(DataMatrix(X[:N_TRAIN], y[:N_TRAIN]), None)
    B = binned.num_bins
    print("{} | exact width: the main path's {} x {} rows rounded to multiples of 2^-9 bin "
          "to B={} ({} bins, host sketch {:.1f} s)".format(
              tag, N_TRAIN, N_FEATURES, B, binned.bins.dtype, time.perf_counter() - t),
          flush=True)
    out = hist_case(torch, hist, N_TRAIN, N_FEATURES, 64, B, np.uint16, "left", 91, True, tag,
                    bins_np=binned.bins)
    out["B"] = B
    return out


def totals_case(torch, hist, n, W, kind, seed, timed, tag, classes=1, held_out=False):
    """One totals_kernel check, on [n] or (classes > 1) [C, n] gradients
    (``held_out`` as hist_case's); returns the measurement dict when timed."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    shape = (n,) if classes == 1 else (classes, n)
    fold_w = held_out_weights(n, classes) if held_out else np.ones(shape, np.float32)
    grad = torch.as_tensor(rng.randn(*shape).astype(np.float32) * fold_w, device=dev)
    hess = torch.as_tensor((rng.rand(*shape) + 0.1).astype(np.float32) * fold_w, device=dev)
    node = torch.as_tensor(class_nodes(rng, kind, n, W, classes), device=dev)
    g, h = hist.node_totals(grad, hess, node, W)
    gp, hp = hist._totals_plain(grad, hess, node, W)
    # the order of additions is fixed by the shapes: a second call on the
    # same f32 inputs must be bitwise equal
    g2, h2 = hist.node_totals(grad, hess, node, W)
    torch.cuda.synchronize()
    err = max(float((g - gp).abs().max()), float((h - hp).abs().max()))
    tol = 1e-4 * max(1.0, float(gp.abs().max()), float(hp.abs().max()))
    same = bool(torch.equal(g, g2) and torch.equal(h, h2))
    ones = torch.as_tensor(fold_w, device=dev)
    ints = torch.as_tensor(rng.randint(0, 4, shape).astype(np.float32) * fold_w, device=dev)
    ge, he = hist.node_totals(ones, ints, node, W)
    gq, hq = hist._totals_plain(ones, ints, node, W)
    exact = bool(torch.equal(ge, gq) and torch.equal(he, hq))
    label = "totals_kernel n={} W={} nodes={}".format(n, W, kind)
    if classes > 1:
        label += " C={}".format(classes)
    if held_out:
        label += " folds, held-out rows g=h=0"
    print("{} | {}: max_abs_err={:.3e} tol={:.3e} exact_integer_check={} "
          "bitwise_equal_second_call={}".format(tag, label, err, tol, exact, same), flush=True)
    check(err <= tol, "{} disagrees with its plain version".format(label))
    check(exact, "{} integer totals differ from its plain version".format(label))
    check(same, "{} differs between two calls".format(label))
    if not timed:
        return None

    node2 = node.reshape(-1, n)
    cls, rows = torch.nonzero((node2 >= 0) & (node2 < W), as_tuple=True)
    ids = cls * W + node2[cls, rows].long()
    gv, hv = grad.reshape(-1, n)[cls, rows], hess.reshape(-1, n)[cls, rows]
    call = lambda: hist.node_totals(grad, hess, node, W)  # noqa: E731
    kernel = time_ms(torch, call)
    per = device_ms(torch, call, "totals_")
    check(set(per) == {"totals_partial", "totals_reduce"},
          "{}: profiled kernels {}, expected totals_partial and totals_reduce".format(label, per))
    dev_ms = sum(per.values())
    plain = time_ms(torch, lambda: hist._totals_plain(grad, hess, node, W))
    K = classes * W
    library = time_ms(torch, lambda: (torch.bincount(ids, gv, minlength=K),
                                      torch.bincount(ids, hv, minlength=K)))
    b_ms, b_by = bound_ms(classes * n * 12 + 2 * K * 4, 2 * int(ids.numel()))
    print("{} | {}: kernel_ms={:.4f} (CUDA events around the wrapper) device_ms={:.4f} "
          "(torch.profiler: totals_partial {:.4f} + totals_reduce {:.4f}) plain_ms={:.4f} "
          "library_ms={:.4f} (torch.bincount with weights, g and h) bound_ms={:.4f} ({})".format(
              tag, label, kernel, dev_ms, per["totals_partial"], per["totals_reduce"],
              plain, library, b_ms, b_by), flush=True)
    return {"max_abs_err": err, "ms": kernel, "device_ms": dev_ms, "plain_ms": plain,
            "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
            "shape": label}


class _RoundLog:
    """Callback: wall time at the start of training and after each round."""

    def __init__(self, torch):
        self.torch = torch
        self.times = []
        self.logloss = []

    def before_training(self, forest):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        return forest

    def after_iteration(self, forest, rnd, evals_log):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        self.logloss = list(evals_log["validation"]["logloss"])
        return False


def run_slice(torch, hist, pkg, tag):
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    n, n_val, d, rounds = N_TRAIN, N_VAL, N_FEATURES, ROUNDS
    X, y = make_data(n + n_val, d, seed=0)
    dtrain = DataMatrix(X[:n], y[:n])
    dval = DataMatrix(X[n:], y[n:])
    log = _RoundLog(torch)
    hist.reset_launch_counts()
    t0 = time.perf_counter()
    forest = pkg.train(MAIN_PARAMS, dtrain, rounds, evals=[(dval, "validation")],
                       device=DEVICE, callbacks=[log])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(hist.LAUNCHES)
    setup_s = log.times[0] - t0
    round_s = np.diff(log.times)
    print("{} | slice train: setup (binning, upload) {:.3f} s; per-round s {}; "
          "rounds/s (all 5) {:.3f}; rounds/s (rounds 2-5) {:.3f}; total {:.3f} s".format(
              tag, setup_s, [round(float(s), 4) for s in round_s],
              rounds / float(round_s.sum()), (rounds - 1) / float(round_s[1:].sum()),
              total_s), flush=True)
    print("slice launches: {}".format(json.dumps(launches)), flush=True)
    check(launches["hist_kernel"] == 8 * rounds,
          "hist_kernel launched {} times, expected {}".format(launches["hist_kernel"], 8 * rounds))
    check(launches["totals_kernel"] == rounds,
          "totals_kernel launched {} times, expected {}".format(launches["totals_kernel"], rounds))
    ll = log.logloss
    check(len(ll) == rounds and all(np.isfinite(ll)), "validation logloss missing: {}".format(ll))
    check(all(b < a for a, b in zip(ll, ll[1:])), "validation logloss did not fall: {}".format(ll))
    check(len(forest.trees) == rounds, "expected {} trees".format(rounds))

    x_serve = X[n:n + N_SERVE]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xgboost-model")
        forest.save_model(path)
        keep_model("main", path)
        served = Forest.load_model(path, device=DEVICE)
        on_cpu = Forest.load_model(path, device="cpu")
    pred = served.predict(x_serve)
    ref = on_cpu.predict(x_serve)
    lat = []
    for _ in range(10):
        t = time.perf_counter()
        served.predict(x_serve)
        lat.append((time.perf_counter() - t) * 1e3)
    err = float(np.abs(pred - ref).max())
    print("{} | serve: {} rows, GPU vs CPU predict max_abs_err={:.3e}; "
          "predict latency median {:.3f} ms (min {:.3f} ms, numpy in, numpy out)".format(
              tag, len(x_serve), err, float(np.median(lat)), float(np.min(lat))), flush=True)
    check(pred.shape == (len(x_serve),) and np.all(np.isfinite(pred)), "bad served predictions")
    check(err <= 1e-5, "GPU predict differs from CPU predict by {}".format(err))
    return launches, dtrain, dval


def run_small_parity(torch, pkg, tag):
    """The whole path on the GPU against the same path on the CPU (plain
    versions of the kernels) on a small problem. At deep, small nodes several
    splits can cut the rows identically, with gains equal in exact arithmetic;
    the kernels' f32 atomics may then pick another of them, so the check is
    on predictions, and the share of identical splits is reported."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    X, y = make_data(*SMALL, seed=1)
    X[np.random.RandomState(2).rand(*X.shape) < 0.05] = np.nan
    params = {"objective": "binary:logistic", "max_depth": 6, "max_bin": 64, "eta": 0.3}
    fg = pkg.train(params, DataMatrix(X, y), 3, device=DEVICE, verbose_eval=False)
    fc = pkg.train(params, DataMatrix(X, y), 3, device="cpu", verbose_eval=False)
    same = sum(
        int(np.sum((a.feature == b.feature) & (a.threshold == b.threshold)))
        for a, b in zip(fg.trees, fc.trees) if a.num_nodes == b.num_nodes
    )
    total = sum(b.num_nodes for b in fc.trees)
    err = float(np.abs(fg.predict(X) - fc.predict(X)).max())
    print("{} | small parity ({} x {}, depth 6, 3 rounds): identical nodes {}/{}; "
          "GPU vs CPU predict max_abs_err={:.3e}".format(
              tag, X.shape[0], X.shape[1], same, total, err), flush=True)
    check(err <= 1e-4, "GPU training differs from CPU training by {}".format(err))


def _kernel_time_us(torch, evt):
    """Device time of a kernel event; 0 for host-side ops, whose rows only
    repeat the time of the kernels they launched."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _device_rows(torch, prof, rounds):
    """Kernels of a profiled window of `rounds` rounds: (rows by device time,
    device ms a round, launches a round, fn(name) -> device ms a round of
    the kernels whose names hold name, fn(name) -> their launches a round)."""
    rows = []
    for evt in prof.key_averages():
        dev_us = _kernel_time_us(torch, evt)
        if dev_us > 0:
            # kernel names run to kilobytes of template arguments
            rows.append({"name": evt.key[:100], "calls": int(evt.count),
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows) / rounds
    launches = sum(r["calls"] for r in rows) / rounds

    def kernel_ms(name):
        return sum(r["device_ms"] for r in rows if name in r["name"]) / rounds

    def kernel_calls(name):
        return sum(r["calls"] for r in rows if name in r["name"]) / rounds

    return rows, busy_ms, launches, kernel_ms, kernel_calls


def run_profile(torch, pkg, dtrain, dval, tag):
    """Rounds 2-5 unprofiled give the host clock per round; rounds 6-9 under
    torch.profiler give the device time per kernel. Tracing slows every
    launch, so the busy share is profiled device time per round over the
    unprofiled round time."""
    # device activity only: tracing host-side ops too would slow every
    # launch further without adding device time
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    marks = []

    class Window:
        def after_iteration(self, forest, rnd, evals_log):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if rnd == 4:
                # the profiler's set-up takes seconds: keep it out of both
                # windows by restarting the clock once it is running
                prof.start()
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            return False

    pkg.train(MAIN_PARAMS, dtrain, 9, evals=[(dval, "validation")], device=DEVICE,
              callbacks=[Window()], verbose_eval=False)
    torch.cuda.synchronize()
    prof.stop()
    rounds = 4
    plain_round_ms = (marks[4] - marks[0]) * 1e3 / rounds
    profiled_round_ms = (marks[9] - marks[5]) * 1e3 / rounds
    rows, busy_ms, launches, kernel_ms, kernel_calls = _device_rows(torch, prof, rounds)
    for r in rows[:15]:
        print("  {:9.3f} ms {:6d} calls  {}".format(r["device_ms"], r["calls"], r["name"]))
    for name in ("hist_count", "hist_scan", "hist_scatter", "hist_kernel", "hist_reduce",
                 "totals_partial", "totals_reduce"):
        print("  {}: {:.4f} ms/round, {:.0f} launches/round".format(
            name, kernel_ms(name), kernel_calls(name)), flush=True)
    # the histogram is every hist_* kernel level_histogram enqueues, the
    # totals every totals_* kernel node_totals enqueues
    print("{} | profile: rounds 2-5 {:.3f} ms/round host clock; rounds 6-9 profiled "
          "{:.3f} ms/round, {:.0f} kernel launches/round, device {:.3f} ms/round "
          "(histogram, all hist_* kernels, {:.3f} in {:.0f} launches; totals, all "
          "totals_* kernels, {:.4f} in {:.0f} launches); device busy {:.1%} of an "
          "unprofiled round".format(
              tag, plain_round_ms, profiled_round_ms, launches, busy_ms,
              kernel_ms("hist_"), kernel_calls("hist_"), kernel_ms("totals_"),
              kernel_calls("totals_"), busy_ms / plain_round_ms), flush=True)


def _csv_body(x):
    # %.9g round-trips float32, so the server decodes the exact values
    return "\n".join(",".join("%.9g" % v for v in row) for row in x).encode()


def _libsvm_body(x):
    return "\n".join(" ".join("%d:%.9g" % (j + 1, v) for j, v in enumerate(row)
                              if not np.isnan(v)) for row in x).encode()


class _Client:
    """HTTP calls with a timeout, keeping every status seen: the phase fails
    on any 5xx it did not provoke."""

    def __init__(self, base):
        self.base = base
        self.statuses = []
        self.lock = threading.Lock()

    def call(self, path, body=None, content_type="text/csv", accept=None):
        headers = {"Content-Type": content_type}
        if accept:
            headers["Accept"] = accept
        req = urllib.request.Request(self.base + path, data=body, headers=headers,
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status, out = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, out = e.code, e.read()
        with self.lock:
            self.statuses.append(status)
        return status, out


def _serve_once(model_dir, rows, want):
    """The model in `model_dir` behind `serving_entrypoint` on the card: /ping,
    then `rows` as one csv request, checked within 1e-5 of `want` (the CPU
    predict). -> (request ms, max_abs_err)."""
    return _serve_cases(model_dir, [(rows, want)])[0]


def _serve_cases(model_dir, cases):
    """`_serve_once` for each (rows, want) of `cases` behind one server.
    -> [(request ms, max_abs_err)] in the order of `cases`."""
    from sagemaker_xgboost_container_tpu_torch.serving import lifecycle, server

    os.environ["SM_MODEL_DIR"] = model_dir
    httpd = server.serving_entrypoint(port=0, block=False, device=DEVICE)
    loop = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    try:
        client = _Client("http://127.0.0.1:{}".format(httpd.server_port))
        status, _ = client.call("/ping")
        check(status == 200, "/ping answered {}".format(status))
        out = []
        for rows, want in cases:
            t = time.perf_counter()
            status, body = client.call("/invocations", _csv_body(rows), "text/csv", "text/csv")
            serve_ms = (time.perf_counter() - t) * 1e3
            check(status == 200, "/invocations answered {}".format(status))
            got = _decode_scores(body, "text/csv")
            check(got.shape == want.shape and np.all(np.isfinite(got)),
                  "served {} answers for {} rows".format(got.shape, len(want)))
            err = float(np.abs(got - want).max())
            check(err <= 1e-5, "served predictions differ from the CPU predict by {}".format(
                err))
            out.append((serve_ms, err))
    finally:
        httpd.stop()
        loop.join(10)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.environ.pop("SM_MODEL_DIR", None)
        lifecycle.uninstall()
    return out


def _decode_scores(body, accept):
    if accept == "text/csv":
        return np.asarray([float(v) for v in body.decode().split("\n")])
    if accept == "application/json":
        return np.asarray([p["score"] for p in json.loads(body)["predictions"]])
    if accept == "application/jsonlines":
        return np.asarray([json.loads(line)["score"] for line in body.decode().splitlines()])
    from sagemaker_xgboost_container_tpu_torch.data.recordio import read_recordio_protobuf

    return read_recordio_protobuf(body)[0][:, 0]


def _percentiles(lat_ms):
    p50, p95, p99 = np.percentile(lat_ms, [50, 95, 99])
    return "p50 {:.3f} ms, p95 {:.3f} ms, p99 {:.3f} ms".format(p50, p95, p99)


def _load(base, targets, threads, per_thread):
    """`threads` clients each POST `per_thread` csv requests to (path, body,
    want) `targets`, client thread i starting at target i and taking the
    next one on each request, and check every answer against its `want`.
    -> (latencies ms, wall s, failed statuses, every status)."""
    client = _Client(base)
    # urllib builds its opener and imports lazily on the first call, which
    # takes ~100 ms when the threads race for it: once before the clock
    client.call("/ping")
    lat, errs = [], []

    def worker(i):
        for k in range(per_thread):
            path, body, want = targets[(i + k) % len(targets)]
            t = time.perf_counter()
            status, out = client.call(path, body, "text/csv", "text/csv")
            lat.append((time.perf_counter() - t) * 1e3)
            if status != 200 or np.abs(_decode_scores(out, "text/csv") - want).max() > 1e-5:
                errs.append(status)

    t = time.perf_counter()
    pool = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(300)
        check(not th.is_alive(), "a client thread did not finish")
    return lat, time.perf_counter() - t, errs, client.statuses


def load_child(spec_path):
    """`chip_smoke.py --load SPEC`: `_load` from a process of its own, so
    that the clients do not share the server's interpreter lock, over the
    targets of a JSON spec {"base", "targets": [[path, body file, want
    file], ...], "threads", "per_thread"}; prints one JSON line."""
    with open(spec_path) as f:
        spec = json.load(f)
    targets = []
    for path, body_path, want_path in spec["targets"]:
        with open(body_path, "rb") as f:
            targets.append((path, f.read(), np.load(want_path)))
    lat, wall, errs, statuses = _load(spec["base"], targets, spec["threads"],
                                      spec["per_thread"])
    print(json.dumps({"lat_ms": lat, "wall_s": wall, "failed": errs, "statuses": statuses}))
    return 0


def _child_load(base, tmp, targets, threads, per_thread):
    """`_load` over (path, rows, want) targets, run by `chip_smoke.py
    --load` in a child process."""
    spec = {"base": base, "threads": threads, "per_thread": per_thread, "targets": []}
    for i, (path, x, want) in enumerate(targets):
        body_path = os.path.join(tmp, "target{}.csv".format(i))
        want_path = os.path.join(tmp, "target{}.npy".format(i))
        with open(body_path, "wb") as f:
            f.write(_csv_body(x))
        np.save(want_path, want)
        spec["targets"].append([path, body_path, want_path])
    spec_path = os.path.join(tmp, "load-spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--load", spec_path],
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, "load client failed: {}".format(out.stderr[-2000:]))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return res["lat_ms"], res["wall_s"], res["failed"], res["statuses"]


def _device_split(torch, forest, x, rounds, reps=20):
    """Median (H2D, traversal, D2H, host total) ms of the device predict's
    steps, CUDA events between them."""
    from sagemaker_xgboost_container_tpu_torch.ops.predict import forest_predict_margin

    _, dev = forest._stack(0, forest.iteration_indptr[rounds])
    base = forest.objective().base_margin(forest.base_score)
    rows = []
    for _ in range(reps + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev[0].record()
        xt = torch.as_tensor(x, dtype=torch.float32, device=DEVICE)
        ev[1].record()
        margin = forest_predict_margin(dev, xt, base_margin=base)
        ev[2].record()
        margin.cpu().numpy()
        ev[3].record()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)] + [total])
    return np.median(np.asarray(rows[2:]), axis=0)


def host_probe(model_path):
    """`chip_smoke.py --host-probe MODEL`: time the request decode and the
    host predict path on the CPU in this process, print one JSON line. Run
    twice by the serve phase, with and without OMP_NUM_THREADS=1 set before
    torch is imported."""
    import torch

    from sagemaker_xgboost_container_tpu_torch.data import native
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.serving import serve_utils

    forest = Forest.load_model(model_path, device="cpu")
    x, _ = make_data(10_000, N_FEATURES, seed=5)
    out = {"omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
           "torch_threads": torch.get_num_threads()}
    for n, reps in ((1, 200), (100, 50), (10_000, 3)):
        body = _csv_body(x[:n])
        t = time.perf_counter()
        for _ in range(reps):
            serve_utils.parse_content_data(body, "text/csv")
        out["decode_csv_{}_ms".format(n)] = (time.perf_counter() - t) * 1e3 / reps
    rng = serve_utils.best_iteration_range(forest)
    for n in (1, 32):
        t = time.perf_counter()
        for _ in range(100):
            forest.predict(x[:n], iteration_range=rng)
        out["host_predict_{}_ms".format(n)] = (time.perf_counter() - t) * 10
    out["native_routes"] = dict(native.NATIVE_ROUTES)
    print(json.dumps(out))
    return 0


def run_serve(torch, pkg, hist, tag):
    """Phase 7: the serve entry point on the card (see the module docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        _serve(torch, pkg, hist, tag, tmp)
    print("{} | serve phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _serve(torch, pkg, hist, tag, tmp):
    from wsgiref.simple_server import make_server

    from sagemaker_xgboost_container_tpu_torch.data import native
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.data.recordio import write_recordio_protobuf
    from sagemaker_xgboost_container_tpu_torch.models import compat
    from sagemaker_xgboost_container_tpu_torch.models import forest as forest_mod
    from sagemaker_xgboost_container_tpu_torch.serving import app as app_mod
    from sagemaker_xgboost_container_tpu_torch.serving import lifecycle, server

    t0 = time.perf_counter()
    X, y = make_data(SERVE_TRAIN_ROWS, N_FEATURES, seed=3)
    forest = pkg.train(MAIN_PARAMS, DataMatrix(X, y), SERVE_ROUNDS, device=DEVICE,
                       verbose_eval=False)
    torch.cuda.synchronize()
    forest.set_attr(best_iteration=SERVE_BEST_ITERATION)
    rounds = SERVE_BEST_ITERATION + 1
    json_dir, ubj_dir = os.path.join(tmp, "json"), os.path.join(tmp, "ubjson")
    os.makedirs(json_dir)
    os.makedirs(ubj_dir)
    path = os.path.join(json_dir, "xgboost-model")
    forest.save_model(path)
    keep_model("serve", path)   # phase 23 times its host predict
    with open(os.path.join(ubj_dir, "xgboost-model"), "wb") as f:
        f.write(compat.encode_ubjson(json.loads(forest.save_json())))
    nodes = max(t.num_nodes for t in forest.trees)
    print("{} | serve model: {} rounds of depth-8 binary:logistic on {} x {} rows in {:.3f} s "
          "(up to {} nodes a tree), best_iteration {}".format(
              tag, SERVE_ROUNDS, SERVE_TRAIN_ROWS, N_FEATURES, time.perf_counter() - t0,
              nodes, SERVE_BEST_ITERATION), flush=True)

    x_all, _ = make_data(N_SERVE, N_FEATURES, seed=4)
    x_all[np.random.RandomState(5).rand(*x_all.shape) < 0.02] = np.nan
    on_cpu = forest_mod.Forest.load_model(path, device="cpu")
    ref = on_cpu.predict(x_all, iteration_range=(0, rounds))

    os.environ["SM_MODEL_DIR"] = json_dir
    hist.reset_launch_counts()
    forest_mod.reset_predict_counts()
    httpd = server.serving_entrypoint(port=0, block=False, device=DEVICE)
    loop = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    client = _Client("http://127.0.0.1:{}".format(httpd.server_port))
    service = httpd.get_app().service
    ubj_httpd = None
    try:
        t = time.perf_counter()
        status, _ = client.call("/ping")
        check(status == 200, "/ping answered {}".format(status))
        check(service.warmup.join(60) is None and not service.warmup.is_alive(),
              "warmup did not finish")
        first_s = time.perf_counter() - t
        status, body = client.call("/execution-parameters")
        params = json.loads(body)
        check(status == 200 and params["BatchStrategy"] == "MULTI_RECORD",
              "/execution-parameters answered {} {}".format(status, body[:100]))
        print("{} | serve: /ping 200 (model load + warmup {:.3f} s), /execution-parameters {}"
              .format(tag, first_s, params), flush=True)

        # ---- correctness: every content type x every accept, 10k rows
        t_check = time.perf_counter()
        bodies = {"text/csv": _csv_body(x_all), "text/libsvm": _libsvm_body(x_all),
                  "application/x-recordio-protobuf": write_recordio_protobuf(x_all)}
        worst = 0.0
        for ctype, body in bodies.items():
            for accept in ("text/csv", "application/json", "application/jsonlines",
                           "application/x-recordio-protobuf"):
                status, out = client.call("/invocations", body, ctype, accept)
                check(status == 200, "{} -> {} answered {}".format(ctype, accept, status))
                got = _decode_scores(out, accept)
                check(got.shape == ref.shape and np.all(np.isfinite(got)),
                      "{} -> {}: bad answer shape {}".format(ctype, accept, got.shape))
                err = float(np.abs(got - ref).max())
                worst = max(worst, err)
                check(err <= 1e-5, "{} -> {}: max_abs_err {} against the CPU predict".format(
                    ctype, accept, err))
        os.environ["SAGEMAKER_INFERENCE_OUTPUT"] = "predicted_label,probability"
        try:
            status, out = client.call("/invocations", bodies["text/csv"], "text/csv",
                                      "application/json")
        finally:
            del os.environ["SAGEMAKER_INFERENCE_OUTPUT"]
        check(status == 200, "selectable inference answered {}".format(status))
        sel = json.loads(out)["predictions"]
        prob = np.asarray([p["probability"] for p in sel])
        check(np.abs(prob - ref).max() <= 1e-5
              and [p["predicted_label"] for p in sel] == [int(v > 0.5) for v in ref],
              "selectable inference disagrees with the CPU predict")
        # the UBJSON copy of the model, served by a second server
        ubj_app = app_mod.make_app(app_mod.ScoringService(ubj_dir, device=DEVICE))
        ubj_httpd = make_server("127.0.0.1", 0, ubj_app, server_class=server._ThreadedWSGIServer,
                                handler_class=server._QuietHandler)
        threading.Thread(target=ubj_httpd.serve_forever, daemon=True).start()
        ubj_client = _Client("http://127.0.0.1:{}".format(ubj_httpd.server_port))
        status, out = ubj_client.call("/invocations", bodies["application/x-recordio-protobuf"],
                                      "application/x-recordio-protobuf", "text/csv")
        ubj_err = float(np.abs(_decode_scores(out, "text/csv") - ref).max())
        check(status == 200 and ubj_err <= 1e-5, "UBJSON model: {} err {}".format(status, ubj_err))
        ubj_httpd.stop()
        ubj_httpd = None
        client.statuses.extend(ubj_client.statuses)
        # provoked errors: 204, 415, 406, 400
        wide = _csv_body(np.hstack([x_all[:5], x_all[:5, :2]]))
        provoked = [client.call("/invocations", b"", "text/csv")[0],
                    client.call("/invocations", b"<x/>", "application/xml")[0],
                    client.call("/invocations", bodies["text/csv"][:200].rsplit(b"\n", 1)[0],
                                "text/csv", "text/html")[0],
                    client.call("/invocations", wide, "text/csv")[0]]
        check(provoked == [204, 415, 406, 400], "error codes {}".format(provoked))
        print("{} | serve correctness: {} rows x (csv, libsvm, recordio-protobuf) x (csv, "
              "json, jsonlines, recordio-protobuf) max_abs_err {:.3e} against the CPU predict "
              "(iteration_range (0, {})); selectable inference ok; UBJSON model max_abs_err "
              "{:.3e}; errors 204/415/406/400 as expected ({:.1f} s)".format(
                  tag, len(x_all), worst, rounds, ubj_err, time.perf_counter() - t_check),
              flush=True)

        # ---- latency and throughput, end to end over HTTP, the clients in a
        # process of their own; 1-row requests again from threads of this
        # process, which share the server's interpreter lock
        served = service.model
        loads = [(n, threads, per_thread, "child process")
                 for n, threads, per_thread in SERVE_LOADS]
        loads.append((1, 16, 20, "threads of the server's process"))
        for n, threads, per_thread, where in loads:
            x = x_all[:n]
            before = service.batcher.stats()
            forest_mod.reset_predict_counts()
            native.reset_native_routes()
            if where == "child process":
                lat, wall, errs, statuses = _child_load(
                    client.base, tmp, [("/invocations", x, ref[:n])], threads, per_thread)
            else:
                lat, wall, errs, statuses = _load(
                    client.base, [("/invocations", _csv_body(x), ref[:n])], threads, per_thread)
            client.statuses.extend(statuses)
            check(len(lat) == threads * per_thread and not errs,
                  "{} wrong or failed answers at {} rows: {}".format(len(errs), n, errs[:5]))
            counts = dict(forest_mod.PREDICTS)
            routes = dict(native.NATIVE_ROUTES)
            after = service.batcher.stats()
            delta = {k: after[k] - before[k] for k in after}
            inproc = []
            for _ in range(20 if n < 10_000 else 10):
                t = time.perf_counter()
                served.predict(x, iteration_range=(0, rounds))
                inproc.append((time.perf_counter() - t) * 1e3)
            split = ("H2D {:.4f} + traversal {:.4f} + D2H {:.4f} ms (CUDA events), "
                     "{:.4f} ms host clock".format(*_device_split(torch, served, x, rounds))
                     if n > forest_mod._host_predict_rows() else "host path, no transfer")
            print("{} | serve {} rows, {} client thread(s) x {} requests ({}): {}; {:.1f} "
                  "requests/s; in-process Forest.predict median {:.3f} ms; device predict "
                  "split: {}; batcher requests {} inline {} dispatches {} coalesced {}; "
                  "predicts host {} device {}; host traversals native {} numpy {}".format(
                      tag, n, threads, per_thread, where, _percentiles(lat), len(lat) / wall,
                      float(np.median(inproc)), split, delta["requests"], delta["inline"],
                      delta["dispatches"], delta["coalesced"], counts["host"],
                      counts["device"], routes["predict_native"], routes["predict_numpy"]),
                  flush=True)
            if counts["host"]:
                check(routes["predict_native"] == counts["host"] and not routes["predict_numpy"],
                      "host predicts {} but native traversals {}".format(counts, routes))
            if n == 100:
                check(counts["device"] > 0, "the 100-row traffic made no device predict")

        # ---- the device's share of the 100-row load, under torch.profiler
        # (device activity); its set-up takes seconds, so the clock starts
        # once it runs
        forest_mod.reset_predict_counts()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        t = time.perf_counter()
        lat, wall, errs, statuses = _child_load(
            client.base, tmp, [("/invocations", x_all[:100], ref[:100])], 16, 10)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t
        prof.stop()
        client.statuses.extend(statuses)
        check(not errs, "wrong or failed answers in the profiled load: {}".format(errs[:5]))
        events = [e for e in prof.key_averages() if _kernel_time_us(torch, e) > 0]
        busy_ms = sum(_kernel_time_us(torch, e) for e in events) / 1e3
        kernels = sum(int(e.count) for e in events)
        device = forest_mod.PREDICTS["device"]
        print("{} | serve 100 rows, 16 client threads x 10 requests (child process) under "
              "torch.profiler: {:.1f} requests/s; {} device predicts, {} kernel launches "
              "({:.0f} a predict), device busy {:.3f} ms ({:.4f} ms a predict), {:.2%} of the "
              "load's {:.3f} s".format(
                  tag, len(lat) / wall, device, kernels, kernels / max(device, 1), busy_ms,
                  busy_ms / max(device, 1), busy_ms / 1e3 / elapsed, elapsed), flush=True)

        # ---- shutdown: SIGTERM with a request in flight
        inflight = {}

        def late():
            inflight["answer"] = client.call("/invocations", bodies["text/csv"], "text/csv",
                                             "text/csv")

        req = threading.Thread(target=late)
        req.start()
        time.sleep(0.2)
        t = time.perf_counter()
        os.kill(os.getpid(), signal.SIGTERM)
        check(httpd.stopped.wait(60), "the server did not stop after SIGTERM")
        stop_s = time.perf_counter() - t
        req.join(60)
        status, out = inflight.get("answer", (None, b""))
        check(status == 200 and np.abs(_decode_scores(out, "text/csv") - ref).max() <= 1e-5,
              "the request in flight at SIGTERM lost its answer: {}".format(status))
        loop.join(10)
        check(not loop.is_alive(), "the serve loop did not end")
        refused = False
        try:
            client.call("/ping")
        except OSError:
            refused = True
        check(refused, "the listener still answers after SIGTERM")
        launches = dict(hist.LAUNCHES)
        print("{} | serve shutdown: SIGTERM -> stopped in {:.3f} s, the in-flight {}-row "
              "request answered 200 and right, listener closed; serve launches {}".format(
                  tag, stop_s, len(x_all), json.dumps(launches)), flush=True)
        fives = [s for s in client.statuses if s >= 500]
        check(not fives, "unprovoked 5xx answers: {}".format(fives))
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        if not httpd.stopped.is_set():
            httpd.stop()
        if ubj_httpd is not None:
            ubj_httpd.stop()
        os.environ.pop("SM_MODEL_DIR", None)
        lifecycle.uninstall()

    # OMP_NUM_THREADS=1 (set by the entry point) against unset, each set
    # before torch is imported, on the host path and the decode; the two
    # child processes run at the same time, so neither has the other's turn
    t = time.perf_counter()
    procs = {}
    for label, omp in (("OMP_NUM_THREADS=1", "1"), ("unset", None)):
        env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
        if omp:
            env["OMP_NUM_THREADS"] = omp
        procs[label] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--host-probe", path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for label, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        check(proc.returncode == 0, "host probe failed: {}".format(err[-2000:]))
        print("{} | serve host probe ({}, both child processes together {:.1f} s): {}".format(
            tag, label, time.perf_counter() - t, out.strip().splitlines()[-1]), flush=True)


# ---------------------------------------------------------------- phase 8

ENTRY_TRAIN_ROWS, ENTRY_VAL_ROWS, ENTRY_MISSING, ENTRY_SEED = 200_000, 50_000, 0.02, 5
ENTRY_HP = {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
            "tree_method": "hist", "eta": "0.2", "num_round": "30",
            "eval_metric": "logloss,auc", "early_stopping_rounds": "10",
            "_tuning_objective_metric": "validation:auc"}
ENTRY_SIGTERM_AFTER = 5  # the spot interruption lands after this round's line
# two GPU runs of one job are different models of the same quality: the
# histograms' shared-memory f32 atomics add in a varying order, a split whose
# gain ties within rounding goes either way, and the margins and the later
# trees then differ too; a flip near a root moves many rows. Two runs must
# agree within ENTRY_METRIC_TOL on every last-round metric and within
# ENTRY_DP_TOL on the mean predicted probability difference (the largest
# seen on an H100 at 700 W over three calls: 2.48e-3 and 6.88e-3). The CPU
# tests hold a resumed run to the uninterrupted one tree for tree.
ENTRY_METRIC_TOL, ENTRY_DP_TOL = 1e-2, 5e-2
ENTRY_COMMAND = [sys.executable, "-m", "sagemaker_xgboost_container_tpu_torch.training.entry"]
# the same entry point, printing its kernel launch counts as it exits
ENTRY_CHILD_COMMAND = [sys.executable, os.path.abspath(__file__), "--entry-child"]
HPO_LINE = re.compile(r"^\[(\d+)\]\t(.*)$")
HPO_REGEX = ".*\\[[0-9]+\\].*\tvalidation-{}:(\\S+)"  # a real tab here, #011 in CloudWatch


class _RoundTimes:
    """Callback: the wall time at the start of training, after each round
    and at the end of training."""

    def __init__(self, torch):
        self.torch = torch
        self.times = []
        self.end = None

    def before_training(self, forest):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        return forest

    def after_iteration(self, forest, rnd, evals_log):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        self.last = {"{}-{}".format(d, m): v[-1] for d, ms in evals_log.items()
                     for m, v in ms.items()}
        return False

    def after_training(self, forest):
        self.end = time.perf_counter()
        return forest


def _write_csv_channel(path, X, y):
    """A csv channel as SageMaker users write one: label first, missing
    values as empty fields."""
    os.makedirs(path)
    import io

    buf = io.StringIO()
    np.savetxt(buf, np.column_stack([y, X]), fmt="%.9g", delimiter=",")
    with open(os.path.join(path, "data.csv"), "w") as f:
        f.write(buf.getvalue().replace("nan", ""))


def _metric_lines(stdout):
    """{round: {"validation-auc": value, ...}} of the HPO metric lines."""
    out = {}
    for line in stdout.splitlines():
        m = HPO_LINE.match(line)
        if m:
            out[int(m.group(1))] = {k: float(v) for k, v in
                                    (part.split(":") for part in m.group(2).split("\t"))}
    return out


def _missing_reaches(tree, X):
    """Per node: does a training row with a missing value in the node's
    split feature reach it? Elsewhere both placements of the missing bucket
    score alike and f32 rounding picks ``default_left``."""
    out = np.zeros(tree.num_nodes, bool)
    node = np.zeros(len(X), np.int64)
    rows = np.arange(len(X))
    for _ in range(tree.depth()):
        v = X[rows, tree.feature[node]]
        missing = np.isnan(v) & ~tree.is_leaf[node]
        out[node[missing]] = True
        right = np.where(np.isnan(v), ~tree.default_left[node], v >= tree.threshold[node])
        node = np.where(tree.is_leaf[node], node,
                        np.where(right, tree.right[node], tree.left[node]))
    return out


def _same_tree(ta, tb, X):
    """Splits equal (children, feature, threshold, and ``default_left``
    where a training row with a missing value reaches) and leaf values
    within 1e-5."""
    if ta.num_nodes != tb.num_nodes or (ta.left != tb.left).any():
        return False
    split, decided = ~ta.is_leaf, _missing_reaches(ta, X)
    return bool((ta.feature[split] == tb.feature[split]).all()
                and (ta.threshold[split] == tb.threshold[split]).all()
                and (ta.default_left[decided] == tb.default_left[decided]).all()
                and np.abs(ta.value - tb.value).max() <= 1e-5)


def _compare(a, b, X, x_val):
    """Two models of one job -> the trees whose splits agree before the
    first that differs, the trees that differ, and the largest and mean
    difference of their predicted probabilities on ``x_val``."""
    same = [_same_tree(ta, tb, X) for ta, tb in zip(a.trees, b.trees)]
    leading = same.index(False) if False in same else len(same)
    dp = np.abs(a.predict(x_val) - b.predict(x_val))
    roots = sum(int(ta.feature[0] != tb.feature[0] or ta.threshold[0] != tb.threshold[0])
                for ta, tb in zip(a.trees, b.trees))
    return {"rounds": (a.num_boosted_rounds, b.num_boosted_rounds), "leading_same": leading,
            "differ": same.count(False) + abs(len(a.trees) - len(b.trees)),
            "roots_differ": roots, "max_dp": float(dp.max()), "mean_dp": float(dp.mean())}


def _run_entry_child(env, sigterm_after=None, timeout=600, command=None):
    """`python -m ...training.entry` (or `command`) in a child process ->
    (exit code, stdout, stderr, seconds); with ``sigterm_after``, SIGTERM
    once the line of that round is printed."""
    t = time.perf_counter()
    proc = subprocess.Popen(
        command or ENTRY_COMMAND, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    err = []
    drain = threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True)
    drain.start()
    out = []
    try:
        for line in proc.stdout:
            out.append(line)
            m = HPO_LINE.match(line)
            if sigterm_after is not None and m and int(m.group(1)) >= sigterm_after:
                proc.send_signal(signal.SIGTERM)
                sigterm_after = None
        proc.wait(timeout=timeout)
    finally:
        proc.kill()
        drain.join(10)
    return proc.returncode, "".join(out), "".join(err), time.perf_counter() - t


def run_entry(torch, hist, tag):
    """Phase 8: the train entry point on the card (see the module docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        _entry(torch, hist, tag, tmp)
    print("{} | entry phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _entry_tree(tmp, hyperparameters):
    """Phase 8's SageMaker tree under `tmp`: csv train and validation
    channels of ENTRY_TRAIN_ROWS and ENTRY_VAL_ROWS x N_FEATURES rows (seed
    ENTRY_SEED, ENTRY_MISSING of the values empty), the data config and one
    hyperparameters file per entry of `hyperparameters` ({file name: dict}).
    -> (X, y, data_config, train_dir, val_dir, sm_env(run, hp file) -> the
    child's environment, with a checkpoint LocalPath, model and output dirs
    of its own for `run`)."""
    X, y = make_data(ENTRY_TRAIN_ROWS + ENTRY_VAL_ROWS, N_FEATURES, seed=ENTRY_SEED)
    X[np.random.RandomState(ENTRY_SEED + 1).rand(*X.shape) < ENTRY_MISSING] = np.nan
    n = ENTRY_TRAIN_ROWS
    conf = os.path.join(tmp, "config")
    os.makedirs(conf)
    channel = {"ContentType": "csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    data_config = {"train": channel, "validation": dict(channel)}
    for name, cfg in list(hyperparameters.items()) + [("inputdataconfig.json", data_config)]:
        with open(os.path.join(conf, name), "w") as f:
            json.dump(cfg, f)
    train_dir, val_dir = os.path.join(tmp, "data", "train"), os.path.join(tmp, "data", "validation")
    _write_csv_channel(train_dir, X[:n], y[:n])
    _write_csv_channel(val_dir, X[n:], y[n:])
    # ("%.9g" gives every float32 back exactly, so X is what the reader reads)

    def sm_env(run, hp="hyperparameters.json"):
        ckpt_conf = os.path.join(conf, "checkpoint-{}.json".format(run))
        with open(ckpt_conf, "w") as f:
            json.dump({"LocalPath": os.path.join(tmp, "ckpt-" + run)}, f)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
        env.update({
            "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
            "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(conf, hp),
            "SM_INPUT_DATA_CONFIG_FILE": os.path.join(conf, "inputdataconfig.json"),
            "SM_CHECKPOINT_CONFIG_FILE": ckpt_conf,
            "SM_CHANNEL_TRAIN": train_dir, "SM_CHANNEL_VALIDATION": val_dir,
            "SM_MODEL_DIR": os.path.join(tmp, "model-" + run),
            "SM_OUTPUT_DIR": os.path.join(tmp, "output-" + run),
            "SM_OUTPUT_DATA_DIR": os.path.join(tmp, "output-" + run, "data"),
            "SM_HOSTS": '["algo-1"]', "SM_CURRENT_HOST": "algo-1"})
        return env

    return X, y, data_config, train_dir, val_dir, sm_env


def _entry(torch, hist, tag, tmp):
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.serving import serve_utils
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    # ---- the SageMaker tree: configs, channels, env
    X, y, data_config, train_dir, val_dir, sm_env = _entry_tree(tmp, {
        "hyperparameters.json": ENTRY_HP,
        "hyperparameters-spot.json": dict(ENTRY_HP, save_model_on_termination="true")})
    n = ENTRY_TRAIN_ROWS

    def failure(run):
        path = os.path.join(tmp, "output-" + run, "failure")
        return open(path).read()[-2000:] if os.path.exists(path) else None

    def checkpoints(run):
        d = os.path.join(tmp, "ckpt-" + run)
        return sorted(int(f.rsplit(".", 1)[1]) for f in os.listdir(d)
                      if re.match(r"^xgboost-checkpoint\.\d+$", f))

    # ---- 1. the entry point as SageMaker starts it, in a child process,
    # beside the spot interruption's two children (3.)
    full_child = _in_background(_run_entry_child, sm_env("full"))
    try:
        spot = _entry_spot(sm_env, checkpoints)
    finally:
        rc, out, err, child_s = full_child()
    check(rc == 0, "the train entry point exited {}: {} {}".format(rc, failure("full"), err[-2000:]))
    model_path = os.path.join(tmp, "model-full", "xgboost-model")
    check(os.path.exists(model_path), "no xgboost-model written")
    lines = _metric_lines(out)
    rounds = len(lines)
    check(rounds > 0 and sorted(lines) == list(range(rounds)),
          "metric lines are not one per round: {}".format(sorted(lines)))
    for metric in ("logloss", "auc"):
        found = re.findall(HPO_REGEX.format(metric), out)
        check(len(found) == rounds and all(np.isfinite(float(v)) for v in found),
              "{} HPO-regex lines for validation-{} over {} rounds".format(
                  len(found), metric, rounds))
    ll = [lines[r]["validation-logloss"] for r in range(min(5, rounds))]
    check(all(b < a for a, b in zip(ll, ll[1:])), "validation logloss did not fall: {}".format(ll))
    ckpts = checkpoints("full")
    check(ckpts and ckpts[-1] == rounds - 1, "checkpoints {} after {} rounds".format(ckpts, rounds))
    full = Forest.load_model(model_path, device="cpu")
    print("{} | entry (child process): exit 0 in {:.3f} s; {} rounds, {} HPO lines each for "
          "validation-logloss and validation-auc; validation logloss {:.5f} -> {:.5f}, auc "
          "{:.5f} -> {:.5f}; best_iteration {}; checkpoints {}".format(
              tag, child_s, rounds, rounds, lines[0]["validation-logloss"],
              lines[rounds - 1]["validation-logloss"], lines[0]["validation-auc"],
              lines[rounds - 1]["validation-auc"], full.attr("best_iteration"), ckpts),
          flush=True)

    # ---- 2. the same job in this process: kernel launches and time split
    # the job's stages timed from outside: the channel read by wrapping the
    # reader call, binning and upload up to the first callback, the rounds
    # by a callback, the model save after the last callback
    times = _RoundTimes(torch)
    get_callbacks = algorithm_train.get_callbacks
    read_matrices = algorithm_train.get_validated_data_matrices
    read = {}

    def with_times(**kw):
        xgb_model, iteration, callbacks = get_callbacks(**kw)
        return xgb_model, iteration, callbacks + [times]

    def timed_read(*args, **kw):
        read["start"] = time.perf_counter()
        out = read_matrices(*args, **kw)
        read["end"] = time.perf_counter()
        return out

    algorithm_train.get_callbacks = with_times
    algorithm_train.get_validated_data_matrices = timed_read
    hist.reset_launch_counts()
    try:
        t = time.perf_counter()
        algorithm_train.sagemaker_train(
            ENTRY_HP, data_config, train_dir, val_dir, os.path.join(tmp, "model-inproc"),
            ["algo-1"], "algo-1", {"LocalPath": os.path.join(tmp, "ckpt-inproc")}, device=DEVICE)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        algorithm_train.get_callbacks = get_callbacks
        algorithm_train.get_validated_data_matrices = read_matrices
    launches = dict(hist.LAUNCHES)
    inproc = Forest.load_model(os.path.join(tmp, "model-inproc", "xgboost-model"), device="cpu")
    in_rounds = len(times.times) - 1
    check(in_rounds == rounds, "in-process run took {} rounds, the child {}".format(
        in_rounds, rounds))
    check(launches == {"hist_kernel": 8 * rounds, "totals_kernel": rounds},
          "entry launches {} over {} rounds (want 8 and 1 a round)".format(launches, rounds))
    x_val = X[n:n + N_SERVE]
    cmp = _compare(inproc, full, X[:n], x_val)
    gaps = {k: abs(times.last[k] - lines[rounds - 1][k]) for k in lines[rounds - 1]}
    check(cmp["rounds"] == (rounds, rounds)
          and max(gaps.values()) <= ENTRY_METRIC_TOL and cmp["mean_dp"] <= ENTRY_DP_TOL,
          "in-process run against the child's: {}, last-round metric gaps {}".format(cmp, gaps))
    rounds_s = times.times[-1] - times.times[0]
    print("{} | entry (in process, {}): launches {} over {} rounds (8 hist_kernel and 1 "
          "totals_kernel a round); channel read {:.3f} s, binning and upload {:.3f} s, {} rounds "
          "{:.3f} s ({:.2f} rounds/s, a checkpoint saved each round), model save {:.3f} s, total "
          "{:.3f} s".format(
              tag, DEVICE, json.dumps(launches), rounds, read["end"] - read["start"],
              times.times[0] - read["end"], rounds, rounds_s, rounds / rounds_s,
              t_end - times.end, t_end - t), flush=True)
    print("{} | entry run to run (in process against the child, both {}): the first {} trees "
          "alike, {} of {} differ ({} at the root); {} rows' probabilities differ by {:.3e} at "
          "most, {:.3e} on average; last-round metric gaps {}".format(
              tag, DEVICE, cmp["leading_same"], cmp["differ"], rounds, cmp["roots_differ"],
              len(x_val), cmp["max_dp"],
              cmp["mean_dp"], json.dumps({k: float("{:.3e}".format(v)) for k, v in gaps.items()})),
          flush=True)

    # ---- 3. spot interruption: SIGTERM, then a rerun resumes from the
    # checkpoint (run above, beside 1.)
    (killed_at, intermediate, kept, spot_s, resume_s, resumed_lines, resumed,
     resumed_from) = spot
    check(intermediate.num_boosted_rounds >= ENTRY_SIGTERM_AFTER and kept,
          "intermediate model of {} rounds, checkpoints {}".format(
              intermediate.num_boosted_rounds, kept))
    check(killed_at < rounds - 1, "SIGTERM landed after the last round")
    check(min(resumed_lines) == kept[-1] + 1 and max(resumed_lines) == rounds - 1,
          "resumed rounds {}..{}, want {}..{}".format(
              min(resumed_lines), max(resumed_lines), kept[-1] + 1, rounds - 1))
    # the resumed model carries the checkpoint's trees unchanged ...
    carried = resumed_from.save_json()
    resumed_from.trees = resumed.trees[:len(resumed_from.trees)]
    check(resumed_from.save_json() == carried,
          "the resumed model changed the trees of the checkpoint it resumed from")
    # ... and ends like the uninterrupted run, within the run-to-run spread
    cmp_r = _compare(resumed, full, X[:n], x_val)
    gaps_r = {k: abs(resumed_lines[rounds - 1][k] - lines[rounds - 1][k])
              for k in lines[rounds - 1]}
    check(cmp_r["rounds"] == (rounds, rounds)
          and max(gaps_r.values()) <= ENTRY_METRIC_TOL and cmp_r["mean_dp"] <= ENTRY_DP_TOL,
          "resumed run against the uninterrupted one: {}, last-round metric gaps {} (SIGTERM "
          "after round {}, checkpoints {}, resumed at {})".format(
              cmp_r, gaps_r, killed_at, kept, min(resumed_lines)))
    print("{} | entry spot interruption: SIGTERM after round {} ({:.3f} s) left an intermediate "
          "model of {} rounds and checkpoints {}; the rerun resumed at round {} with the "
          "checkpoint's {} trees unchanged and ended at round {} in {:.3f} s; against the "
          "uninterrupted run: the first {} trees alike, {} differ ({} at the root), "
          "probabilities within {:.3e} ({:.3e} on average), last-round metric gaps {}".format(
              tag, killed_at, spot_s, intermediate.num_boosted_rounds, kept, min(resumed_lines),
              len(resumed_from.trees), max(resumed_lines), resume_s, cmp_r["leading_same"],
              cmp_r["differ"], cmp_r["roots_differ"], cmp_r["max_dp"], cmp_r["mean_dp"],
              json.dumps({k: float("{:.3e}".format(v)) for k, v in gaps_r.items()})), flush=True)

    # ---- 4. the trained model behind the serve entry point
    ref = full.predict(x_val, iteration_range=serve_utils.best_iteration_range(full))
    hist.reset_launch_counts()
    serve_ms, err = _serve_once(os.path.dirname(model_path), x_val, ref)
    print("{} | entry model served: {} validation rows as csv in {:.3f} ms, max_abs_err {:.3e} "
          "against the CPU predict; serve launches {}".format(
              tag, len(x_val), serve_ms, err, json.dumps(dict(hist.LAUNCHES))), flush=True)


def _entry_spot(sm_env, checkpoints):
    """Phase 8's spot interruption: SIGTERM to a child with
    save_model_on_termination after round ENTRY_SIGTERM_AFTER, then a rerun
    on its checkpoint dir -> (the last round printed before the SIGTERM,
    the intermediate model, the checkpoints it left, both children's wall
    s, the rerun's metric lines, its model, and the checkpoint it resumed
    from)."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    env = sm_env("spot", "hyperparameters-spot.json")
    rc, out, err, spot_s = _run_entry_child(env, sigterm_after=ENTRY_SIGTERM_AFTER)
    check(rc == 0, "SIGTERM: the entry point exited {}: {}".format(rc, err[-2000:]))
    killed_at = max(_metric_lines(out))
    spot_model = os.path.join(env["SM_MODEL_DIR"], "xgboost-model")
    check(os.path.exists(spot_model), "no intermediate model after SIGTERM")
    intermediate = Forest.load_model(spot_model, device="cpu")
    kept = checkpoints("spot")
    check(kept, "no checkpoint after SIGTERM")
    rc, out, err, resume_s = _run_entry_child(sm_env("spot", "hyperparameters-spot.json"))
    failure = os.path.join(env["SM_OUTPUT_DIR"], "failure")
    check(rc == 0, "resume: the entry point exited {}: {} {}".format(
        rc, open(failure).read()[-2000:] if os.path.exists(failure) else None, err[-2000:]))
    resumed = Forest.load_model(spot_model, device="cpu")
    resumed_from = Forest.load_model(os.path.join(os.path.dirname(env["SM_MODEL_DIR"]),
                                                  "ckpt-spot", "xgboost-checkpoint.{}".format(
                                                      kept[-1])), device="cpu")
    return (killed_at, intermediate, kept, spot_s, resume_s, _metric_lines(out), resumed,
            resumed_from)


def make_multiclass(n, d, seed):
    """bench.py's multiclass task (BENCH_TASK=multiclass, BASELINE.md config
    #3): the binary task's features, 7 classes from the quantiles of a noisy
    score."""
    X, _ = make_data(n, d, seed)
    rng = np.random.RandomState(seed)
    score = X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)
    y = np.digitize(score, np.quantile(score, np.linspace(0, 1, 8)[1:-1]))
    return X, y.astype(np.float32)


def run_multiclass(torch, hist, pkg, tag):
    """Phase 9: CoverType-shaped multi:softmax at full width on the card,
    then the GPU-vs-CPU sweep of the objectives beyond the main path."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multiclass_") as tmp:
        _multiclass(torch, hist, pkg, tag, tmp)
    run_sweep(torch, pkg, tag)
    print("{} | multiclass phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _profiled_train(torch, pkg, params, dtrain, dval, rounds, host_rounds, profile_rounds,
                    sampler=None):
    """Train on the card with the host clock over rounds 1..host_rounds
    (0-based, after round 0's warm-up) and torch.profiler (device activity)
    over the next profile_rounds rounds; should that session record no
    device activity, the round after it is profiled instead, where there is
    one. ``sampler``: train()'s ``_sampler``. -> (forest, dict: the
    validation metrics, setup s, total s, host ms a round, profiled ms a
    round, the profiled rounds, _device_rows' tuple)."""
    profile = lambda: torch.profiler.profile(  # noqa: E731
        activities=[torch.profiler.ProfilerActivity.CUDA])
    start, stop = host_rounds, host_rounds + profile_rounds
    marks, log, window = [], {}, {"prof": profile(), "rounds": profile_rounds,
                                  "label": "{}-{}".format(start + 1, stop)}

    class Window:
        def before_training(self, forest):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return forest

        def after_iteration(self, forest, rnd, evals_log):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            log.update(evals_log["validation"])
            if rnd == start:
                window["prof"].start()
            elif rnd == stop:
                window["prof"].stop()
                window["rows"] = _device_rows(torch, window["prof"], profile_rounds)
                if not window["rows"][0] and rnd + 1 < rounds:
                    print("  torch.profiler recorded no device activity in rounds {}: round "
                          "{} is profiled instead".format(window["label"], stop + 1), flush=True)
                    window.update(prof=profile(), rounds=1, label=str(stop + 1))
                    window["prof"].start()
            elif rnd == stop + 1 and window["rounds"] == 1:
                window["prof"].stop()
                window["rows"] = _device_rows(torch, window["prof"], 1)
            if rnd in (start, stop):
                # the profiler's start and stop take seconds: keep them out
                # of both windows by restarting the clock after them
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            return False

    t0 = time.perf_counter()
    forest = pkg.train(params, dtrain, rounds, evals=[(dval, "validation")], device=DEVICE,
                       callbacks=[Window()], verbose_eval=False, _sampler=sampler)
    torch.cuda.synchronize()
    p0 = start + 2
    out = {"log": log, "setup_s": marks[0] - t0, "total_s": time.perf_counter() - t0,
           "host_ms": (marks[start + 1] - marks[1]) * 1e3 / host_rounds,
           "profiled_ms": (marks[p0 + profile_rounds] - marks[p0]) * 1e3 / profile_rounds,
           "label": window["label"], "rows": window.get("rows", ([],))}
    check(out["rows"][0], "torch.profiler recorded no device activity")
    return forest, out


def _profile_line(tag, what, run, kernel_name="hist_", totals=True):
    """The profiled window's launches, device ms a round, the histogram's
    (every hist_* kernel) and the totals' (every totals_* kernel) share and
    the device's busy share of an unprofiled round."""
    rows, busy_ms, per_round, kernel_ms, kernel_calls = run["rows"]
    for r in rows[:12]:
        print("  {:9.3f} ms {:6d} calls  {}".format(r["device_ms"], r["calls"], r["name"]))
    text = ("{} | {} profile (rounds {}): {:.0f} kernel launches/round, device {:.3f} ms/round "
            "(histogram, all hist_* kernels, {:.3f} = {:.1%} in {:.0f} launches".format(
                tag, what, run["label"], per_round, busy_ms, kernel_ms("hist_"),
                kernel_ms("hist_") / busy_ms, kernel_calls("hist_")))
    if totals:
        text += "; totals, all totals_* kernels, {:.4f} = {:.1%} in {:.0f} launches".format(
            kernel_ms("totals_"), kernel_ms("totals_") / busy_ms, kernel_calls("totals_"))
    print(text + "); device busy {:.1%} of an unprofiled round".format(
        busy_ms / run["host_ms"]), flush=True)
    return busy_ms, per_round


def _multiclass(torch, hist, pkg, tag, tmp):
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    n, d, rounds = COVTYPE_TRAIN, COVTYPE_FEATURES, COVTYPE_ROUNDS
    t0 = time.perf_counter()
    X, y = make_multiclass(n, d, seed=0)
    Xv, yv = make_multiclass(COVTYPE_VAL, d, seed=1)
    data_s = time.perf_counter() - t0
    # rounds 1-4 on the host clock, rounds 5-8 under torch.profiler (and,
    # should that session record no device activity, round 9)
    hist.reset_launch_counts()
    forest, run = _profiled_train(torch, pkg, COVTYPE_PARAMS, DataMatrix(X, y),
                                  DataMatrix(Xv, yv), rounds, 4, 4)
    launches = dict(hist.LAUNCHES)
    ll, me = run["log"]["mlogloss"], run["log"]["merror"]
    print("{} | multiclass (CoverType shape: {} x {} rows, {} validation, 7 classes, "
          "depth 8, 10 rounds): data {:.3f} s, setup (binning, upload) {:.3f} s, total "
          "{:.3f} s; rounds 1-4 {:.3f} ms/round host clock = {:.3f} rounds/s; rounds {} "
          "profiled {:.3f} ms/round".format(
              tag, n, d, COVTYPE_VAL, data_s, run["setup_s"], run["total_s"], run["host_ms"],
              1e3 / run["host_ms"], run["label"], run["profiled_ms"]), flush=True)
    print("{} | multiclass validation mlogloss {}; merror {}".format(
        tag, [round(float(v), 5) for v in ll], [round(float(v), 5) for v in me]), flush=True)
    _profile_line(tag, "multiclass", run)
    print("multiclass launches: {}".format(json.dumps(launches)), flush=True)
    check(launches == {"hist_kernel": 8 * rounds, "totals_kernel": rounds},
          "multiclass launches {}, expected 8 hist_kernel and 1 totals_kernel a round".format(
              launches))
    check(len(ll) == rounds and all(np.isfinite(ll)), "validation mlogloss missing: {}".format(ll))
    check(all(b < a for a, b in zip(ll, ll[1:])), "validation mlogloss did not fall: {}".format(ll))
    check(len(forest.trees) == 7 * rounds and forest.tree_info == list(range(7)) * rounds,
          "expected 7 trees a round, one per class")

    path = os.path.join(tmp, "xgboost-model")
    forest.save_model(path)
    keep_model("covtype", path)
    on_gpu = Forest.load_model(path, device=DEVICE)
    on_cpu = Forest.load_model(path, device="cpu")
    x = Xv[:N_COVTYPE_PREDICT]
    margin, ref_margin = on_gpu.predict(x, output_margin=True), on_cpu.predict(x, output_margin=True)
    err = float(np.abs(margin - ref_margin).max())
    pred, ref = on_gpu.predict(x), on_cpu.predict(x)
    check(margin.shape == (len(x), 7) and np.all(np.isfinite(margin)), "bad multiclass margins")
    check(err <= 1e-5 and np.array_equal(pred, ref),
          "GPU predict differs from CPU predict: margins by {}".format(err))

    hist.reset_launch_counts()
    rows_in = Xv[:N_COVTYPE_SERVE]
    serve_ms, serve_err = _serve_once(tmp, rows_in, on_cpu.predict(rows_in))
    print("{} | multiclass model: {} validation rows, GPU vs CPU predict margins max_abs_err "
          "{:.3e}, classes equal; served {} rows as csv in {:.3f} ms, max_abs_err {:.3e}; "
          "serve launches {}".format(tag, len(x), err, len(rows_in), serve_ms, serve_err,
                                     json.dumps(dict(hist.LAUNCHES))), flush=True)


def sweep_labels(kind, score, rng):
    if kind == "score":
        return score
    if kind == "binary":
        return (score > 2.0).astype(np.float32)
    if kind == "count":
        return np.round(score)
    if kind == "class":
        return np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(np.float32)
    if kind == "rank":
        return relevance(score)
    return np.where(rng.rand(len(score)) < 0.2, -score, score).astype(np.float32)  # censored


def _first_split_difference(ta, tb):
    """"node: GPU feature/threshold/gain, CPU ..." at the first node whose
    split differs between two trees, or None."""
    for i in range(min(ta.num_nodes, tb.num_nodes)):
        if (ta.is_leaf[i], ta.feature[i], ta.threshold[i]) != (
                tb.is_leaf[i], tb.feature[i], tb.threshold[i]):
            return "node {}: GPU f{} < {:.6g} gain {:.7g}, CPU f{} < {:.6g} gain {:.7g}".format(
                i, ta.feature[i], ta.threshold[i], ta.gain[i], tb.feature[i], tb.threshold[i],
                tb.gain[i])
    return None if ta.num_nodes == tb.num_nodes else "node counts {} and {}".format(
        ta.num_nodes, tb.num_nodes)


def run_sweep(torch, pkg, tag):
    """Each objective beyond the main path trains 3 rounds on the GPU and on
    the CPU (plain versions of the kernels), held by `gpu_cpu_small`'s rule:
    the last-round training metric agrees within SWEEP_METRIC_TOL where the
    trees are the same and within SWEEP_SPLIT_TOL where a split differs.
    Where split gains tie within f32 rounding, the GPU's atomics may keep
    another split than the CPU, so trees are counted, not required equal,
    and the first split that differs is printed with both gains."""
    X, _ = make_data(*SWEEP_SHAPE, seed=11)
    rng = np.random.RandomState(12)
    score = np.clip(X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + np.sin(X[:, 3]) + 2.0
                    + 0.3 * rng.randn(len(X)), 0.05, None).astype(np.float32)
    same_total = trees_total = 0
    for objective, kind, extra in SWEEP:
        y = sweep_labels(kind, score, rng)
        groups = np.full(len(y) // SWEEP_GROUP, SWEEP_GROUP) if kind == "rank" else None
        params = dict({"objective": objective, "max_depth": 6, "max_bin": 64, "eta": 0.3},
                      **extra)
        _, fc, same = gpu_cpu_small(torch, pkg, params, tag,
                                    "sweep {} {}".format(objective, json.dumps(extra)),
                                    X=X, y=y, groups=groups)
        same_total += same
        trees_total += len(fc.trees)
    print("{} | sweep: {} objectives, identical trees {}/{}".format(
        tag, len(SWEEP), same_total, trees_total), flush=True)


def relevance(score):
    """bench.py's BENCH_TASK=ranking relevance: 0-4 at the 50th, 75th, 90th
    and 97th percentiles of a noisy score."""
    return np.digitize(score, np.quantile(score, [0.5, 0.75, 0.9, 0.97])).astype(np.float32)


def make_ranking(queries, d, seed):
    """BASELINE.md config #4 shaped like MSLR-WEB30K: query sizes lognormal
    with a mean of RANK_MEAN_GROUP, cut at RANK_MAX_GROUP; features and
    relevance as bench.py's BENCH_TASK=ranking. -> (X, y, query sizes)."""
    rng = np.random.RandomState(seed)
    sigma = 0.8
    sizes = np.clip(np.round(rng.lognormal(np.log(RANK_MEAN_GROUP) - sigma ** 2 / 2, sigma,
                                           queries)), 1, RANK_MAX_GROUP).astype(np.int64)
    n = int(sizes.sum())
    X = rng.randn(n, d).astype(np.float32)
    y = relevance(X[:, 0] + np.sin(X[:, 1]) + 0.5 * rng.randn(n))
    return X, y, sizes


def device_total(torch, fn, iters=5):
    """Device ms and kernel launches per call of fn, every kernel counted."""
    events = profiled_kernels(torch, fn, iters)
    check(events, "torch.profiler recorded no device activity")
    return (sum(_kernel_time_us(torch, e) for e in events) / 1e3 / iters,
            sum(e.count for e in events) / iters)


def host_syncs(torch, fn):
    """Host syncs fn makes on the card, as torch's sync debug mode counts
    them (a prototype: it sees cudaStreamSynchronize and the copies to or
    from the host that wait)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def _write_qid_channel(path, X, y, sizes):
    os.makedirs(path)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    with open(os.path.join(path, "data.libsvm"), "w") as f:
        for label, q, row in zip(y, qid, X):
            f.write("%d qid:%d " % (label, q)
                    + " ".join("%d:%.9g" % (j, v) for j, v in enumerate(row)) + "\n")


def run_ranking(torch, hist, pkg, tag):
    """Phase 10a: BASELINE.md config #4 (MSLR-WEB30K-shaped rank:ndcg) at
    full width on the card, then the train entry point over a libsvm channel
    with qid: tokens."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranking_") as tmp:
        _ranking(torch, hist, pkg, tag, tmp)
        _ranking_entry(torch, hist, tag, tmp)
    print("{} | ranking phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _ranking(torch, hist, pkg, tag, tmp):
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.ops import ranking

    d, rounds = RANK_FEATURES, RANK_ROUNDS
    t0 = time.perf_counter()
    X, y, sizes = make_ranking(RANK_QUERIES, d, seed=0)
    Xv, yv, sizes_v = make_ranking(RANK_VAL_QUERIES, d, seed=1)
    data_s = time.perf_counter() - t0
    print("{} | ranking data (MSLR-WEB30K shape): {} training queries, {} rows, query sizes "
          "mean {:.1f} max {}; {} validation queries, {} rows, mean {:.1f} max {}; {} "
          "features; data {:.3f} s".format(
              tag, len(sizes), len(y), sizes.mean(), sizes.max(), len(sizes_v), len(yv),
              sizes_v.mean(), sizes_v.max(), d, data_s), flush=True)
    hist.reset_launch_counts()
    forest, run = _profiled_train(torch, pkg, RANK_PARAMS, DataMatrix(X, y, groups=sizes),
                                  DataMatrix(Xv, yv, groups=sizes_v), rounds, 4, 4)
    launches = dict(hist.LAUNCHES)
    nd, mp = run["log"]["ndcg@10"], run["log"]["map@10"]
    print("{} | ranking (rank:ndcg, depth 8, {} rounds): setup (binning, upload, group "
          "layout) {:.3f} s, total {:.3f} s; rounds 1-4 {:.3f} ms/round host clock = {:.3f} "
          "rounds/s; rounds {} profiled {:.3f} ms/round".format(
              tag, rounds, run["setup_s"], run["total_s"], run["host_ms"], 1e3 / run["host_ms"],
              run["label"], run["profiled_ms"]), flush=True)
    print("{} | ranking validation ndcg@10 {}; map@10 {}".format(
        tag, [round(float(v), 5) for v in nd], [round(float(v), 5) for v in mp]), flush=True)
    busy_ms, _ = _profile_line(tag, "ranking", run)
    print("ranking launches: {}".format(json.dumps(launches)), flush=True)
    check(launches == {"hist_kernel": 8 * rounds, "totals_kernel": rounds},
          "ranking launches {}, expected 8 hist_kernel and 1 totals_kernel a round".format(
              launches))
    check(len(nd) == rounds and all(np.isfinite(nd)), "validation ndcg@10 missing: {}".format(nd))
    check(nd[-1] > nd[0], "validation ndcg@10 did not rise: {}".format(nd))

    # the gradient pass of a round (LambdaMART over the bucketed groups), by
    # itself, at the trained model's margins
    dev = torch.device(DEVICE)
    blocks = ranking.bucket_group_layout(sizes)
    margins = forest.predict(X, output_margin=True)
    args = [torch.as_tensor(a, device=dev) for a in (margins, y, np.ones_like(y))]
    blocks_dev = [torch.as_tensor(b, device=dev) for b in blocks]
    call = lambda: ranking.lambdarank_grad_hess(*args, blocks_dev, scheme="ndcg")  # noqa: E731
    grad_ms = time_ms(torch, call, iters=5, warmup=1)
    grad_dev_ms, grad_launches = device_total(torch, call)
    grad_syncs = host_syncs(torch, call)
    pairs = sum(b.shape[0] * b.shape[1] ** 2 for b in blocks)
    real = int((sizes.astype(np.int64) ** 2).sum())
    print("{} | ranking gradient pass: {} blocks, {} padded pairs for {} within groups ({} "
          "if every query were padded to the largest); {:.3f} ms (CUDA events), device "
          "{:.3f} ms in {:.0f} launches = {:.1%} of a round's device time; {} host "
          "syncs".format(tag, len(blocks), pairs, real, len(sizes) * int(sizes.max()) ** 2,
                         grad_ms, grad_dev_ms, grad_launches, grad_dev_ms / busy_ms,
                         grad_syncs), flush=True)
    check(grad_syncs == 0, "the ranking gradient pass waits for the device")

    # GPU against CPU gradients on a subset of the queries
    sub = int(sizes[:RANK_GRAD_QUERIES].sum())
    grads = {}
    for where in (DEVICE, "cpu"):
        a = [torch.as_tensor(v[:sub], device=where) for v in (margins, y, np.ones_like(y))]
        b = [torch.as_tensor(v, device=where)
             for v in ranking.bucket_group_layout(sizes[:RANK_GRAD_QUERIES])]
        grads[where] = [t.cpu().numpy() for t in ranking.lambdarank_grad_hess(
            *a, b, scheme="ndcg")]
    g_err = float(np.abs(grads[DEVICE][0] - grads["cpu"][0]).max())
    h_err = float(np.abs(grads[DEVICE][1] - grads["cpu"][1]).max())
    g_scale = max(1.0, float(np.abs(grads["cpu"][0]).max()))
    h_scale = max(1.0, float(np.abs(grads["cpu"][1]).max()))
    print("{} | ranking gradients, {} queries ({} rows), GPU vs CPU: grad max_abs_err {:.3e} "
          "(largest |g| {:.3e}), hess max_abs_err {:.3e} (largest |h| {:.3e})".format(
              tag, RANK_GRAD_QUERIES, sub, g_err, g_scale, h_err, h_scale), flush=True)
    check(g_err <= 1e-5 * g_scale and h_err <= 1e-5 * h_scale,
          "GPU ranking gradients differ from the CPU's")

    path = os.path.join(tmp, "xgboost-model")
    forest.save_model(path)
    keep_model("mslr", path)
    x = Xv[:N_RANK_PREDICT]
    pred = Forest.load_model(path, device=DEVICE).predict(x)
    ref = Forest.load_model(path, device="cpu").predict(x)
    err = float(np.abs(pred - ref).max())
    print("{} | ranking model: {} validation rows, GPU vs CPU predict max_abs_err {:.3e}".format(
        tag, len(x), err), flush=True)
    check(pred.shape == (len(x),) and np.all(np.isfinite(pred)), "bad ranking predictions")
    check(err <= 1e-5, "GPU predict differs from CPU predict by {}".format(err))


def _ranking_entry(torch, hist, tag, tmp):
    """sagemaker_train with rank:pairwise over libsvm channels with qid:
    tokens: one HPO line a round with validation-ndcg@5 and validation-map@10."""
    import contextlib
    import io

    from sagemaker_xgboost_container_tpu_torch.data import native
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    (q_train, q_val), d = RANK_ENTRY_QUERIES, RANK_FEATURES
    X, y, sizes = make_ranking(q_train + q_val, d, seed=7)
    n = int(sizes[:q_train].sum())
    train_dir, val_dir = os.path.join(tmp, "entry", "train"), os.path.join(tmp, "entry", "val")
    _write_qid_channel(train_dir, X[:n], y[:n], sizes[:q_train])
    _write_qid_channel(val_dir, X[n:], y[n:], sizes[q_train:])
    channel = {"ContentType": "text/libsvm", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    hist.reset_launch_counts()
    native.reset_native_routes()
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        algorithm_train.sagemaker_train(
            dict(RANK_ENTRY_HP), {"train": channel, "validation": dict(channel)}, train_dir,
            val_dir, os.path.join(tmp, "entry", "model"), ["algo-1"], "algo-1", {},
            device=DEVICE)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t
    lines = _metric_lines(out.getvalue())
    rounds = int(RANK_ENTRY_HP["num_round"])
    parses = {k: native.NATIVE_ROUTES[k] for k in ("parse_native", "parse_python")}
    print("{} | ranking entry point (rank:pairwise, libsvm with qid:, {} + {} queries, {} + "
          "{} rows): {:.3f} s, launches {}; libsvm parses by route {}; last line {}".format(
              tag, q_train, q_val, n, len(y) - n, entry_s, json.dumps(dict(hist.LAUNCHES)),
              json.dumps(parses), json.dumps(lines.get(rounds - 1))), flush=True)
    check(parses["parse_native"] > 0 and not parses["parse_python"],
          "the libsvm channels parsed by route {}".format(parses))
    check(sorted(lines) == list(range(rounds)), "metric lines for rounds {}".format(sorted(lines)))
    for metric in ("ndcg@5", "map@10"):
        for data in ("train", "validation"):
            values = [lines[r].get("{}-{}".format(data, metric)) for r in range(rounds)]
            check(all(v is not None and 0.0 <= v <= 1.0 for v in values),
                  "{}-{} lines: {}".format(data, metric, values))
        check(re.search(HPO_REGEX.format(re.escape(metric)), out.getvalue()),
              "no HPO line for validation-{}".format(metric))
    check(dict(hist.LAUNCHES) == {"hist_kernel": 6 * rounds, "totals_kernel": rounds},
          "entry launches {}".format(dict(hist.LAUNCHES)))
    check(os.path.exists(os.path.join(tmp, "entry", "model", "xgboost-model")), "no model written")


def run_lossguide(torch, hist, pkg, dtrain, dval, tag):
    """Phase 10b: bench.py's BENCH_TASK=lossguide at full width on the card:
    the main path's 1M x 28 rows, 255 leaves a tree, unbounded depth."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.ops import lossguide

    t = time.perf_counter()
    rounds, leaves = LOSSGUIDE_ROUNDS, LOSSGUIDE_PARAMS["max_leaves"]
    subtract = lossguide._subtraction_enabled(leaves, dtrain.num_col, 257)
    # the split steps never wait for the device: a tree of 64 leaves makes
    # the host syncs of a tree of 8
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(3)
    n, d = dtrain.num_row, dtrain.num_col
    bins = torch.as_tensor(rng.randint(0, 257, (n, d)).astype(np.uint16), device=dev)
    g = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    h = torch.as_tensor(rng.rand(n).astype(np.float32) + 0.1, device=dev)
    cuts = torch.full((d,), 255, dtype=torch.int32, device=dev)
    syncs = {k: host_syncs(torch, lambda: lossguide.build_tree_lossguide(
        bins, g, h, cuts, max_leaves=k, num_bins=257)) for k in (8, 64)}
    print("{} | lossguide host syncs a tree: {} ({} x {} random bins)".format(
        tag, json.dumps(syncs), n, d), flush=True)
    check(syncs[64] == syncs[8], "a lossguide split step waits for the device")
    del bins, g, h
    hist.reset_launch_counts()
    forest, run = _profiled_train(torch, pkg, LOSSGUIDE_PARAMS, dtrain, dval, rounds, 2, 2)
    launches = dict(hist.LAUNCHES)
    ll = run["log"]["logloss"]
    print("{} | lossguide (binary:logistic, max_leaves {}, max_depth 0, {} rounds, {} x {} "
          "rows): sibling subtraction {} (the rule's verdict); setup (binning, upload) {:.3f} "
          "s, total {:.3f} s; rounds 1-2 {:.3f} ms/round host clock = {:.3f} rounds/s; rounds "
          "{} profiled {:.3f} ms/round".format(
              tag, leaves, rounds, dtrain.num_row, dtrain.num_col,
              "on (the left child a step, W=1)" if subtract else "off (both children, W=2)",
              run["setup_s"], run["total_s"], run["host_ms"], 1e3 / run["host_ms"],
              run["label"], run["profiled_ms"]), flush=True)
    print("{} | lossguide validation logloss {}; leaves a tree {}".format(
        tag, [round(float(v), 5) for v in ll],
        [int(np.sum(tr.left < 0)) for tr in forest.trees]), flush=True)
    busy_ms, per_round = _profile_line(tag, "lossguide", run, totals=False)
    print("{} | lossguide: {:.0f} torch kernel launches a tree".format(tag, per_round),
          flush=True)
    print("lossguide launches: {}".format(json.dumps(launches)), flush=True)
    check(launches == {"hist_kernel": rounds * leaves, "totals_kernel": 0},
          "lossguide launches {}, expected 1 + {} hist_kernel and no totals_kernel a "
          "tree".format(launches, leaves - 1))
    check(len(ll) == rounds and all(np.isfinite(ll)), "validation logloss missing: {}".format(ll))
    check(all(b < a for a, b in zip(ll, ll[1:])), "validation logloss did not fall: {}".format(ll))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lossguide_") as tmp:
        forest.save_model(os.path.join(tmp, "xgboost-model"))
        on_gpu = Forest.load_model(os.path.join(tmp, "xgboost-model"), device=DEVICE)
        on_cpu = Forest.load_model(os.path.join(tmp, "xgboost-model"), device="cpu")
        x = dval.features[:N_SERVE]
        pred, ref = on_gpu.predict(x), on_cpu.predict(x)
        err = float(np.abs(pred - ref).max())
        check(pred.shape == (len(x),) and np.all(np.isfinite(pred)), "bad lossguide predictions")
        check(err <= 1e-5, "GPU predict differs from CPU predict by {}".format(err))
        hist.reset_launch_counts()
        rows_in = x[:N_LOSSGUIDE_SERVE]
        serve_ms, serve_err = _serve_once(tmp, rows_in, on_cpu.predict(rows_in))
    print("{} | lossguide model: {} validation rows, GPU vs CPU predict max_abs_err {:.3e}; "
          "served {} rows as csv in {:.3f} ms, max_abs_err {:.3e}; serve launches {}".format(
              tag, len(x), err, len(rows_in), serve_ms, serve_err,
              json.dumps(dict(hist.LAUNCHES))), flush=True)
    print("{} | lossguide phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


# ---------------------------------------------------------------- phase 11

# AWS's customer-churn / direct-marketing XGBoost examples (max_depth=5,
# eta=0.2, gamma=4, min_child_weight=6, subsample=0.8), on the main path's rows
CHURN_PARAMS = {"objective": "binary:logistic", "max_depth": 5, "eta": 0.2, "gamma": 4,
                "min_child_weight": 6, "subsample": 0.8, "max_bin": 256,
                "tree_method": "hist"}
SAMPLING_VARIANTS = (("churn", {}), ("+colsample_bytree", {"colsample_bytree": 0.8}),
                     ("+colsample_bylevel", {"colsample_bylevel": 0.8}),
                     ("+colsample_bynode", {"colsample_bynode": 0.8}))
SAMPLING_ROUNDS = 10
# xgboost's "Random Forests in XGBoost" recipe, one round of 100 trees
RF_PARAMS = {"objective": "binary:logistic", "num_parallel_tree": 100, "subsample": 0.8,
             "colsample_bynode": 0.8, "eta": 1.0, "max_depth": 5, "max_bin": 256,
             "tree_method": "hist"}
# k-fold CV through the entry point on phase 8's csv channels, depth 5
KFOLD_HP = {"objective": "binary:logistic", "max_depth": "5", "max_bin": "256",
            "tree_method": "hist", "eta": "0.2", "num_round": "20", "_kfold": "5",
            "_num_cv_round": "2", "eval_metric": "logloss,auc"}
KFOLD_FEVAL_HP = dict(KFOLD_HP, _num_cv_round="1", eval_metric="accuracy,f1,auc")
# the CV means of the fold-parallel and the sequential runs: other splits and
# other cuts (the whole matrix against each fold's rows), so only this close
KFOLD_MEAN_TOL = 1e-2
FOLD_SHAPE = (250_000, 28, 16, 5)  # rows, features, W, folds


class _RecordingSampler:
    """Wraps a Sampler, keeping every round's draws (to replay them on the
    CPU, and for the kept share)."""

    def __init__(self, inner):
        self.inner, self.draws = inner, {}

    def draw(self, rnd):
        self.draws[rnd] = self.inner.draw(rnd)
        return self.draws[rnd]


class _ReplaySampler:
    """Replays recorded draws on another device."""

    def __init__(self, draws, device):
        self.draws, self.device = draws, device

    def draw(self, rnd):
        from sagemaker_xgboost_container_tpu_torch.models.sampling import TreeDraw
        from sagemaker_xgboost_container_tpu_torch.ops.split import ColumnMasks

        def move(t):
            return None if t is None else t.to(self.device)

        return [TreeDraw(move(keep), None if masks is None else ColumnMasks(*map(move, masks)))
                for keep, masks in self.draws[rnd]]


def _sampler_for(params, dm):
    from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig
    from sagemaker_xgboost_container_tpu_torch.models.sampling import Sampler

    return _RecordingSampler(Sampler(TrainConfig(params), dm.num_row, dm.num_col, DEVICE))


def run_sampling(torch, hist, pkg, dtrain, dval, tag):
    """Phase 11: row and column sampling, a random forest and k-fold CV."""
    t = time.perf_counter()
    for n, d, W, C in (FOLD_SHAPE,):
        hist_case(torch, hist, n, d, W, 257, np.uint16, "random", 70 + C, True, tag,
                  classes=C, held_out=True)
        # the last level of a depth-5 tree: 32 nodes a fold
        totals_case(torch, hist, n, 2 * W, "random", 71 + C, True, tag, classes=C,
                    held_out=True)
    run_sampled_training(torch, hist, pkg, dtrain, dval, tag)
    run_sampling_replay(torch, pkg, tag)
    run_forest(torch, hist, pkg, dtrain, dval, tag)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kfold_") as tmp:
        run_kfold(torch, hist, tag, tmp)
    print("{} | sampling phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def run_sampled_training(torch, hist, pkg, dtrain, dval, tag):
    """11a: the churn example's parameters and three colsample variants on
    the main path's rows: rounds/s, launches, device ms, the mask draw's
    device time, the kept share and a falling validation logloss."""
    n = dtrain.num_row
    for name, extra in SAMPLING_VARIANTS:
        params = dict(CHURN_PARAMS, **extra)
        sampler = _sampler_for(params, dtrain)
        hist.reset_launch_counts()
        forest, run = _profiled_train(torch, pkg, params, dtrain, dval, SAMPLING_ROUNDS, 5, 3,
                                      sampler=sampler)
        launches = dict(hist.LAUNCHES)
        draw_ms, draw_launches = device_total(torch, lambda: sampler.inner.draw(0))
        kept = [float(d[0].keep.mean()) for _, d in sorted(sampler.draws.items())]
        sigma = np.sqrt(0.8 * 0.2 / n)
        ll = run["log"]["logloss"]
        print("{} | sampling {} ({}): setup {:.3f} s, total {:.3f} s; rounds 2-6 {:.3f} "
              "ms/round host clock = {:.3f} rounds/s; rounds {} profiled {:.3f} ms/round; "
              "mask draw {:.4f} ms device time in {:.0f} launches a round; kept share {} "
              "(0.8 +- 4 sigma = {:.5f})".format(
                  tag, name, json.dumps(params), run["setup_s"], run["total_s"],
                  run["host_ms"], 1e3 / run["host_ms"], run["label"], run["profiled_ms"],
                  draw_ms, draw_launches, [round(k, 5) for k in kept], 4 * sigma), flush=True)
        print("{} | sampling {} validation logloss {}".format(
            tag, name, [round(float(v), 5) for v in ll]), flush=True)
        _profile_line(tag, "sampling " + name, run)
        print("sampling {} launches: {}".format(name, json.dumps(launches)), flush=True)
        check(launches == {"hist_kernel": 5 * SAMPLING_ROUNDS, "totals_kernel": SAMPLING_ROUNDS},
              "sampling {} launches {}, expected 5 hist_kernel and 1 totals_kernel a "
              "round".format(name, launches))
        check(len(kept) == SAMPLING_ROUNDS and all(abs(k - 0.8) <= 4 * sigma for k in kept),
              "sampling {}: kept shares {}".format(name, kept))
        check(len(ll) == SAMPLING_ROUNDS and all(np.isfinite(ll)),
              "validation logloss missing: {}".format(ll))
        check(all(b < a for a, b in zip(ll, ll[1:])),
              "sampling {}: validation logloss did not fall: {}".format(name, ll))
        check(len(forest.trees) == SAMPLING_ROUNDS, "expected one tree a round")


def run_sampling_replay(torch, pkg, tag):
    """11a on SWEEP_SHAPE rows: the four parameter sets on the GPU and on the
    CPU with the GPU's draws replayed (phase 9's rule for the last-round
    metric; GPU and CPU predict of the GPU's model within 1e-5, and of the
    two models within 1e-5 where every tree is the same)."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    X, y = make_data(*SWEEP_SHAPE, seed=13)
    dm = DataMatrix(X, y)

    class Last:
        def after_iteration(self, forest, rnd, evals_log):
            self.value = evals_log["train"]["logloss"][-1]
            return False

    for name, extra in SAMPLING_VARIANTS:
        params = dict(CHURN_PARAMS, **extra)
        sampler = _sampler_for(params, dm)
        runs = {}
        for dev, smp in ((DEVICE, sampler), ("cpu", None)):
            last = Last()
            smp = smp or _ReplaySampler(sampler.draws, "cpu")
            forest = pkg.train(params, dm, 3, evals=[(dm, "train")], device=dev,
                               callbacks=[last], verbose_eval=False, _sampler=smp)
            runs[dev] = (forest, last.value)
        (fg, mg), (fc, mc) = runs[DEVICE], runs["cpu"]
        diffs = [_first_split_difference(a, b) for a, b in zip(fg.trees, fc.trees)]
        same = sum(d is None for d in diffs)
        with tempfile.TemporaryDirectory() as tmp:
            fg.save_model(os.path.join(tmp, "m"))
            fg_cpu = Forest.load_model(os.path.join(tmp, "m"), device="cpu")
        x = X[:2000]
        gpu_cpu = float(np.abs(fg.predict(x) - fg_cpu.predict(x)).max())
        runs_dp = float(np.abs(fg.predict(x) - fc.predict(x)).max())
        print("{} | sampling replay {} ({} x {}, 3 rounds): train logloss GPU {:.6f} CPU "
              "{:.6f}; identical trees {}/{} (first difference: {}); predict of the GPU's "
              "model GPU vs CPU max_abs_err {:.3e}; GPU vs CPU models {:.3e}".format(
                  tag, name, X.shape[0], X.shape[1], mg, mc, same, len(fc.trees),
                  next((d for d in diffs if d), "none"), gpu_cpu, runs_dp), flush=True)
        tol = SWEEP_METRIC_TOL if same == len(fc.trees) else SWEEP_SPLIT_TOL
        check(np.isfinite(mg) and abs(mg - mc) <= tol * max(1.0, abs(mc)),
              "sampling replay {}: GPU logloss {} against CPU {}".format(name, mg, mc))
        check(gpu_cpu <= 1e-5, "sampling replay {}: GPU predict differs from CPU predict by "
              "{}".format(name, gpu_cpu))
        check(same < len(fc.trees) or runs_dp <= 1e-5,
              "sampling replay {}: identical trees predict {} apart".format(name, runs_dp))


def run_forest(torch, hist, pkg, dtrain, dval, tag):
    """11b: one round of 100 bagged trees (the random-forest recipe) on the
    main path's rows, against a single tree of the same parameters; the
    forest saved and served once."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    results = {}
    for trees in (RF_PARAMS["num_parallel_tree"], 1):
        params = dict(RF_PARAMS, num_parallel_tree=trees)
        for attempt in range(PROFILE_ATTEMPTS):
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            marks = []

            class Window:
                def before_training(self, forest):
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                    prof.start()
                    return forest

                def after_iteration(self, forest, rnd, evals_log):
                    torch.cuda.synchronize()
                    prof.stop()
                    marks.append(time.perf_counter())
                    self.log = evals_log["validation"]["logloss"]
                    return False

            window = Window()
            hist.reset_launch_counts()
            t0 = time.perf_counter()
            forest = pkg.train(params, dtrain, 1, evals=[(dval, "validation")], device=DEVICE,
                               callbacks=[window], verbose_eval=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(hist.LAUNCHES)
            rows, busy_ms, per_round, kernel_ms, kernel_calls = _device_rows(torch, prof, 1)
            if rows:
                break
            print("  torch.profiler recorded no device activity (attempt {} of {})".format(
                attempt + 1, PROFILE_ATTEMPTS), flush=True)
        results[trees] = (forest, window.log[-1])
        print("{} | forest {} trees ({}): wall {:.3f} s (setup {:.3f} s, the round {:.3f} s "
              "profiled); launches {}; {:.0f} torch kernel launches, device {:.3f} ms "
              "(histogram {:.3f} ms in {:.0f} launches); validation logloss {:.5f}".format(
                  tag, trees, json.dumps(params), wall, marks[0] - t0, marks[1] - marks[0],
                  json.dumps(launches), per_round, busy_ms, kernel_ms("hist_"),
                  kernel_calls("hist_"), window.log[-1]), flush=True)
        check(rows, "torch.profiler recorded no device activity")
        check(launches == {"hist_kernel": 5 * trees, "totals_kernel": trees},
              "forest launches {}, expected 5 hist_kernel and 1 totals_kernel a tree".format(
                  launches))
        check(len(forest.trees) == trees and forest.iteration_indptr == [0, trees],
              "expected {} trees in one round".format(trees))
        check(np.isfinite(window.log[-1]), "forest logloss {}".format(window.log[-1]))
    rf, ll = results[RF_PARAMS["num_parallel_tree"]]
    print("{} | forest: validation logloss of 100 trees {:.5f} against one tree's {:.5f}".format(
        tag, ll, results[1][1]), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_forest_") as tmp:
        rf.save_model(os.path.join(tmp, "xgboost-model"))
        keep_model("forest", os.path.join(tmp, "xgboost-model"))
        on_cpu = Forest.load_model(os.path.join(tmp, "xgboost-model"), device="cpu")
        rows_in = dval.features[:N_LOSSGUIDE_SERVE]
        want = on_cpu.predict(rows_in)
        err = float(np.abs(rf.predict(rows_in) - want).max())
        check(err <= 1e-5, "forest: GPU predict differs from CPU predict by {}".format(err))
        serve_ms, serve_err = _serve_once(tmp, rows_in, want)
    print("{} | forest model: GPU vs CPU predict max_abs_err {:.3e}; served {} rows as csv in "
          "{:.3f} ms, max_abs_err {:.3e}".format(tag, err, len(rows_in), serve_ms, serve_err),
          flush=True)


def _cv_lines(stdout, num_round):
    """The print_cv_metric lines ("[num_round]\t...") -> list of dicts."""
    return [{k: float(v) for k, v in (p.split(":") for p in m.group(2).split("\t"))}
            for m in map(HPO_LINE.match, stdout.splitlines())
            if m and int(m.group(1)) == num_round]


def run_kfold(torch, hist, tag, tmp):
    """11c: k-fold CV through the train entry point on phase 8's channels:
    fold-parallel in this process (launch counts), then with a feval (the
    sequential path) in a child process as SageMaker starts it."""
    import contextlib
    import io

    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train

    X, y = make_data(ENTRY_TRAIN_ROWS + ENTRY_VAL_ROWS, N_FEATURES, seed=ENTRY_SEED)
    X[np.random.RandomState(ENTRY_SEED + 1).rand(*X.shape) < ENTRY_MISSING] = np.nan
    n = ENTRY_TRAIN_ROWS
    train_dir, val_dir = os.path.join(tmp, "train"), os.path.join(tmp, "validation")
    _write_csv_channel(train_dir, X[:n], y[:n])
    _write_csv_channel(val_dir, X[n:], y[n:])
    channel = {"ContentType": "csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    data_config = {"train": channel, "validation": dict(channel)}
    rounds, repeats, k = int(KFOLD_HP["num_round"]), int(KFOLD_HP["_num_cv_round"]), 5

    # (i) fold-parallel, in this process
    model_dir, out_dir = os.path.join(tmp, "model-parallel"), os.path.join(tmp, "out-parallel")
    os.environ["SM_OUTPUT_DATA_DIR"] = out_dir
    hist.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            algorithm_train.sagemaker_train(dict(KFOLD_HP), data_config, train_dir, val_dir,
                                            model_dir, ["algo-1"], "algo-1", {}, device=DEVICE)
    finally:
        os.environ.pop("SM_OUTPUT_DATA_DIR", None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hist.LAUNCHES)
    cv = _cv_lines(out.getvalue(), rounds)
    # each fold model with its manifest sidecar
    files = sorted(os.listdir(model_dir))
    models = [f for f in files if not f.endswith(".manifest")]
    check(files == sorted(models + [m + ".manifest" for m in models]),
          "kfold models without their manifests: {}".format(files))
    preds = np.loadtxt(os.path.join(out_dir, "predictions.csv"), delimiter=",")
    # the folds of both repeats ride the class axis together: C = 10
    print("{} | kfold fold-parallel (_kfold 5, _num_cv_round 2, {} rounds, {} rows): wall "
          "{:.3f} s; launches {} = {:.0f} hist_kernel and {:.0f} totals_kernel a round for all "
          "{} folds; models {}; predictions.csv {}".format(
              tag, rounds, len(X), wall, json.dumps(launches), launches["hist_kernel"] / rounds,
              launches["totals_kernel"] / rounds, k * repeats, models, preds.shape), flush=True)
    for line in cv:
        print("{} | kfold fold-parallel CV means {}".format(tag, json.dumps(line)), flush=True)
    check(launches == {"hist_kernel": 5 * rounds, "totals_kernel": rounds},
          "kfold launches {}, expected 5 hist_kernel and 1 totals_kernel a round for all "
          "folds".format(launches))
    check(models == ["xgboost-model-{}".format(i) for i in range(k * repeats)],
          "kfold models {}".format(models))
    check(preds.shape == (len(X), 3) and np.all(np.isfinite(preds)),
          "predictions.csv {}".format(preds.shape))
    check(len(cv) == repeats + 1 and all(np.isfinite(list(c.values())).all() for c in cv),
          "{} CV metric lines".format(len(cv)))

    # (ii) a feval (accuracy, f1): the sequential path, in a child process
    conf = os.path.join(tmp, "config")
    os.makedirs(conf)
    for name, cfg in (("hyperparameters.json", KFOLD_FEVAL_HP),
                      ("inputdataconfig.json", data_config)):
        with open(os.path.join(conf, name), "w") as f:
            json.dump(cfg, f)
    env = {key: v for key, v in os.environ.items() if not key.startswith(("SM_", "SAGEMAKER_"))}
    env.update({
        "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
        "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(conf, "hyperparameters.json"),
        "SM_INPUT_DATA_CONFIG_FILE": os.path.join(conf, "inputdataconfig.json"),
        "SM_CHECKPOINT_CONFIG_FILE": os.path.join(conf, "checkpointconfig.json"),
        "SM_CHANNEL_TRAIN": train_dir, "SM_CHANNEL_VALIDATION": val_dir,
        "SM_MODEL_DIR": os.path.join(tmp, "model-seq"),
        "SM_OUTPUT_DIR": os.path.join(tmp, "output-seq"),
        "SM_OUTPUT_DATA_DIR": os.path.join(tmp, "output-seq", "data"),
        "SM_HOSTS": '["algo-1"]', "SM_CURRENT_HOST": "algo-1"})
    rc, stdout, err, child_s = _run_entry_child(env)
    failure = os.path.join(tmp, "output-seq", "failure")
    check(rc == 0, "the kfold entry point exited {}: {} {}".format(
        rc, open(failure).read()[-2000:] if os.path.exists(failure) else "", err[-2000:]))
    lines = [m for m in map(HPO_LINE.match, stdout.splitlines()) if m]
    per_round = [m for m in lines if int(m.group(1)) < rounds]
    seq_cv = _cv_lines(stdout, rounds)
    keys = [p.split(":")[0] for p in per_round[0].group(2).split("\t")] if per_round else []
    print("{} | kfold sequential with a feval (_kfold 5, _num_cv_round 1, child process): exit "
          "0 in {:.3f} s; {} metric lines of {}; CV means {}".format(
              tag, child_s, len(per_round), keys, json.dumps(seq_cv)), flush=True)
    check(len(per_round) == k * rounds and all(
        "validation-accuracy:" in m.group(2) and "validation-f1:" in m.group(2)
        for m in per_round), "the sequential CV printed {} metric lines".format(len(per_round)))
    check(len(seq_cv) == 1, "{} CV metric lines".format(len(seq_cv)))
    gaps = {key: abs(cv[-1][key] - seq_cv[0][key]) for key in ("train-auc", "validation-auc")}
    print("{} | kfold CV means, fold-parallel (2 repeats) against sequential (1): gaps {}".format(
        tag, json.dumps(gaps)), flush=True)
    check(all(g <= KFOLD_MEAN_TOL for g in gaps.values()),
          "CV means differ by {}".format(gaps))
    check(sorted(os.listdir(os.path.join(tmp, "model-seq"))) == sorted(
        "xgboost-model-{}{}".format(i, m) for i in range(k) for m in ("", ".manifest")),
        "sequential kfold models")


# ---------------------------------------------------------------- phase 12
# the multi-model endpoint: the models of phases 4, 11b, 9 and 10a in this
# load order under an LRU cap of 3; `main` is invoked before `mslr` loads,
# so the fourth load evicts `forest`, the one used longest ago
MME_ORDER = ("main", "forest", "covtype", "mslr")
MME_MAX_MODELS = 3
MME_ROWS = (1, 100, 1_000)
MME_LOADS = ((1, 16, 30), (100, 16, 12))  # rows, client threads, requests each
MME_CYCLES = 20
# drills: the watchdog's stuck threshold and the wedge's length, the drain's
# in-flight requests and their stall; a deadline and the decode stall past it
MME_STUCK_S, MME_STUCK_SLEEP_S, MME_INFLIGHT, MME_DRAIN_SLEEP_S = 1.0, 4.0, 8, 3.0
MME_DEADLINE_S, MME_DEADLINE_SLEEP_S, MME_DRAIN_TIMEOUT_S = 0.5, 1.0, 2.0
SERVER_COMMAND = [sys.executable, "-m", "sagemaker_xgboost_container_tpu_torch.serving.server"]


def _http(base, path, body=None, content_type="text/csv", accept=None, method=None,
          timeout=60):
    """-> (status, headers, body) of one HTTP call."""
    headers = {"Content-Type": content_type}
    if accept:
        headers["Accept"] = accept
    req = urllib.request.Request(base + path, data=body, headers=headers,
                                 method=method or ("GET" if body is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _metrics(base):
    """GET /metrics -> {'name{labels}': value}."""
    status, _, body = _http(base, "/metrics")
    check(status == 200, "/metrics answered {}".format(status))
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _batcher_counts(base, names):
    """The /metrics batcher_{requests,inline,dispatch,coalesced_requests}_total
    of the batchers `names`, summed -> {'requests': ..., ...}."""
    scraped = _metrics(base)
    return {kind: sum(scraped.get('batcher_{}_total{{batcher="{}"}}'.format(kind, name), 0.0)
                      for name in names)
            for kind in ("requests", "inline", "dispatch", "coalesced_requests")}


def _poll(fn, done, timeout, what):
    """Call `fn` until `done(result)`; -> (result, seconds). Connection
    errors count as not done."""
    t = time.perf_counter()
    while True:
        try:
            r = fn()
            if done(r):
                return r, time.perf_counter() - t
        except OSError:
            pass
        check(time.perf_counter() - t < timeout, "timed out waiting for {}".format(what))
        time.sleep(0.05)


class _ServerChild:
    """SERVER_COMMAND in a child process with SAGEMAKER_MULTI_MODEL=true
    (unless `multi_model` is false) and `env` (the SM_* / SAGEMAKER_*
    variables of this process left out), on a port it picks; its output
    goes to <tmp>/<label>.log."""

    def __init__(self, tmp, label, env, multi_model=True):
        self.label = label
        self.log_path = os.path.join(tmp, label + ".log")
        full = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
        full.update(SAGEMAKER_BIND_TO_PORT="0", **env)
        if multi_model:
            full["SAGEMAKER_MULTI_MODEL"] = "true"
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(SERVER_COMMAND, env=full, stdout=self._log,
                                     stderr=subprocess.STDOUT,
                                     cwd=os.path.dirname(os.path.abspath(__file__)))
        self.base = None

    def log(self):
        with open(self.log_path) as f:
            return f.read()

    def wait_ready(self, timeout=240):
        t = time.perf_counter()
        while self.base is None:
            check(self.proc.poll() is None, "server {} exited {}: {}".format(
                self.label, self.proc.returncode, self.log()[-3000:]))
            m = re.search(r"Serving on port (\d+)", self.log())
            if m:
                self.base = "http://127.0.0.1:{}".format(m.group(1))
            else:
                check(time.perf_counter() - t < timeout, "server {} did not start".format(
                    self.label))
                time.sleep(0.1)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(60)
        self._log.close()


class _Utilization:
    """nvidia-smi's utilization.gpu (the share of its sample period in which
    a kernel ran on the card) sampled every 0.2 s while the block runs; the
    mean in `.mean`, the sample count in `.n`."""

    def __enter__(self):
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=utilization.gpu",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                self.samples.append(float(out.stdout.split()[0]))
            self._stop.wait(0.2)

    def __exit__(self, *exc_info):
        self._stop.set()
        self._thread.join(60)
        self.n = len(self.samples)
        self.mean = float(np.mean(self.samples)) if self.samples else float("nan")


def _load_body(name, url):
    return json.dumps({"model_name": name, "url": url}).encode()


def _invoke_ok(base, name, x, want, kind="csv", what=""):
    """POST `x` to /models/<name>/invoke; checks 200 and every answer within
    1e-5 of `want` (the CPU predict). -> (ms, max_abs_err)."""
    body, ctype = (_csv_body(x), "text/csv") if kind == "csv" else (_libsvm_body(x),
                                                                     "text/libsvm")
    t = time.perf_counter()
    status, _, out = _http(base, "/models/{}/invoke".format(name), body, ctype, "text/csv")
    ms = (time.perf_counter() - t) * 1e3
    check(status == 200, "{}: {} {} rows ({}) answered {}: {}".format(
        what, name, len(x), kind, status, out[:200]))
    got = _decode_scores(out, "text/csv")
    check(got.shape == want.shape and np.all(np.isfinite(got)),
          "{}: {} answered shape {} for {} rows".format(what, name, got.shape, len(x)))
    err = float(np.abs(got - want).max())
    check(err <= 1e-5, "{}: {} {} rows ({}) differ from the CPU predict by {}".format(
        what, name, len(x), kind, err))
    return ms, err


def run_mme(torch, hist, tag):
    """Phase 12: the multi-model endpoint and the serving planes on the card
    (see the module docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mme_") as tmp:
        _mme(torch, hist, tag, tmp)
    print("{} | mme phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _mme(torch, hist, tag, tmp):
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    check(all(name in MODELS for name in MME_ORDER),
          "phase 12 needs the models of phases 4, 9, 10a and 11b; kept: {}".format(
              sorted(MODELS)))
    rows, refs = {}, {}
    for name in MME_ORDER:
        on_cpu = Forest.load_model(os.path.join(MODELS[name], "xgboost-model"), device="cpu")
        x, _ = make_data(max(MME_ROWS), on_cpu.num_feature, seed=60 + on_cpu.num_feature)
        x[np.random.RandomState(61).rand(*x.shape) < 0.02] = np.nan
        rows[name], refs[name] = x, on_cpu.predict(x)
    hist.reset_launch_counts()
    children = []
    try:
        t = time.perf_counter()
        endpoint = _ServerChild(tmp, "mme", {"SAGEMAKER_MAX_MODELS": str(MME_MAX_MODELS),
                                             "SM_SERVING_METRICS": "true"})
        stuck = _ServerChild(tmp, "stuck-drain", {
            "SM_SERVING_METRICS": "true", "SM_PREDICT_STUCK_S": str(MME_STUCK_S),
            "SM_PREDICT_STUCK_ACTION": "shed", "SM_SHED_COOLDOWN_S": "1",
            "SM_DRAIN_TIMEOUT_S": "60",
            # the 1st batched dispatch wedges; the 3rd predict stage on stalls
            "SM_FAULT_SPEC": "batcher.dispatch:sleep:{}@1,predict.dispatch:sleep:{}@3+".format(
                MME_STUCK_SLEEP_S, MME_DRAIN_SLEEP_S)})
        wedge = _ServerChild(tmp, "deadline-wedge", {
            "SM_SERVING_METRICS": "true", "SM_REQUEST_DEADLINE_S": str(MME_DEADLINE_S),
            "SM_DRAIN_TIMEOUT_S": str(MME_DRAIN_TIMEOUT_S),
            # the 1st decode outlasts the deadline; the 3rd never returns
            "SM_FAULT_SPEC": "serving.decode:sleep:{}@1,serving.decode:sleep:600@3".format(
                MME_DEADLINE_SLEEP_S)})
        children = [endpoint, stuck, wedge]
        for child in children:
            child.wait_ready()
        print("{} | mme: 3 server child processes (SAGEMAKER_MULTI_MODEL=true) answering in "
              "{:.1f} s".format(tag, time.perf_counter() - t), flush=True)
        _mme_endpoint(endpoint, rows, refs, tag, tmp)
        _mme_stuck_and_drain(stuck, rows, refs, tag)
        _mme_deadline_and_wedge(wedge, rows, refs, tag)
    finally:
        for child in children:
            child.close()
    _mme_in_process(torch, rows, refs, tag)
    launches = dict(hist.LAUNCHES)
    print("{} | mme launches in this process: {}".format(tag, json.dumps(launches)), flush=True)


def _mme_endpoint(child, rows, refs, tag, tmp):
    from sagemaker_xgboost_container_tpu_torch.utils import integrity

    base = child.base
    statuses = []

    def call(*args, **kwargs):
        r = _http(base, *args, **kwargs)
        statuses.append(r[0])
        return r

    # ---- loads: one model carries a manifest; the fourth load evicts
    integrity.write_manifest(os.path.join(MODELS["covtype"], "xgboost-model"))
    load_ms = {}
    for name in MME_ORDER:
        if name == "mslr":
            _invoke_ok(base, "main", rows["main"][:1], refs["main"][:1], what="touch")
        t = time.perf_counter()
        status, _, out = call("/models", _load_body(name, MODELS[name]), "application/json")
        load_ms[name] = (time.perf_counter() - t) * 1e3
        check(status == 200, "POST /models {} answered {}: {}".format(name, status, out[:300]))
    listed = [m["modelName"] for m in json.loads(call("/models")[2])["models"]]
    resident = ["main", "covtype", "mslr"]
    check(sorted(listed) == sorted(resident), "GET /models lists {}".format(listed))
    evicted = call("/models/forest/invoke", _csv_body(rows["forest"][:1]))[0]
    check(evicted == 404, "the evicted forest answered {}".format(evicted))
    print("{} | mme POST /models ms: {} (covtype verified against its manifest); LRU cap {}: "
          "the fourth load evicted forest (404), GET /models lists {}".format(
              tag, json.dumps({k: round(v, 3) for k, v in load_ms.items()}), MME_MAX_MODELS,
              listed), flush=True)

    # ---- answers of each resident model, csv and libsvm
    t = time.perf_counter()
    worst = {}
    for name in resident:
        for n in MME_ROWS:
            for kind in ("csv", "libsvm"):
                _, err = _invoke_ok(base, name, rows[name][:n], refs[name][:n], kind, "invoke")
                worst[name] = max(worst.get(name, 0.0), err)
    print("{} | mme answers: {} rows x (csv, libsvm) per resident model, max_abs_err against "
          "the CPU predict {} ({:.1f} s)".format(
              tag, list(MME_ROWS), json.dumps({k: float("%.3e" % v) for k, v in worst.items()}),
              time.perf_counter() - t), flush=True)

    # ---- a tampered file fails its digest
    tampered = os.path.join(tmp, "tampered")
    os.makedirs(tampered)
    path = os.path.join(tampered, "xgboost-model")
    with open(os.path.join(MODELS["main"], "xgboost-model"), "rb") as f:
        raw = bytearray(f.read())
    with open(path, "wb") as f:
        f.write(raw)
    integrity.write_manifest(path)
    raw[len(raw) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(raw))
    status = call("/models", _load_body("tampered", tampered), "application/json")[0]
    digest_fails = _metrics(base).get('model_verify_fail_total{stage="digest"}')
    check(status == 500 and digest_fails == 1.0,
          "tampered model: POST /models {} and model_verify_fail_total digest {}".format(
              status, digest_fails))
    listed = [m["modelName"] for m in json.loads(call("/models")[2])["models"]]
    check(sorted(listed) == sorted(resident), "after the tampered load: {}".format(listed))
    print("{} | mme tampered model (one byte flipped after its manifest): POST /models 500, "
          "model_verify_fail_total{{stage=\"digest\"}} {:.0f}".format(tag, digest_fails),
          flush=True)

    # ---- closed-loop load over the 3 resident models; the 1-row load a
    # second time without the nvidia-smi poller, whose processes share the
    # host's cores with the server and the clients
    loads = [(n, threads, per_thread, True) for n, threads, per_thread in MME_LOADS]
    loads.append(MME_LOADS[0] + (False,))
    for n, threads, per_thread, polled in loads:
        targets = [("/models/{}/invoke".format(name), rows[name][:n], refs[name][:n])
                   for name in resident]
        before = _batcher_counts(base, resident)
        with _Utilization() if polled else contextlib.nullcontext() as util:
            lat, wall, errs, seen = _child_load(base, tmp, targets, threads, per_thread)
        delta = {k: v - before[k] for k, v in _batcher_counts(base, resident).items()}
        statuses.extend(seen)
        check(len(lat) == threads * per_thread and not errs,
              "{} wrong or failed answers at {} rows: {}".format(len(errs), n, errs[:5]))
        p50, p99 = np.percentile(lat, [50, 99])
        busy = ("device busy {:.1f} % (nvidia-smi utilization.gpu, mean of {} samples)".format(
            util.mean, util.n) if polled else "nvidia-smi not polled")
        print("{} | mme load, {} rows, {} client threads x {} requests over 3 resident models "
              "(child process): p50 {:.3f} ms, p99 {:.3f} ms, {:.1f} requests/s; {}; batchers' "
              "requests {:.0f} inline {:.0f} dispatches {:.0f} coalesced {:.0f} (/metrics)".format(
                  tag, n, threads, per_thread, p50, p99, len(lat) / wall, busy,
                  delta["requests"], delta["inline"], delta["dispatch"],
                  delta["coalesced_requests"]),
              flush=True)

    # ---- DELETE retires the model's batcher series
    before = [k for k in _metrics(base) if 'batcher="covtype"' in k]
    status = call("/models/covtype", method="DELETE")[0]
    after = [k for k in _metrics(base) if 'batcher="covtype"' in k]
    listed = [m["modelName"] for m in json.loads(call("/models")[2])["models"]]
    check(status == 200 and before and not after and sorted(listed) == ["main", "mslr"],
          "DELETE /models/covtype: {}, series {} -> {}, listed {}".format(
              status, len(before), len(after), listed))
    fives = [s for s in statuses if s >= 500]
    check(fives == [500], "unprovoked 5xx answers: {}".format(fives))
    child.proc.send_signal(signal.SIGTERM)
    rc = child.proc.wait(60)
    check(rc == 0, "the endpoint exited {} after SIGTERM".format(rc))
    print("{} | mme DELETE /models/covtype 200: its {} batcher lines gone from /metrics; "
          "SIGTERM -> exit 0".format(tag, len(before)), flush=True)


def _mme_stuck_and_drain(child, rows, refs, tag):
    base = child.base
    x1, x100 = rows["main"][:1], rows["main"][:100]
    status = _http(base, "/models", _load_body("main", MODELS["main"]), "application/json")[0]
    check(status == 200, "stuck drill: POST /models answered {}".format(status))

    # ---- a batched dispatch wedged past SM_PREDICT_STUCK_S
    wedged = {}
    thread = threading.Thread(target=lambda: wedged.update(
        r=_invoke_ok(base, "main", x100, refs["main"][:100], what="wedged")))
    t = time.perf_counter()
    thread.start()
    ping, _ = _poll(lambda: _http(base, "/ping"), lambda r: r[0] == 503,
                    MME_STUCK_SLEEP_S + 10, "/ping 503 while the dispatch is stuck")
    shed_s = time.perf_counter() - t
    shed = _http(base, "/models/main/invoke", _csv_body(x1))
    check("Retry-After" in ping[1] and shed[0] == 503 and "Retry-After" in shed[1],
          "while stuck: /ping {} {}, invoke {} {}".format(ping[0], ping[1], shed[0], shed[1]))
    thread.join(120)
    check("r" in wedged, "the wedged request did not answer")
    returned_s = time.perf_counter() - t
    _poll(lambda: _http(base, "/ping"), lambda r: r[0] == 200, 30, "/ping 200 after the stuck "
          "dispatch")
    recovered_s = time.perf_counter() - t
    _invoke_ok(base, "main", x1, refs["main"][:1], what="after the stuck dispatch")
    metrics = _metrics(base)
    shed_total = metrics.get('serving_shed_total{breaker="mme"}', 0.0)
    check(shed_total >= 1 and '"serving.stuck"' in child.log(),
          "stuck drill: serving_shed_total {} and no serving.stuck record".format(shed_total))
    print("{} | mme stuck dispatch ({} s wedge, SM_PREDICT_STUCK_S={}): /ping and invokes 503 "
          "+ Retry-After from {:.3f} s, the wedged request 200 at {:.3f} s, /ping 200 again "
          "at {:.3f} s, then invokes 200; serving_shed_total {:.0f}, one serving.stuck "
          "record".format(tag, MME_STUCK_SLEEP_S, MME_STUCK_S, shed_s, returned_s, recovered_s,
                          shed_total), flush=True)

    # ---- SIGTERM with MME_INFLIGHT requests in flight
    answers = [None] * MME_INFLIGHT

    def one(i):
        answers[i] = _invoke_ok(base, "main", x1, refs["main"][:1], what="in flight")

    pool = [threading.Thread(target=one, args=(i,)) for i in range(MME_INFLIGHT)]
    for th in pool:
        th.start()
    # the gauge counts the /metrics request too
    _poll(lambda: _metrics(base).get("serving_inflight", 0.0), lambda v: v >= MME_INFLIGHT + 1,
          10, "{} requests in flight".format(MME_INFLIGHT))
    t = time.perf_counter()
    child.proc.send_signal(signal.SIGTERM)
    ping, _ = _poll(lambda: _http(base, "/ping"), lambda r: r[0] == 503, MME_DRAIN_SLEEP_S,
                    "/ping 503 while draining")
    new = _http(base, "/models/main/invoke", _csv_body(x1))
    check("Retry-After" in ping[1] and new[0] == 503 and "Retry-After" in new[1],
          "while draining: /ping {}, a new invoke {}".format(ping[0], new[0]))
    for th in pool:
        th.join(60)
    check(all(a is not None for a in answers), "in-flight requests lost their answers")
    rc = child.proc.wait(60)
    exit_s = time.perf_counter() - t
    check(rc == 0, "the drained server exited {}".format(rc))
    print("{} | mme drain: SIGTERM with {} requests in flight ({} s stall each): all answered "
          "200 and right, /ping and a new invoke 503 + Retry-After meanwhile, exit 0 {:.3f} s "
          "after SIGTERM".format(tag, MME_INFLIGHT, MME_DRAIN_SLEEP_S, exit_s), flush=True)


def _mme_deadline_and_wedge(child, rows, refs, tag):
    base = child.base
    x1 = rows["main"][:1]
    status = _http(base, "/models", _load_body("main", MODELS["main"]), "application/json")[0]
    check(status == 200, "deadline drill: POST /models answered {}".format(status))
    late = _http(base, "/models/main/invoke", _csv_body(x1))
    check(late[0] == 503 and "Retry-After" in late[1],
          "a decode past SM_REQUEST_DEADLINE_S answered {}".format(late[0]))
    ms, _ = _invoke_ok(base, "main", x1, refs["main"][:1], what="within the deadline")
    expired = _metrics(base).get('serving_deadline_exceeded_total{stage="decode"}')
    check(expired == 1.0, "serving_deadline_exceeded_total decode {}".format(expired))
    print("{} | mme deadline (SM_REQUEST_DEADLINE_S={}): a {} s decode 503 + Retry-After, "
          "serving_deadline_exceeded_total{{stage=\"decode\"}} 1; the next request 200 in "
          "{:.3f} ms".format(tag, MME_DEADLINE_S, MME_DEADLINE_SLEEP_S, ms), flush=True)

    def wedged():
        try:
            _http(base, "/models/main/invoke", _csv_body(x1), timeout=120)
        except OSError:
            pass  # the server exits under it

    thread = threading.Thread(target=wedged, daemon=True)
    thread.start()
    _poll(lambda: _metrics(base).get("serving_inflight", 0.0), lambda v: v >= 2, 10,
          "the wedged request in flight")
    t = time.perf_counter()
    child.proc.send_signal(signal.SIGTERM)
    rc = child.proc.wait(60)
    exit_s = time.perf_counter() - t
    log = child.log()
    check(rc == 83 and '"serving.abort"' in log and "drain_timeout" in log,
          "a wedged drain exited {}: {}".format(rc, log[-2000:]))
    thread.join(10)
    print("{} | mme wedged drain (SM_DRAIN_TIMEOUT_S={}): exit 83 {:.3f} s after SIGTERM, one "
          "serving.abort record".format(tag, MME_DRAIN_TIMEOUT_S, exit_s), flush=True)


def _mme_in_process(torch, rows, refs, tag):
    """ModelManager in this process: each model's device memory while
    resident, then MME_CYCLES load/unload cycles of the forest against the
    baselines of torch.cuda.memory_allocated() and threading.active_count()."""
    import gc

    from sagemaker_xgboost_container_tpu_torch.serving import lifecycle, mme

    lifecycle.uninstall()
    manager = mme.ModelManager(device=DEVICE)
    gc.collect()
    torch.cuda.synchronize()
    held = {}
    for name in MME_ORDER:
        mem0 = torch.cuda.memory_allocated()
        manager.load(name, MODELS[name])
        entry = manager.get(name)
        entry.warmup.join(120)
        got = entry.batcher.predict(rows[name])
        err = float(np.abs(got - refs[name]).max())
        check(err <= 1e-5, "in-process {}: predict differs by {}".format(name, err))
        torch.cuda.synchronize()
        held[name] = torch.cuda.memory_allocated() - mem0
        manager.unload(name)
        torch.cuda.synchronize()
        check(torch.cuda.memory_allocated() == mem0,
              "unloading {} left {} bytes on the device".format(
                  name, torch.cuda.memory_allocated() - mem0))
    print("{} | mme device memory held by each resident model (torch.cuda.memory_allocated, "
          "bytes): {}".format(tag, json.dumps(held)), flush=True)

    gc.collect()
    torch.cuda.synchronize()
    mem0, count0, threads0 = (torch.cuda.memory_allocated(), threading.active_count(),
                              set(threading.enumerate()))
    t = time.perf_counter()
    for cycle in range(MME_CYCLES):
        manager.load("forest", MODELS["forest"])
        got = manager.get("forest").batcher.predict(rows["forest"][:100])
        check(float(np.abs(got - refs["forest"][:100]).max()) <= 1e-5,
              "cycle {}: forest predict differs".format(cycle))
        manager.unload("forest")
        torch.cuda.synchronize()
        mem, count = torch.cuda.memory_allocated(), threading.active_count()
        check(mem == mem0 and count == count0 and set(threading.enumerate()) <= threads0,
              "cycle {}: {} bytes ({} at the start), {} threads ({} at the start)".format(
                  cycle, mem, mem0, count, count0))
    print("{} | mme {} load/unload cycles of the 100-tree forest in {:.3f} s: device memory "
          "{} bytes and {} threads after each, as before the first".format(
              tag, MME_CYCLES, time.perf_counter() - t, mem0, count0), flush=True)


# ---------------------------------------------------------------- phase 13

# 13a: dart on the main path's rows; its normalize_type / sample_type
# variants on SWEEP_SHAPE rows, GPU against CPU
DART_PARAMS = dict(MAIN_PARAMS, booster="dart", rate_drop=0.1, one_drop=1, skip_drop=0.0,
                   sample_type="uniform", normalize_type="tree")
DART_ROUNDS = 10
DART_VARIANTS = (("normalize_type=forest", {"normalize_type": "forest"}),
                 ("sample_type=weighted", {"sample_type": "weighted"}))
# 13b: gblinear on the main path's rows
GBLINEAR_PARAMS = {"objective": "binary:logistic", "booster": "gblinear", "eta": 0.5,
                   "lambda": 1.0, "alpha": 0.01}
GBLINEAR_ROUNDS = 10
# GPU against CPU weights after 10 rounds: each coordinate step sums 1M f32
# products in another order on each device, and the sweep carries every
# step's rounding into the next feature's gradient
GBLINEAR_WEIGHT_TOL = 1e-4
# 13c: phase 4's model refreshed and pruned on its rows, 10 % of the labels
# flipped
UPDATE_PARAMS = dict(MAIN_PARAMS, process_type="update", updater="refresh,prune", gamma=1.0)
UPDATE_FLIP = 0.1
# 13d: dart and gblinear through the train entry point on phase 8's channels
BOOSTER_ENTRY_HP = {
    "dart": {"objective": "binary:logistic", "booster": "dart", "max_depth": "8",
             "max_bin": "256", "eta": "0.2", "num_round": "10", "eval_metric": "logloss,auc",
             "rate_drop": "0.1", "one_drop": "1"},
    "gblinear": {"objective": "binary:logistic", "booster": "gblinear", "eta": "0.5",
                 "lambda": "1", "alpha": "0.01", "num_round": "10",
                 "eval_metric": "logloss,auc"},
}
BOOSTER_ENTRY_ROUNDS = 10
BOOSTER_SERVE_ROWS = 1_000


class _DropLog:
    """Callback: each round's dropped set, the earlier rounds whose leaves
    the round rescaled."""

    def __init__(self):
        self.rounds = []
        self._values = []

    def after_iteration(self, forest, rnd, evals_log):
        indptr = forest.iteration_indptr
        self.rounds.append([u for u in range(len(indptr) - 2) if any(
            not np.array_equal(forest.trees[t].value, self._values[t])
            for t in range(indptr[u], indptr[u + 1]))])
        self._values = [t.value.copy() for t in forest.trees]
        self.last = {k: v[-1] for k, v in evals_log.get("train", {}).items()}
        return False


def run_boosters(torch, hist, pkg, dtrain, dval, tag):
    """Phase 13: dart, gblinear and process_type=update (see the module
    docstring)."""
    t = time.perf_counter()
    run_dart(torch, hist, pkg, dtrain, dval, tag)
    run_gblinear(torch, hist, pkg, dtrain, dval, tag)
    run_update(torch, hist, pkg, dtrain, tag)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_boosters_") as tmp:
        run_booster_entry(torch, hist, tag, tmp)
    print("{} | boosters phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _gpu_cpu_predict(path, x):
    """(GPU predict, CPU predict) of the model file at `path` on rows x."""
    from sagemaker_xgboost_container_tpu_torch.models.compat import load_model_any_format

    gpu, _ = load_model_any_format(path, device=DEVICE)
    cpu, _ = load_model_any_format(path, device="cpu")
    return gpu.predict(x), cpu.predict(x)


def run_dart(torch, hist, pkg, dtrain, dval, tag):
    """13a: dart at full width, then its variants on the GPU and the CPU."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    rounds = DART_ROUNDS
    hist.reset_launch_counts()
    forest, run = _profiled_train(torch, pkg, DART_PARAMS, dtrain, dval, rounds, 5, 3)
    launches = dict(hist.LAUNCHES)
    check(launches == {"hist_kernel": 8 * rounds, "totals_kernel": rounds},
          "dart launches {} over {} rounds (want 8 and 1 a round)".format(launches, rounds))
    ll = run["log"]["logloss"]
    check(len(ll) == rounds and all(np.isfinite(ll)) and ll[-1] < ll[0],
          "dart validation logloss {}".format(ll))
    print("{} | dart ({} x {}, depth 8, rate_drop 0.1, one_drop, {} rounds): launches {} (8 "
          "hist_kernel and 1 totals_kernel a round); setup {:.3f} s; rounds/s (rounds 2-6, host "
          "clock) {:.3f}; validation logloss {:.5f} -> {:.5f}; total {:.3f} s".format(
              tag, dtrain.num_row, dtrain.num_col, rounds, json.dumps(launches), run["setup_s"],
              1e3 / run["host_ms"], ll[0], ll[-1], run["total_s"]), flush=True)
    _profile_line(tag, "dart", run)
    x = dval.features[:N_SERVE]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xgboost-model")
        forest.save_model(path)
        gpu, cpu = _gpu_cpu_predict(path, x)
    err = float(np.abs(gpu - cpu).max())
    check(gpu.shape == (len(x),) and np.all(np.isfinite(gpu)) and err <= 1e-5,
          "dart: the saved model's GPU predict differs from the CPU by {}".format(err))
    print("{} | dart model saved and loaded: {} rows, GPU vs CPU predict max_abs_err "
          "{:.3e}".format(tag, len(x), err), flush=True)

    X, y = make_data(*SWEEP_SHAPE, seed=13)
    X[np.random.RandomState(14).rand(*X.shape) < 0.02] = np.nan
    for label, extra in DART_VARIANTS:
        # rate_drop 0.7 drops both earlier rounds in round 3, where the
        # variants' normalizations and draws part ways
        params = dict(DART_PARAMS, max_depth=6, max_bin=64, rate_drop=0.7, **extra)
        runs = {}
        for dev in (DEVICE, "cpu"):
            log = _DropLog()
            dm = DataMatrix(X, y)
            f = pkg.train(params, dm, 3, evals=[(dm, "train")], device=dev, callbacks=[log],
                          verbose_eval=False)
            runs[dev] = (f, log)
        (fg, lg), (fc, lc) = runs[DEVICE], runs["cpu"]
        same = sum(_first_split_difference(a, b) is None for a, b in zip(fg.trees, fc.trees))
        mg, mc = lg.last["logloss"], lc.last["logloss"]
        print("{} | dart {} (3 rounds, {} x {}): dropped sets GPU {} CPU {}; train logloss GPU "
              "{:.6f} CPU {:.6f}; identical trees {}/{}".format(
                  tag, label, X.shape[0], X.shape[1], lg.rounds, lc.rounds, mg, mc, same,
                  len(fc.trees)), flush=True)
        check(lg.rounds == lc.rounds and sum(map(len, lg.rounds)) > 0,
              "dart {}: dropped sets GPU {} CPU {}".format(label, lg.rounds, lc.rounds))
        tol = SWEEP_METRIC_TOL if same == len(fc.trees) else SWEEP_SPLIT_TOL
        check(abs(mg - mc) <= tol * max(1.0, abs(mc)),
              "dart {}: train logloss GPU {} CPU {}".format(label, mg, mc))


def run_gblinear(torch, hist, pkg, dtrain, dval, tag):
    """13b: gblinear at full width, GPU weights against the CPU run's."""
    rounds = GBLINEAR_ROUNDS
    hist.reset_launch_counts()
    model, run = _profiled_train(torch, pkg, GBLINEAR_PARAMS, dtrain, dval, rounds, 5, 3)
    launches = dict(hist.LAUNCHES)
    check(launches == {"hist_kernel": 0, "totals_kernel": 0},
          "gblinear launched the tree kernels: {}".format(launches))
    ll = run["log"]["logloss"]
    check(len(ll) == rounds and all(np.isfinite(ll)) and ll[-1] < ll[0],
          "gblinear validation logloss {}".format(ll))
    rows, busy_ms, per_round, _, _ = run["rows"]
    for r in rows[:8]:
        print("  {:9.3f} ms {:6d} calls  {}".format(r["device_ms"], r["calls"], r["name"]))
    print("{} | gblinear ({} x {}, {} rounds): setup {:.3f} s; rounds/s (rounds 2-6, host clock) "
          "{:.3f}; profile (rounds {}): {:.0f} kernel launches/round, device {:.3f} ms/round, "
          "device busy {:.1%} of an unprofiled round; validation logloss {:.5f} -> {:.5f}; "
          "launches {}".format(
              tag, dtrain.num_row, dtrain.num_col, rounds, run["setup_s"], 1e3 / run["host_ms"],
              run["label"], per_round, busy_ms, busy_ms / run["host_ms"], ll[0], ll[-1],
              json.dumps(launches)), flush=True)
    t = time.perf_counter()
    cpu = pkg.train(GBLINEAR_PARAMS, dtrain, rounds, device="cpu", verbose_eval=False)
    cpu_s = time.perf_counter() - t
    err_w = float(np.abs(model.weights - cpu.weights).max())
    err_b = float(np.abs(model.bias - cpu.bias).max())
    scale = max(1.0, float(np.abs(cpu.weights).max()))
    print("{} | gblinear GPU vs CPU ({} rounds, CPU run {:.3f} s): weights max_abs_err {:.3e} "
          "(largest |w| {:.4f}), bias max_abs_err {:.3e}; tolerance {} x max(1, largest "
          "|w|)".format(tag, rounds, cpu_s, err_w, float(np.abs(cpu.weights).max()), err_b,
                        GBLINEAR_WEIGHT_TOL), flush=True)
    check(max(err_w, err_b) <= GBLINEAR_WEIGHT_TOL * scale,
          "gblinear GPU weights differ from the CPU run's by {}".format(max(err_w, err_b)))
    x = dval.features[:N_SERVE]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xgboost-model")
        model.save_model(path)
        gpu, cpu_pred = _gpu_cpu_predict(path, x)
        err = float(np.abs(gpu - cpu_pred).max())
        check(err <= 1e-5, "gblinear: the saved model's GPU predict differs by {}".format(err))
        serve_ms, serve_err = _serve_once(tmp, x[:BOOSTER_SERVE_ROWS],
                                          cpu_pred[:BOOSTER_SERVE_ROWS])
    print("{} | gblinear model saved, loaded ({} rows, GPU vs CPU max_abs_err {:.3e}) and served "
          "({} csv rows in {:.3f} ms, max_abs_err {:.3e})".format(
              tag, len(x), err, BOOSTER_SERVE_ROWS, serve_ms, serve_err), flush=True)


def run_update(torch, hist, pkg, dtrain, tag):
    """13c: phase 4's model refreshed and pruned on its training rows with
    UPDATE_FLIP of the labels flipped, on the GPU and on the CPU."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    check("main" in MODELS, "phase 13c needs phase 4's model")
    path = os.path.join(MODELS["main"], "xgboost-model")
    base = Forest.load_model(path, device="cpu")
    y = dtrain.labels.copy()
    flip = np.random.RandomState(15).rand(len(y)) < UPDATE_FLIP
    y[flip] = 1.0 - y[flip]
    dm = DataMatrix(dtrain.features, y)
    runs = {}
    for dev in (DEVICE, "cpu"):
        if dev != "cpu":
            torch.cuda.synchronize()
        hist.reset_launch_counts()
        t = time.perf_counter()
        updated = pkg.train(UPDATE_PARAMS, dm, base.num_boosted_rounds, device=dev,
                            xgb_model=path, verbose_eval=False)
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[dev] = (updated, time.perf_counter() - t, dict(hist.LAUNCHES))
    (fg, gpu_s, launches), (fc, cpu_s, _) = runs[DEVICE], runs["cpu"]

    def splits(f):
        return sum(int((~t.is_leaf).sum()) for t in f.trees)

    check(launches == {"hist_kernel": 0, "totals_kernel": 0},
          "update launched the tree kernels: {}".format(launches))
    check(len(fg.trees) == len(fc.trees) == len(base.trees), "update changed the tree count")
    value_err = 0.0
    for a, b in zip(fg.trees, fc.trees):
        check(np.array_equal(a.is_leaf, b.is_leaf) and np.array_equal(a.left, b.left),
              "update: GPU and CPU trees differ in structure")
        split = ~a.is_leaf
        check(np.array_equal(a.feature[split], b.feature[split])
              and np.array_equal(a.threshold[split], b.threshold[split]),
              "update: GPU and CPU trees differ in a split")
        value_err = max(value_err, float(np.abs(a.value[a.is_leaf] - b.value[b.is_leaf]).max()))
    check(value_err <= 1e-5, "update: leaf values differ by {}".format(value_err))
    pruned = splits(base) - splits(fg)
    check(0 < pruned < splits(base), "update pruned {} of {} splits".format(pruned, splits(base)))
    print("{} | update (refresh,prune, gamma 1, {} rows, {:.0%} of labels flipped, {} trees of "
          "depth 8): {} of {} splits pruned; wall GPU {:.3f} s, CPU {:.3f} s; GPU vs CPU trees "
          "equal in feature/threshold/is_leaf, leaf values max_abs_err {:.3e}; launches "
          "{}".format(tag, dm.num_row, UPDATE_FLIP, len(fg.trees), pruned, splits(base), gpu_s,
                      cpu_s, value_err, json.dumps(launches)), flush=True)


def _serve_mme_once(torch, model_dir, rows, want, name="linear"):
    """The model in `model_dir` behind the multi-model endpoint on the card:
    POST /models, one csv invoke of `rows` checked within 1e-5 of `want`,
    DELETE. -> (device bytes while loaded, device bytes left after the
    DELETE, invoke ms): the latter is what the request thread's first
    matmul left behind (its cuBLAS workspace), not the model's."""
    from sagemaker_xgboost_container_tpu_torch.serving import lifecycle, server

    os.environ["SAGEMAKER_MULTI_MODEL"] = "true"
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    httpd = server.serving_entrypoint(port=0, block=False, device=DEVICE)
    loop = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    try:
        base = "http://127.0.0.1:{}".format(httpd.server_port)
        status = _http(base, "/models", _load_body(name, model_dir), "application/json")[0]
        check(status == 200, "MME: POST /models of {} answered {}".format(name, status))
        ms, _ = _invoke_ok(base, name, rows, want, what="MME " + name)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - mem0
        status = _http(base, "/models/" + name, method="DELETE")[0]
        check(status == 200, "MME: DELETE answered {}".format(status))
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - mem0
    finally:
        httpd.stop()
        loop.join(10)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.environ.pop("SAGEMAKER_MULTI_MODEL", None)
        lifecycle.uninstall()
    return held, left, ms


def run_booster_entry(torch, hist, tag, tmp):
    """13d: dart and gblinear through the train entry point in a child
    process, their models served, and a resume past a tampered checkpoint."""
    import contextlib
    import io

    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, checkpointing
    from sagemaker_xgboost_container_tpu_torch.utils import integrity

    X, y, data_config, train_dir, val_dir, sm_env = _entry_tree(tmp, {
        "hyperparameters-{}.json".format(k): hp for k, hp in BOOSTER_ENTRY_HP.items()})
    x_val = X[ENTRY_TRAIN_ROWS:ENTRY_TRAIN_ROWS + BOOSTER_SERVE_ROWS]
    for kind in ("dart", "gblinear"):
        rc, out, err, child_s = _run_entry_child(sm_env(kind, "hyperparameters-{}.json".format(
            kind)))
        check(rc == 0, "{}: the train entry point exited {}: {}".format(kind, rc, err[-2000:]))
        lines = _metric_lines(out)
        found = re.findall(HPO_REGEX.format("logloss"), out)
        check(sorted(lines) == list(range(BOOSTER_ENTRY_ROUNDS))
              and len(found) == BOOSTER_ENTRY_ROUNDS,
              "{}: metric lines for rounds {}, {} HPO-regex lines".format(
                  kind, sorted(lines), len(found)))
        model_dir = os.path.join(tmp, "model-" + kind)
        gpu, cpu = _gpu_cpu_predict(os.path.join(model_dir, "xgboost-model"), x_val)
        serve_ms, serve_err = _serve_once(model_dir, x_val, cpu)
        text = ("{} | entry {} (child process): exit 0 in {:.3f} s, {} metric lines, validation "
                "logloss {:.5f} -> {:.5f}; served {} csv rows in {:.3f} ms, max_abs_err "
                "{:.3e}".format(tag, kind, child_s, len(found),
                                lines[0]["validation-logloss"],
                                lines[BOOSTER_ENTRY_ROUNDS - 1]["validation-logloss"],
                                len(x_val), serve_ms, serve_err))
        if kind == "gblinear":
            held, left, mme_ms = _serve_mme_once(torch, model_dir, x_val, cpu)
            check(held - left > 0, "the MME's gblinear model held no device memory")
            text += ("; MME POST /models + invoke {:.3f} ms, device bytes while loaded {} and "
                     "after DELETE {} (the model's {})".format(mme_ms, held, left, held - left))
        print(text, flush=True)

    # the tampered-checkpoint drill: manifests beside the dart run's
    # checkpoints, one digit of the newest changed; the resume skips it
    ckpt = os.path.join(tmp, "ckpt-dart")
    kept = sorted(int(f.rsplit(".", 1)[1]) for f in os.listdir(ckpt)
                  if re.match(r"^xgboost-checkpoint\.\d+$", f))
    for i in kept:
        integrity.write_manifest(os.path.join(ckpt, "xgboost-checkpoint.{}".format(i)),
                                 iteration=i)
    newest = os.path.join(ckpt, "xgboost-checkpoint.{}".format(kept[-1]))
    with open(newest) as f:
        text = f.read()
    at = re.search(r'"split_conditions": \[-?\d\.(\d)', text).start(1)
    tampered = text[:at] + str((int(text[at]) + 1) % 10) + text[at + 1:]
    json.loads(tampered)
    with open(newest, "w") as f:
        f.write(tampered)
    picked = checkpointing.load_checkpoint(ckpt)
    check(picked == (os.path.join(ckpt, "xgboost-checkpoint.{}".format(kept[-2])), kept[-1]),
          "tampered checkpoint {}: load_checkpoint picked {}".format(kept[-1], picked))
    rounds = BOOSTER_ENTRY_ROUNDS + 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        algorithm_train.sagemaker_train(
            dict(BOOSTER_ENTRY_HP["dart"], num_round=str(rounds)), data_config, train_dir,
            val_dir, os.path.join(tmp, "model-resumed"), ["algo-1"], "algo-1",
            {"LocalPath": ckpt}, device=DEVICE)
    lines = _metric_lines(out.getvalue())
    check(sorted(lines) == list(range(kept[-1], rounds)),
          "resume past the tampered checkpoint trained rounds {}".format(sorted(lines)))
    # the rewrite replaced the stale sidecar with one of its new bytes
    check(integrity.check_model_file(newest) == "verified",
          "the rewritten checkpoint's manifest does not describe it")
    print("{} | tampered checkpoint: one digit of xgboost-checkpoint.{} changed (still valid "
          "JSON, digest no longer its manifest's): resumed from checkpoint {} and trained rounds "
          "{}-{}; the rewritten checkpoint's manifest verifies".format(
              tag, kept[-1], kept[-2], kept[-1], rounds - 1), flush=True)


# ---------------------------------------------------------------- phase 14

# 14a: the main path with constraints: +1 on feature 0 (the label rises with
# it by construction) and three interaction sets; 14b: exact on the rounded
# main-path rows; 14c: approx on the main path
CONSTRAINED_PARAMS = dict(MAIN_PARAMS, monotone_constraints=(1,),
                          interaction_constraints=[[0, 3], [1, 2], list(range(4, 28))])
CONSTRAINED_ROUNDS = 10
EXACT_PARAMS = {k: v for k, v in MAIN_PARAMS.items() if k != "max_bin"}
EXACT_PARAMS["tree_method"] = "exact"
EXACT_ROUNDS = 5
APPROX_PARAMS = dict(MAIN_PARAMS, tree_method="approx")
APPROX_ROUNDS = 10
# the JAX package's tests/test_booster.py holds the incremental validation
# logloss of an approx run to a fresh predict of its model within this
APPROX_EVAL_TOL = 5e-3
# 14d: approx with interaction sets through the train entry point
APPROX_ENTRY_HP = {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
                   "tree_method": "approx", "eta": "0.2", "num_round": "10",
                   "eval_metric": "logloss",
                   "interaction_constraints": "[[0,1],[2,3,4,5,6,7]]"}
APPROX_ENTRY_ROUNDS = 10


def _tree_paths(tree):
    """The set of features split on along each root-to-leaf path."""
    out, stack = [], [(0, frozenset())]
    while stack:
        node, used = stack.pop()
        if tree.left[node] < 0:
            out.append(used)
            continue
        used = used | {int(tree.feature[node])}
        stack += [(tree.left[node], used), (tree.right[node], used)]
    return out


def check_constraints(forest, params, what):
    """Every split on a monotone feature orders its two children's base
    weights (what the JAX code guarantees: no bounds pass down, so the
    model need not be monotone overall); every root-to-leaf path draws its
    features from one interaction set. -> (splits on monotone features,
    paths checked)."""
    mono = params.get("monotone_constraints") or ()
    sets = [set(s) for s in params.get("interaction_constraints") or ()]
    ordered = paths = 0
    for t in forest.trees:
        for i in np.flatnonzero(t.left >= 0):
            f = int(t.feature[i])
            if f < len(mono) and mono[f] != 0:
                wl, wr = t.base_weight[t.left[i]], t.base_weight[t.right[i]]
                check(wl <= wr if mono[f] > 0 else wl >= wr,
                      "{}: split {} on feature {} has children's weights {} and {}".format(
                          what, i, f, wl, wr))
                ordered += 1
        if sets:
            for p in _tree_paths(t):
                check(any(p <= s for s in sets),
                      "{}: a path draws features {} from no one set".format(what, sorted(p)))
                paths += 1
    return ordered, paths


def gpu_cpu_small(torch, pkg, params, tag, what, rounds=3, X=None, y=None, groups=None):
    """`params` on small rows (X, y and query `groups`; SWEEP_SHAPE rows of
    the binary task with 2 % missing values unless given) on the GPU and on
    the CPU: the last-round training metric within SWEEP_METRIC_TOL
    (relative to max(1, |metric|)) where every tree is the same, within
    SWEEP_SPLIT_TOL where a near-tie split differs (phase 9's rule). ->
    (GPU forest, CPU forest, identical trees)."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    if X is None:
        X, y = make_data(*SWEEP_SHAPE, seed=15)
        X[np.random.RandomState(16).rand(*X.shape) < 0.02] = np.nan

    class Last:
        def after_iteration(self, forest, rnd, evals_log):
            self.log = evals_log["train"]
            return False

    runs = {}
    for dev in (DEVICE, "cpu"):
        last = Last()
        dm = DataMatrix(X, y, groups=groups)
        forest = pkg.train(params, dm, rounds, evals=[(dm, "train")], device=dev,
                           callbacks=[last], verbose_eval=False)
        (metric, values), = last.log.items()
        runs[dev] = (forest, metric, values[-1])
    (fg, metric, mg), (fc, _, mc) = runs[DEVICE], runs["cpu"]
    diffs = [_first_split_difference(a, b) for a, b in zip(fg.trees, fc.trees)]
    same = sum(d is None for d in diffs)
    first = next(("tree {} {}".format(t, d) for t, d in enumerate(diffs) if d), "none")
    dp = float(np.abs(fg.predict(X[:2000], output_margin=True)
                      - fc.predict(X[:2000], output_margin=True)).max())
    print("{} | {} GPU vs CPU ({} x {}, {} rounds): {} GPU {:.6f} CPU {:.6f}; identical trees "
          "{}/{} (first difference: {}); margins max_abs_err {:.3e}".format(
              tag, what, X.shape[0], X.shape[1], rounds, metric, mg, mc, same, len(fc.trees),
              first, dp), flush=True)
    tol = SWEEP_METRIC_TOL if same == len(fc.trees) else SWEEP_SPLIT_TOL
    check(np.isfinite(mg) and abs(mg - mc) <= tol * max(1.0, abs(mc)),
          "{}: GPU {} {} against CPU {} ({} of {} trees alike)".format(
              what, metric, mg, mc, same, len(fc.trees)))
    return fg, fc, same


def run_methods(torch, hist, pkg, dtrain, dval, tag):
    """Phase 14: constraints and the exact and approx tree methods (see the
    module docstring)."""
    t = time.perf_counter()
    run_constrained(torch, hist, pkg, dtrain, dval, tag)
    run_exact(torch, hist, pkg, tag)
    run_approx(torch, hist, pkg, dtrain, dval, tag)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_methods_") as tmp:
        run_approx_entry(tag, tmp)
    print("{} | methods phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _falling(ll):
    return len(ll) > 1 and all(np.isfinite(ll)) and all(b < a for a, b in zip(ll, ll[1:]))


def run_constrained(torch, hist, pkg, dtrain, dval, tag):
    """14a: the main path with monotone and interaction constraints."""
    rounds = CONSTRAINED_ROUNDS
    hist.reset_launch_counts()
    forest, run = _profiled_train(torch, pkg, CONSTRAINED_PARAMS, dtrain, dval, rounds, 5, 3)
    launches = dict(hist.LAUNCHES)
    check(launches == {"hist_kernel": 8 * rounds, "totals_kernel": rounds},
          "constrained launches {} over {} rounds (want 8 and 1 a round)".format(
              launches, rounds))
    ll = run["log"]["logloss"]
    check(len(ll) == rounds and _falling(ll), "constrained validation logloss {}".format(ll))
    ordered, paths = check_constraints(forest, CONSTRAINED_PARAMS, "14a")
    check(ordered > 0, "14a: no split on the monotone feature 0")
    print("{} | constrained ({} x {}, depth 8, monotone +1 on feature 0, interaction sets "
          "[[0,3],[1,2],[4..27]], {} rounds): launches {} (8 hist_kernel and 1 totals_kernel a "
          "round); {} splits on feature 0 with children's weights in order, {} root-to-leaf "
          "paths each within one set; setup {:.3f} s; rounds/s (rounds 2-6, host clock) {:.3f}; "
          "validation logloss {:.5f} -> {:.5f}; total {:.3f} s".format(
              tag, dtrain.num_row, dtrain.num_col, rounds, json.dumps(launches), ordered, paths,
              run["setup_s"], 1e3 / run["host_ms"], ll[0], ll[-1], run["total_s"]), flush=True)
    _profile_line(tag, "constrained", run)
    small = dict(CONSTRAINED_PARAMS, max_depth=6, max_bin=64,
                 interaction_constraints=[[0, 3], [1, 2], list(range(4, 9))])
    fg, fc, _ = gpu_cpu_small(torch, pkg, small, tag, "constrained")
    check_constraints(fg, small, "14a GPU 20k")
    check_constraints(fc, small, "14a CPU 20k")


class _Widths:
    """Spy on tree_build.level_histogram: the bin widths it is called with."""

    def __init__(self):
        from sagemaker_xgboost_container_tpu_torch.ops import tree_build

        self.module, self.real, self.widths = tree_build, tree_build.level_histogram, set()

    def __enter__(self):
        def spy(bins, grad, hess, node, W, B):
            self.widths.add(B)
            return self.real(bins, grad, hess, node, W, B)

        self.module.level_histogram = spy
        return self

    def __exit__(self, *exc_info):
        self.module.level_histogram = self.real


def run_exact(torch, hist, pkg, tag):
    """14b: tree_method=exact on the rounded main-path rows."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    X, y = exact_rows()
    dtrain, dval = DataMatrix(X[:N_TRAIN], y[:N_TRAIN]), DataMatrix(X[N_TRAIN:], y[N_TRAIN:])
    rounds = EXACT_ROUNDS
    hist.reset_launch_counts()
    with _Widths() as widths:
        forest, run = _profiled_train(torch, pkg, EXACT_PARAMS, dtrain, dval, rounds, 2, 2)
    launches = dict(hist.LAUNCHES)
    check(launches == {"hist_kernel": 8 * rounds, "totals_kernel": rounds},
          "exact launches {} over {} rounds".format(launches, rounds))
    check(len(widths.widths) == 1, "exact: histogram widths {}".format(widths.widths))
    B = widths.widths.pop()
    ll = run["log"]["logloss"]
    check(len(ll) == rounds and _falling(ll), "exact validation logloss {}".format(ll))
    print("{} | exact ({} x {} rows rounded to 2^-9, depth 8, {} rounds): B={} (u16); launches "
          "{}; setup (the exact host sketch, upload) {:.3f} s; rounds/s (rounds 2-3, host clock) "
          "{:.3f}; validation logloss {:.5f} -> {:.5f}; total {:.3f} s".format(
              tag, dtrain.num_row, dtrain.num_col, rounds, B, json.dumps(launches),
              run["setup_s"], 1e3 / run["host_ms"], ll[0], ll[-1], run["total_s"]), flush=True)
    _profile_line(tag, "exact", run)
    x = dval.features[:N_SERVE]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xgboost-model")
        forest.save_model(path)
        gpu, cpu = _gpu_cpu_predict(path, x)
    err = float(np.abs(gpu - cpu).max())
    check(gpu.shape == (len(x),) and np.all(np.isfinite(gpu)) and err <= 1e-5,
          "exact: the saved model's GPU predict differs from the CPU by {}".format(err))
    print("{} | exact model saved and loaded: {} rows, GPU vs CPU predict max_abs_err "
          "{:.3e}".format(tag, len(x), err), flush=True)
    Xs, ys = make_data(*SWEEP_SHAPE, seed=17)
    Xs = (np.round(Xs / EXACT_GRID) * EXACT_GRID).astype(np.float32)
    gpu_cpu_small(torch, pkg, dict(EXACT_PARAMS, max_depth=6), tag, "exact", X=Xs, y=ys)


class _Resketches:
    """Spy on the session's approx re-sketch: its time on the card (CUDA
    events around it), the cuts it leaves, and the host sketch calls made
    inside a round (none on a CUDA session)."""

    def __init__(self, torch):
        from sagemaker_xgboost_container_tpu_torch.models import booster

        self.torch, self.booster = torch, booster
        self.real = booster._TrainingSession._resketch_bins
        self.ms, self.cuts, self.host_calls, self.device_calls = [], [], 0, 0

    def __enter__(self):
        torch, booster, spy = self.torch, self.booster, self
        real_host, real_device = booster.compute_cut_points, booster.device_cut_points

        def resketch(session):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            spy.real(session)
            end.record()
            torch.cuda.synchronize()
            spy.ms.append(start.elapsed_time(end))
            spy.cuts.append([c.copy() for c in session.cuts])

        def host(*a, **kw):
            spy.host_calls += 1
            return real_host(*a, **kw)

        def device(*a, **kw):
            spy.device_calls += 1
            return real_device(*a, **kw)

        self.restore = [(booster._TrainingSession, "_resketch_bins", self.real),
                        (booster, "compute_cut_points", real_host),
                        (booster, "device_cut_points", real_device)]
        booster._TrainingSession._resketch_bins = resketch
        booster.compute_cut_points, booster.device_cut_points = host, device
        return self

    def __exit__(self, *exc_info):
        for obj, name, value in self.restore:
            setattr(obj, name, value)


def _logloss(p, y):
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def run_approx(torch, hist, pkg, dtrain, dval, tag):
    """14c: tree_method=approx on the main path, the re-sketch on the card."""
    rounds = APPROX_ROUNDS
    hist.reset_launch_counts()
    with _Resketches(torch) as sk:
        forest, run = _profiled_train(torch, pkg, APPROX_PARAMS, dtrain, dval, rounds, 5, 3)
    launches = dict(hist.LAUNCHES)
    check(launches == {"hist_kernel": 8 * rounds, "totals_kernel": rounds},
          "approx launches {} over {} rounds".format(launches, rounds))
    check(len(sk.ms) == rounds and sk.device_calls == rounds and sk.host_calls == 0,
          "approx: {} re-sketches, {} on the device, {} host sketches in a round".format(
              len(sk.ms), sk.device_calls, sk.host_calls))
    moved = sum(int(len(a) != len(b) or not np.array_equal(a, b))
                for a, b in zip(sk.cuts[0], sk.cuts[1]))
    check(moved > 0, "approx: the cuts of rounds 1 and 2 are the same")
    ll = run["log"]["logloss"]
    check(len(ll) == rounds and _falling(ll), "approx validation logloss {}".format(ll))
    x, yv = dval.features, dval.labels
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xgboost-model")
        forest.save_model(path)
        gpu, cpu = _gpu_cpu_predict(path, x)
    fresh = _logloss(gpu, yv)
    err = float(np.abs(gpu[:N_SERVE] - cpu[:N_SERVE]).max())
    check(abs(fresh - ll[-1]) <= APPROX_EVAL_TOL,
          "approx: incremental validation logloss {} against {} from the saved model".format(
              ll[-1], fresh))
    check(err <= 1e-5, "approx: the saved model's GPU predict differs from the CPU by {}".format(
        err))
    sketch_ms = float(np.mean(sk.ms[1:]))
    print("{} | approx ({} x {}, depth 8, max_bin 256, {} rounds): launches {}; the re-sketch "
          "on the card (sort, cumulative hessians, searchsorted, re-binning of {} + {} rows; "
          "CUDA events) {:.3f} ms a round over rounds 2-{} ({:.1%} of a host-clock round), "
          "round 1 {:.3f} ms; host sketches inside a round {}; {} of {} features' cuts moved "
          "from round 1 to 2; setup {:.3f} s; rounds/s (rounds 2-6, host clock) {:.3f}; "
          "validation logloss {:.5f} -> {:.5f}, a fresh predict of the saved model {:.5f} "
          "(gap {:.2e}); GPU vs CPU predict {:.3e}; total {:.3f} s".format(
              tag, dtrain.num_row, dtrain.num_col, rounds, json.dumps(launches), dtrain.num_row,
              dval.num_row, sketch_ms, rounds, sketch_ms / run["host_ms"], sk.ms[0],
              sk.host_calls, moved, len(sk.cuts[0]), run["setup_s"], 1e3 / run["host_ms"],
              ll[0], ll[-1], fresh, abs(fresh - ll[-1]), err, run["total_s"]), flush=True)
    _profile_line(tag, "approx", run)

    old = os.environ.get("GRAFT_SKETCH_IMPL")
    os.environ["GRAFT_SKETCH_IMPL"] = "device"
    try:
        gpu_cpu_small(torch, pkg, dict(APPROX_PARAMS, max_depth=6, max_bin=64), tag,
                      "approx (GRAFT_SKETCH_IMPL=device on both)")
    finally:
        if old is None:
            os.environ.pop("GRAFT_SKETCH_IMPL")
        else:
            os.environ["GRAFT_SKETCH_IMPL"] = old
    # dart + approx: the re-sketch before each round's dropout draw
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    X, y = make_data(*SWEEP_SHAPE, seed=18)
    params = dict(DART_PARAMS, tree_method="approx", max_depth=6, max_bin=64, rate_drop=0.7)
    drops = {}
    for dev in (DEVICE, "cpu"):
        log = _DropLog()
        dm = DataMatrix(X, y)
        pkg.train(params, dm, 3, evals=[(dm, "train")], device=dev, callbacks=[log],
                  verbose_eval=False)
        drops[dev] = log
    print("{} | dart + approx (3 rounds, {} x {}): dropped sets GPU {} CPU {}; train logloss "
          "GPU {:.6f} CPU {:.6f}".format(tag, X.shape[0], X.shape[1], drops[DEVICE].rounds,
                                         drops["cpu"].rounds, drops[DEVICE].last["logloss"],
                                         drops["cpu"].last["logloss"]), flush=True)
    check(drops[DEVICE].rounds == drops["cpu"].rounds
          and sum(map(len, drops[DEVICE].rounds)) > 0,
          "dart + approx: dropped sets GPU {} CPU {}".format(drops[DEVICE].rounds,
                                                             drops["cpu"].rounds))
    mg, mc = drops[DEVICE].last["logloss"], drops["cpu"].last["logloss"]
    check(abs(mg - mc) <= SWEEP_SPLIT_TOL * max(1.0, abs(mc)),
          "dart + approx: train logloss GPU {} CPU {}".format(mg, mc))


def run_approx_entry(tag, tmp):
    """14d: approx with interaction sets through the train entry point in a
    child process on phase 8's channels, the model served."""
    X, y, data_config, train_dir, val_dir, sm_env = _entry_tree(tmp, {
        "hyperparameters-approx.json": APPROX_ENTRY_HP})
    rc, out, err, child_s = _run_entry_child(sm_env("approx", "hyperparameters-approx.json"))
    check(rc == 0, "approx entry: exited {}: {}".format(rc, err[-2000:]))
    lines = _metric_lines(out)
    found = re.findall(HPO_REGEX.format("logloss"), out)
    check(sorted(lines) == list(range(APPROX_ENTRY_ROUNDS))
          and len(found) == APPROX_ENTRY_ROUNDS,
          "approx entry: metric lines for rounds {}, {} HPO-regex lines".format(
              sorted(lines), len(found)))
    model_dir = os.path.join(tmp, "model-approx")
    path = os.path.join(model_dir, "xgboost-model")
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    model = Forest.load_model(path, device="cpu")
    sets = json.loads(APPROX_ENTRY_HP["interaction_constraints"])
    _, paths = check_constraints(model, {"interaction_constraints": sets}, "14d")
    x_val = X[ENTRY_TRAIN_ROWS:ENTRY_TRAIN_ROWS + BOOSTER_SERVE_ROWS]
    gpu, cpu = _gpu_cpu_predict(path, x_val)
    serve_ms, serve_err = _serve_once(model_dir, x_val, cpu)
    print("{} | approx entry (child process, interaction_constraints {}): exit 0 in {:.3f} s, "
          "{} HPO lines, validation logloss {:.5f} -> {:.5f}; {} paths each within one set; "
          "served {} csv rows in {:.3f} ms, max_abs_err {:.3e}".format(
              tag, APPROX_ENTRY_HP["interaction_constraints"], child_s, len(found),
              lines[0]["validation-logloss"],
              lines[APPROX_ENTRY_ROUNDS - 1]["validation-logloss"], paths, len(x_val),
              serve_ms, serve_err), flush=True)


# ---------------------------------------------------------------- phase 15

# 15a: phase 11b's forest with features 0-7 of the validation rows coded to
# categories 0..999 (CAT_CODES quantile buckets); then a seeded CAT_FLIP of
# each set's membership flipped and CAT_INVALID of the coded cells invalid
CAT_FEATURES, CAT_CODES, CAT_FLIP, CAT_INVALID = 8, 1_000, 0.10, 0.01
CAT_INVALID_VALUES = np.asarray([-1.0, 1e10, np.inf, np.nan], np.float32)
CAT_HOST_ROWS = 32  # the numpy host path's share of a request
# 15d: the user script's estimator on phase 8's channels; the parquet job
SCRIPT_ROUNDS = 10
SCRIPT_HP = {"n_estimators": str(SCRIPT_ROUNDS), "max_depth": "8", "max_bin": "256",
             "eta": "0.2", "sagemaker_program": "train.py"}
PARQUET_HP = {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
              "tree_method": "hist", "eta": "0.2", "num_round": "10", "eval_metric": "logloss"}
PARQUET_ROUNDS = 10
# a customer's script-mode training script: the port's sklearn estimator on
# the card, its importances and its model written to SM_MODEL_DIR, and the
# kernel launch counts of its fit printed for this script to read
USER_SCRIPT = """
import argparse, json, os
from sagemaker_xgboost_container_tpu_torch.data.readers import get_data_matrix
from sagemaker_xgboost_container_tpu_torch.ops import histogram
from sagemaker_xgboost_container_tpu_torch.sklearn import TorchXGBRegressor

parser = argparse.ArgumentParser()
parser.add_argument("--n_estimators", type=int)
parser.add_argument("--max_depth", type=int)
parser.add_argument("--max_bin", type=int)
parser.add_argument("--eta", type=float)
args = parser.parse_args()
train = get_data_matrix(os.environ["SM_CHANNEL_TRAIN"], "text/csv")
histogram.reset_launch_counts()
model = TorchXGBRegressor(n_estimators=args.n_estimators, max_depth=args.max_depth,
                          max_bin=args.max_bin, eta=args.eta)
model.fit(train.features, train.labels)
print("script launches " + json.dumps(histogram.LAUNCHES), flush=True)
model_dir = os.environ["SM_MODEL_DIR"]
os.makedirs(model_dir, exist_ok=True)
with open(os.path.join(model_dir, "feature_importance.json"), "w") as f:
    json.dump(model.feature_importances_.tolist(), f)
model.save_model(os.path.join(model_dir, "xgboost-model"))
"""


def legacy_binary(forest, binf=True, num_output_group=None, attributes=None,
                  booster_name="gbtree"):
    """xgboost's legacy binary model of `forest`, by the published C
    structs: LearnerModelParam (136 bytes), the objective and booster names,
    GBTreeModelParam (160 bytes), then a tree at a time TreeParam (148
    bytes), Node (20 bytes: parent with the is-left-child bit, children,
    feature with the default-left bit, threshold or leaf value) x n and
    RTreeNodeStat (16 bytes) x n; then the int32 tree_info libxgboost writes
    after the trees. `attributes` sets contain_extra_attrs and writes them
    right after the trees instead, where the parsers read them."""
    import struct

    groups = forest.num_output_group if num_output_group is None else num_output_group
    out = [b"binf"] if binf else []
    out.append(struct.pack("<fIiii", forest.base_score, forest.num_feature, forest.num_class,
                           1 if attributes else 0, 0) + b"\0" * 116)
    for name in (forest.objective_name, booster_name):
        out.append(struct.pack("<Q", len(name)) + name.encode())
    out.append(struct.pack("<iiiiqii", len(forest.trees), 1, forest.num_feature, 0, 0, groups, 0)
               + b"\0" * 128)
    for tree in forest.trees:
        n = tree.num_nodes
        out.append(struct.pack("<iiiiii", 1, n, 0, tree.depth(), forest.num_feature, 0)
                   + b"\0" * 124)
        leaf = tree.left < 0
        is_left = np.zeros(n, np.int64)
        is_left[tree.left[~leaf]] = 1
        parent = np.where(np.arange(n) == 0, -1, tree.parent.astype(np.int64) | (is_left << 31))
        node = np.zeros(n, [("parent", "<u4"), ("left", "<i4"), ("right", "<i4"),
                            ("sindex", "<u4"), ("info", "<f4")])
        node["parent"] = parent & 0xFFFFFFFF
        node["left"], node["right"] = tree.left, tree.right
        node["sindex"] = np.where(leaf, 0, tree.feature.astype(np.int64)
                                  | (tree.default_left.astype(np.int64) << 31))
        node["info"] = np.where(leaf, tree.value, tree.threshold)
        stat = np.stack([tree.gain, tree.sum_hess, tree.base_weight, np.zeros(n, np.float32)],
                        axis=1).astype("<f4")
        out += [node.tobytes(), stat.tobytes()]
    if attributes:
        out.append(struct.pack("<Q", len(attributes)))
        for key, value in attributes.items():
            out.append(struct.pack("<Q", len(key)) + key.encode()
                       + struct.pack("<Q", len(value)) + value.encode())
    else:
        out.append(np.asarray(forest.tree_info, "<i4").tobytes())
    return b"".join(out)


def config_offset(legacy, objective):
    """A pickled Booster's handle of xgboost 1.0-1.3: "CONFIG-offset:", the
    legacy bytes' length (u64), the legacy bytes, a JSON config naming the
    objective."""
    import struct

    trailer = json.dumps({"learner": {"objective": {"name": objective}}}).encode()
    return b"CONFIG-offset:" + struct.pack("<Q", len(legacy)) + legacy + trailer


def pickled_booster(handle, **state):
    """The pickle of an `xgboost.core.Booster` whose state is {"handle":
    bytearray(handle), **state}, assembled from opcodes (no xgboost here):
    GLOBAL xgboost.core Booster, EMPTY_TUPLE, NEWOBJ, the state dict,
    BUILD, STOP."""
    import pickle

    body = pickle.dumps(dict(state, handle=bytearray(handle)), protocol=2)
    return b"\x80\x02cxgboost.core\nBooster\n)\x81" + body[2:-1] + b"b."


def run_formats(torch, hist, dval, tag):
    """Phase 15: BYO model formats and the rest of the train contract (see
    the module docstring). Needs MODELS "main", "covtype" and "forest"."""
    t = time.perf_counter()
    check(all(k in MODELS for k in ("main", "covtype", "forest")),
          "phase 15 needs the models of phases 4, 9 and 11b; kept: {}".format(sorted(MODELS)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_formats_") as tmp:
        run_categorical(torch, hist, dval, tag, tmp)
        run_model_files(torch, dval, tag, tmp)
        run_importance(tag)
        run_script_mode(tag, tmp)
    print("{} | formats phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def run_categorical(torch, hist, dval, tag, tmp):
    """15a: F_num / F_cat on the coded validation rows, then flipped sets and
    invalid values, card against CPU; F_cat behind the MME."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.ops.predict import (forest_predict_margin,
                                                                   host_leaf_nodes)
    from sagemaker_xgboost_container_tpu_torch.utils import integrity

    x = dval.features
    edges = [np.quantile(x[:, j], np.arange(1, CAT_CODES) / CAT_CODES)
             for j in range(CAT_FEATURES)]
    codes = x.copy()
    for j in range(CAT_FEATURES):
        codes[:, j] = np.searchsorted(edges[j], x[:, j], side="right")
    path = os.path.join(MODELS["forest"], "xgboost-model")
    f_num = Forest.load_model(path, device=DEVICE)
    f_cat = Forest.load_model(path, device=DEVICE)
    n_cat = 0
    for tn, tc in zip(f_num.trees, f_cat.trees):
        for node in np.nonzero((tn.left >= 0) & (tn.feature < CAT_FEATURES))[0]:
            k = int(np.searchsorted(edges[int(tn.feature[node])], tn.threshold[node],
                                    side="right"))
            tn.threshold[node] = tc.threshold[node] = k - 0.5
            tc.categories[int(node)] = np.arange(k, CAT_CODES)
            n_cat += 1
    check(n_cat > 0, "15a: the forest has no split on features 0-{}".format(CAT_FEATURES - 1))
    hist.reset_launch_counts()
    p_num = f_num.predict(codes, output_margin=True)
    p_cat = f_cat.predict(codes, output_margin=True)
    same_leaf = np.array_equal(f_num.predict_leaf(codes), f_cat.predict_leaf(codes))
    check(np.array_equal(p_num, p_cat) and same_leaf,
          "15a: F_cat differs from F_num on the coded rows (max |d| {:.3e}, leaves "
          "equal {})".format(float(np.abs(p_num - p_cat).max()), same_leaf))
    xc = torch.as_tensor(codes, device=DEVICE)
    stacks = {"F_num": f_num._stack()[1], "F_cat": f_cat._stack()[1]}
    timing = {}
    for name, dev in stacks.items():
        fn = lambda dev=dev: forest_predict_margin(dev, xc)  # noqa: E731
        timing[name] = (time_ms(torch, fn), *device_total(torch, fn))
    mask = stacks["F_cat"]["cat_mask"]
    mask_bytes = mask.numel() * mask.element_size()
    print("{} | 15a categorical: {} splits of {} trees on features 0-{} coded to {} categories; "
          "F_cat == F_num exactly on {} rows (margins and pred_leaf); mask [T, N, W] {} = {} "
          "bytes; {}-row predict: F_num {:.3f} ms (device {:.3f} ms, {:.0f} launches), "
          "F_cat {:.3f} ms (device {:.3f} ms, {:.0f} launches) (CUDA events, 20 calls); "
          "hist/totals launches {}".format(
              tag, n_cat, len(f_cat.trees), CAT_FEATURES - 1, CAT_CODES, len(codes),
              list(mask.shape), mask_bytes, len(codes), *timing["F_num"], *timing["F_cat"],
              json.dumps(hist.LAUNCHES)), flush=True)

    rng = np.random.RandomState(15)
    for tree in f_cat.trees:
        for node, cats in tree.categories.items():
            member = np.zeros(CAT_CODES, bool)
            member[cats] = True
            tree.categories[node] = np.nonzero(member ^ (rng.rand(CAT_CODES) < CAT_FLIP))[0]
    bad = codes.copy()
    cells = bad[:, :CAT_FEATURES]
    invalid = rng.rand(*cells.shape) < CAT_INVALID
    cells[invalid] = rng.choice(CAT_INVALID_VALUES, int(invalid.sum()))
    cat_dir = os.path.join(tmp, "categorical")
    os.makedirs(cat_dir)
    cat_path = os.path.join(cat_dir, "xgboost-model")
    f_cat.save_model(cat_path)
    gpu = Forest.load_model(cat_path, device=DEVICE)
    cpu = Forest.load_model(cat_path, device="cpu")
    pg, pc = gpu.predict(bad, output_margin=True), cpu.predict(bad, output_margin=True)
    err = float(np.abs(pg - pc).max())
    leaf = gpu.predict_leaf(bad)
    check(np.all(np.isfinite(pg)) and err <= 1e-5,
          "15a: card vs CPU categorical predict max_abs_err {}".format(err))
    check(np.array_equal(leaf, cpu.predict_leaf(bad)), "15a: pred_leaf differs card vs CPU")
    host = host_leaf_nodes(cpu._stack()[0], bad[:CAT_HOST_ROWS])
    host_err = float(np.abs(gpu.predict(bad[:CAT_HOST_ROWS], output_margin=True)
                            - pg[:CAT_HOST_ROWS]).max())
    check(np.array_equal(host, leaf[:CAT_HOST_ROWS]) and host_err <= 1e-5,
          "15a: the numpy host path disagrees on the first {} rows (err {})".format(
              CAT_HOST_ROWS, host_err))
    integrity.write_manifest(cat_path)
    check(integrity.check_model_file(cat_path) == "verified", "15a: manifest does not verify")
    want = cpu.predict(bad[:1_000])
    held, _left, mme_ms = _serve_mme_once(torch, cat_dir, bad[:1_000], want, name="categorical")
    print("{} | 15a flipped {:.0%} of each set, {:.0%} of the coded cells in {}: card vs CPU "
          "margins max_abs_err {:.3e}, pred_leaf equal on {} rows, host path equal on {}; MME "
          "POST /models with a verified manifest, 1,000 rows in {:.3f} ms, {} device bytes "
          "while loaded".format(tag, CAT_FLIP, CAT_INVALID, CAT_INVALID_VALUES.tolist(), err,
                                len(bad), CAT_HOST_ROWS, mme_ms, held), flush=True)


def run_model_files(torch, dval, tag, tmp):
    """15b: phase 4's and phase 9's models as UBJ, legacy binary and pickles
    (JSON, UBJ and CONFIG-offset handles), each loaded on the card and
    served within 1e-5 of the JSON model's CPU predict."""
    from sagemaker_xgboost_container_tpu_torch.models.compat import load_model_any_format
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    # CoverType's rows on a grid of 1/8 (exact in f32, so short in csv): 10k
    # rows x 54 features at "%.9g" would pass the 6 MB payload cap
    rows = {"main": dval.features[:N_SERVE],
            "covtype": np.round(make_multiclass(N_SERVE, 54, seed=2)[0] * 8) / 8}
    for name, x in rows.items():
        ref = Forest.load_model(os.path.join(MODELS[name], "xgboost-model"), device="cpu")
        want = ref.predict(x)
        ubj_path = os.path.join(tmp, name + ".ubj")
        ref.save_model(ubj_path)
        with open(ubj_path, "rb") as f:
            ubj = f.read()
        check(ubj[:1] == b"{" and ubj[1:2] != b'"', "15b: {}.ubj is not UBJSON".format(name))
        legacy = legacy_binary(ref)
        files = {"ubj": ubj, "legacy": legacy,
                 "pickle(json)": pickled_booster(ref.save_json().encode()),
                 "pickle(ubj)": pickled_booster(ubj),
                 "pickle(CONFIG-offset)": pickled_booster(config_offset(
                     legacy_binary(ref, binf=False), ref.objective_name))}
        for fmt, raw in files.items():
            model_dir = os.path.join(tmp, "{}-{}".format(name, fmt))
            os.makedirs(model_dir)
            path = os.path.join(model_dir, "xgboost-model")
            with open(path, "wb") as f:
                f.write(raw)
            t = time.perf_counter()
            model, source = load_model_any_format(path, device=DEVICE)
            load_ms = (time.perf_counter() - t) * 1e3
            check(source == ("pkl_format" if fmt.startswith("pickle") else "xgb_format"),
                  "15b: {} {} loaded as {}".format(name, fmt, source))
            err = float(np.abs(model.predict(x) - want).max())
            check(err <= 1e-5, "15b: {} {} predicts {} off the JSON model".format(name, fmt, err))
            (one_ms, _), (many_ms, many_err) = _serve_cases(
                model_dir, [(x[:1], want[:1]), (x, want)])
            print("{} | 15b {} as {} ({} bytes): load {:.3f} ms on the card, predict "
                  "max_abs_err {:.3e}; served 1 row in {:.3f} ms and {} rows in {:.3f} ms "
                  "(max_abs_err {:.3e})".format(tag, name, fmt, len(raw), load_ms, err, one_ms,
                                                len(x), many_ms, many_err), flush=True)


def run_importance(tag):
    """15c: get_score of every type against a numpy recount from phase 4's
    model JSON; get_dump with stats lists every node."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    path = os.path.join(MODELS["main"], "xgboost-model")
    model = Forest.load_model(path, device=DEVICE)
    with open(path) as f:
        trees = json.load(f)["learner"]["gradient_booster"]["model"]["trees"]
    count, gain, cover = {}, {}, {}
    for tree in trees:
        for node in np.nonzero(np.asarray(tree["left_children"]) >= 0)[0]:
            key = "f{}".format(tree["split_indices"][node])
            count[key] = count.get(key, 0) + 1
            gain[key] = gain.get(key, 0.0) + tree["loss_changes"][node]
            cover[key] = cover.get(key, 0.0) + tree["sum_hessian"][node]
    want = {"weight": count, "total_gain": gain, "total_cover": cover,
            "gain": {k: gain[k] / count[k] for k in count},
            "cover": {k: cover[k] / count[k] for k in count}}
    for kind, expected in want.items():
        got = model.get_score(kind)
        check(got == expected, "15c: get_score({}) differs from the recount".format(kind))
    dump = model.get_dump(with_stats=True)
    lines = [line for tree in dump for line in tree.splitlines()]
    nodes = sum(len(tree["left_children"]) for tree in trees)
    check(len(dump) == len(trees) and len(lines) == nodes
          and all("cover=" in line for line in lines),
          "15c: get_dump lists {} lines for {} nodes".format(len(lines), nodes))
    top = sorted(want["total_gain"].items(), key=lambda kv: -kv[1])[:3]
    print("{} | 15c importances: get_score of all 5 types equal to the recount over {} "
          "features, top total_gain {}; get_dump(with_stats) {} lines for {} nodes".format(
              tag, len(count), [(k, round(v, 3)) for k, v in top], len(lines), nodes),
          flush=True)


def run_script_mode(tag, tmp):
    """15d: a user script with TorchXGBRegressor through the train entry
    point (sagemaker_program), its model served; an algorithm-mode job on
    phase 8's channels written as parquet."""
    from sagemaker_xgboost_container_tpu_torch.data.readers import get_data_matrix
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    code_dir = os.path.join(tmp, "code")
    os.makedirs(code_dir)
    with open(os.path.join(code_dir, "train.py"), "w") as f:
        f.write(USER_SCRIPT)
    hp = dict(SCRIPT_HP, sagemaker_submit_directory=code_dir)
    X, y, _data_config, train_dir, val_dir, sm_env = _entry_tree(tmp, {
        "hyperparameters-script.json": hp, "hyperparameters-parquet.json": PARQUET_HP})
    rc, out, err, child_s = _run_entry_child(sm_env("script", "hyperparameters-script.json"))
    check(rc == 0, "15d script mode: exited {}: {}".format(rc, err[-2000:]))
    found = re.findall(r"^script launches (\{.*\})$", out, re.M)
    check(len(found) == 1, "15d: the script printed no launch counts")
    launches = json.loads(found[0])
    check(launches.get("hist_kernel") == 8 * SCRIPT_ROUNDS
          and launches.get("totals_kernel") == SCRIPT_ROUNDS,
          "15d: the script's fit launched {}".format(launches))
    model_dir = os.path.join(tmp, "model-script")
    with open(os.path.join(model_dir, "feature_importance.json")) as f:
        importance = np.asarray(json.load(f))
    check(importance.shape == (N_FEATURES,) and abs(importance.sum() - 1) < 1e-5,
          "15d: feature_importance.json holds {}".format(importance))
    # served from a directory of its own: the serving loader (the JAX
    # package's too) takes the first file of the model dir by name, and
    # feature_importance.json sorts before xgboost-model
    serve_dir = os.path.join(tmp, "serve-script")
    os.makedirs(serve_dir)
    path = os.path.join(serve_dir, "xgboost-model")
    os.replace(os.path.join(model_dir, "xgboost-model"), path)
    x_val = X[ENTRY_TRAIN_ROWS:ENTRY_TRAIN_ROWS + BOOSTER_SERVE_ROWS]
    cpu = Forest.load_model(path, device="cpu").predict(x_val)
    serve_ms, serve_err = _serve_once(serve_dir, x_val, cpu)
    print("{} | 15d script mode (train entry point, sagemaker_program, TorchXGBRegressor on "
          "the card, {} rounds of {} x {} rows): exit 0 in {:.3f} s of wall time, launches "
          "{}, importances sum {:.6f} (top feature {}); served {} csv rows in {:.3f} ms, "
          "max_abs_err {:.3e}".format(tag, SCRIPT_ROUNDS, ENTRY_TRAIN_ROWS, N_FEATURES, child_s,
                                      json.dumps(launches), float(importance.sum()),
                                      int(np.argmax(importance)), len(x_val), serve_ms,
                                      serve_err), flush=True)
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        print("{} | 15d parquet check did not run: pyarrow does not import here ({})".format(
            tag, e), flush=True)
        return
    channels = {}
    for name, rows in (("train", slice(0, ENTRY_TRAIN_ROWS)),
                       ("validation", slice(ENTRY_TRAIN_ROWS, None))):
        channels[name] = os.path.join(tmp, "parquet", name)
        os.makedirs(channels[name])
        cols = [pa.array(y[rows])] + [pa.array(X[rows, j], mask=np.isnan(X[rows, j]))
                                      for j in range(X.shape[1])]
        pq.write_table(pa.table(cols, names=["label"] + ["f{}".format(j)
                                                          for j in range(X.shape[1])]),
                       os.path.join(channels[name], "part-0.parquet"))
    t = time.perf_counter()
    from_parquet = get_data_matrix(channels["train"], "application/x-parquet")
    read_s = time.perf_counter() - t
    from_csv = get_data_matrix(train_dir, "text/csv")
    check(np.array_equal(from_parquet.features.view(np.uint32), from_csv.features.view(np.uint32))
          and np.array_equal(from_parquet.labels, from_csv.labels),
          "15d: the parquet channel's DataMatrix differs from the csv one's")
    config = os.path.join(tmp, "config", "inputdataconfig-parquet.json")
    channel = {"ContentType": "application/x-parquet", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    with open(config, "w") as f:
        json.dump({"train": channel, "validation": dict(channel)}, f)
    env = sm_env("parquet", "hyperparameters-parquet.json")
    env.update(SM_INPUT_DATA_CONFIG_FILE=config, SM_CHANNEL_TRAIN=channels["train"],
               SM_CHANNEL_VALIDATION=channels["validation"])
    rc, out, err, child_s = _run_entry_child(env)
    check(rc == 0, "15d parquet: exited {}: {}".format(rc, err[-2000:]))
    lines = _metric_lines(out)
    found = re.findall(HPO_REGEX.format("logloss"), out)
    check(sorted(lines) == list(range(PARQUET_ROUNDS)) and len(found) == PARQUET_ROUNDS,
          "15d parquet: metric lines for rounds {}, {} HPO-regex lines".format(
              sorted(lines), len(found)))
    print("{} | 15d parquet (pyarrow {}): the train channel's DataMatrix bitwise equal to the "
          "csv one's ({} x {}, read in {:.3f} s); algorithm mode exit 0 in {:.3f} s, {} HPO "
          "lines, validation logloss {:.5f} -> {:.5f}".format(
              tag, pa.__version__, *from_parquet.features.shape, read_s, child_s, len(found),
              lines[0]["validation-logloss"], lines[PARQUET_ROUNDS - 1]["validation-logloss"]),
          flush=True)


# ---------------------------------------------------------------- phase 16
# the training planes of one host on the main path. The armed run's knobs
# (the profiler trace dir is added per run)
PLANES_ENV = {"SM_MODEL_TELEMETRY": "true", "SM_DEVICE_TELEMETRY": "true",
              "SM_HBM_SAMPLE_EVERY": "1", "SM_TRACE": "true", "SM_TRACE_DEVICE_SYNC": "1"}
PLANES_KNOBS = tuple(PLANES_ENV) + ("SM_PROFILER_TRACE_DIR", "SM_FAULT_SPEC")
PLANES_ROUNDS = 10
FLOOR_ROWS = 1_000  # the round whose device time is LATENCY_FLOOR_MS
# rows of the session whose rounds count the learning stats' launches and
# syncs (their number does not depend on the rows; binning 1M costs ~10 s)
STATS_ROWS = 200_000
# 16b / 16c: phase 8's channels with the main path's parameters
DRILL_HP = {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
            "tree_method": "hist", "eta": "0.2", "num_round": "8",
            "eval_metric": "logloss,auc"}
DRILL_DEADLINE_S, DRILL_STALL = "5", "training.round_end:sleep:60@4"  # round 3 stalls
OOM_ROWS, OOM_HEADROOM = 200_000, 1 << 20
# 16d: 1,000 rows as the training rows were drawn, then with features 0-7
# shifted by 3 standard deviations; the 1-row load, 1,000 requests
DRIFT_ROWS, DRIFT_SHIFT, DRIFT_FEATURES, DRIFT_REQUESTS = 1_000, 3.0, 8, 10
DRIFT_LOAD = (10, 100)  # client threads, requests each


def _records(text, metric):
    needle = '"metric": "{}"'.format(metric)
    return [json.loads(line) for line in text.splitlines() if line.startswith("{") and needle in line]


def _child_report(out):
    """What an `--entry-child` printed before it exited: its launch counts
    and consensus checks ({} if nothing)."""
    found = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"launches"')]
    return found[-1] if found else {}


def _child_launches(out):
    """The launch counts an `--entry-child` printed before it exited."""
    return _child_report(out).get("launches")


def entry_child():
    """`chip_smoke.py --entry-child`: the train entry point
    (`training.entry.main`), printing the kernels' launch counts (and the
    consensus checks it made) as it exits, normally or through the
    watchdog's abort path, and the launch counts again at an elastic
    reform (`{"reform_launches": ...}`). With MODEL_COPY, every rank saves
    its model there."""
    import atexit

    from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist
    from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY, snapshot_fields
    from sagemaker_xgboost_container_tpu_torch.training import (algorithm_train, elastic, entry,
                                                                watchdog)

    _sample_rss()

    def report():
        _say({"launches": dict(hist.LAUNCHES), "consensus_checks": int(
            snapshot_fields(REGISTRY).get("consensus_checks_total", 0)),
            "rss_peak_mb": _rss_peak_mb()})

    real_exit = watchdog._exit

    def exit_with_report(code):
        report()
        real_exit(code)

    watchdog._exit = exit_with_report
    atexit.register(report)
    perform_reform = elastic.perform_reform

    def reform_with_report(*args, **kwargs):
        _say({"reform_launches": dict(hist.LAUNCHES)})
        return perform_reform(*args, **kwargs)

    elastic.perform_reform = reform_with_report
    if os.environ.get("MODEL_COPY"):
        train_job = algorithm_train.train_job

        def copy_model(*args, **kwargs):
            bst = train_job(*args, **kwargs)
            bst.save_model(os.environ["MODEL_COPY"])
            return bst

        algorithm_train.train_job = copy_model
    if os.environ.get("CHIP_SMOKE_INGEST_REPORT"):
        _report_ingest(atexit)
    from sagemaker_xgboost_container_tpu_torch.parallel import local

    spawn = local.spawn_local_ranks

    def spawn_counted(topo, spec, _target, on_failure):
        # the workers report their own launch counts as they finish
        return spawn(topo, spec, local_rank_child, on_failure)

    local.spawn_local_ranks = spawn_counted
    entry.main()


def _say(doc):
    """One JSON line on stdout in one write: a host's local ranks share its
    stdout, and a line printed in two writes (the text, then the newline)
    could take another process's line into it."""
    sys.stdout.write(json.dumps(doc) + "\n")
    sys.stdout.flush()


_RSS_PEAK = {}


def _rss_mb():
    """This process's resident set now (VmRSS), MiB."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


def _sample_rss(every_s=0.05):
    """Track this process's peak VmRSS from a daemon thread, sampled every
    ``every_s``: the card's sandbox kernel reports no VmHWM, and a spawned
    process's ru_maxrss starts from its spawner's."""
    def run():
        while True:
            rss = _rss_mb()
            if not rss <= _RSS_PEAK.get("mb", 0.0):
                _RSS_PEAK["mb"] = rss
            time.sleep(every_s)

    threading.Thread(target=run, daemon=True, name="rss-sampler").start()


def _rss_peak_mb():
    """This process's peak resident set as sampled (``_sample_rss``), MiB."""
    return max(_RSS_PEAK.get("mb", float("nan")), _rss_mb())


def local_rank_child(local_rank, spec, parent_pid, err_path):
    """A local rank that an `--entry-child` leader spawns (phases 21, 22):
    the port's worker entry (`training.entry.local_rank_main`), printing one
    `{"rank_launches": ...}` line (its launch counts, its collectives'
    calls and host seconds, its peak RSS) as its training returns, and its
    launch counts as an elastic reform begins (`{"reform_launches": ...,
    "local_rank": ...}`)."""
    from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist
    from sagemaker_xgboost_container_tpu_torch.parallel import collectives
    from sagemaker_xgboost_container_tpu_torch.training import algorithm_train, elastic, entry

    _sample_rss()
    run = algorithm_train.run_local_rank

    def counted(rank, worker_spec):
        try:
            return run(rank, worker_spec)
        finally:
            _say({"rank_launches": dict(hist.LAUNCHES), "local_rank": rank,
                  "collective_calls": collectives.STATS["calls"],
                  "collective_s": round(collectives.STATS["seconds"], 6),
                  "rss_peak_mb": _rss_peak_mb()})

    algorithm_train.run_local_rank = counted
    perform_reform = elastic.perform_reform

    def reform_with_report(*args, **kwargs):
        _say({"reform_launches": dict(hist.LAUNCHES), "local_rank": local_rank})
        return perform_reform(*args, **kwargs)

    elastic.perform_reform = reform_with_report
    entry.local_rank_main(local_rank, spec, parent_pid, err_path)


def _digest(*arrays):
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _report_ingest(atexit):
    """Phase 19's view of an `--entry-child` (CHIP_SMOKE_INGEST_REPORT set):
    what ingest gave the session (pre-binned or floats), sha256 digests of
    the bins and cuts the session trains and evaluates on, the streaming
    plane's chunks a channel. Printed as one `{"ingest": ...}` line at
    exit."""
    from sagemaker_xgboost_container_tpu_torch.data import streaming
    from sagemaker_xgboost_container_tpu_torch.data.binning import BinnedMatrix
    from sagemaker_xgboost_container_tpu_torch.models import booster
    from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY, snapshot_fields

    doc = {"chunks": {}}
    init, ingest = booster._TrainingSession.__init__, streaming.ingest_channel

    def session_init(self, config, dtrain, evals, *args, **kwargs):
        init(self, config, dtrain, evals, *args, **kwargs)
        doc["kind"] = "binned" if isinstance(dtrain, BinnedMatrix) else "floats"
        doc["cuts"] = _digest(*self.cuts)
        doc["bins"] = _digest(np.asarray(self.train_binned.bins), self.labels.cpu().numpy())
        doc["eval_bins"] = [_digest(e[2].cpu().numpy(), e[3].cpu().numpy())
                            for e in self.eval_sets if e[2] is not None]

    def ingest_channel(*args, **kwargs):
        key = "ingest_chunks_total{status=ok}"
        before = snapshot_fields(REGISTRY).get(key, 0.0)
        out = ingest(*args, **kwargs)
        doc["chunks"][kwargs.get("channel", "train")] = int(
            snapshot_fields(REGISTRY).get(key, 0.0) - before)
        return out

    booster._TrainingSession.__init__ = session_init
    streaming.ingest_channel = ingest_channel
    atexit.register(lambda: _say({"ingest": doc}))


def oom_child(out_dir):
    """`chip_smoke.py --oom-child DIR`: the main path (depth 8, max_bin 256,
    28 features; OOM_ROWS rows) with the process's device memory capped,
    once its session is on the card, at what it holds plus OOM_HEADROOM, so
    that the first round cannot allocate: the round's OOM path must dump
    forensics into DIR (SM_TRACE_EXPORT_DIR) and exit 86."""
    import torch

    import sagemaker_xgboost_container_tpu_torch as pkg
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist
    from sagemaker_xgboost_container_tpu_torch.training import watchdog

    os.environ["SM_TRACE_EXPORT_DIR"] = out_dir
    X, y = make_data(OOM_ROWS, N_FEATURES, seed=0)

    class Squeeze:
        def before_training(self, forest):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            total = torch.cuda.get_device_properties(0).total_memory
            allowed = torch.cuda.memory_reserved() + OOM_HEADROOM
            torch.cuda.set_per_process_memory_fraction(allowed / total)
            print(json.dumps({"fraction": allowed / total, "allowed_bytes": allowed,
                              "total_bytes": total}), flush=True)
            return forest

    real_exit = watchdog._exit

    def exit_with_report(code):
        print(json.dumps({"launches": dict(hist.LAUNCHES)}), flush=True)
        real_exit(code)

    watchdog._exit = exit_with_report
    pkg.train(MAIN_PARAMS, DataMatrix(X, y), 1, device=DEVICE, callbacks=[Squeeze()],
              verbose_eval=False)
    print("the capped round did not run out of memory", file=sys.stderr, flush=True)
    return 1


def run_planes(torch, hist, pkg, dtrain, dval, tag):
    """Phase 16: the training planes on one host (see the module docstring).
    16c's two children run beside 16b's three, which follow one another."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_planes_") as tmp:
        _planes_in_process(torch, hist, pkg, dtrain, dval, tag, tmp)
        _, _, _, train_dir, _, sm_env = _entry_tree(os.path.join(tmp, "entry"), {
            "hyperparameters.json": DRILL_HP,
            "hyperparameters-depth.json": dict(DRILL_HP, max_depth="6")})
        drills = _in_background(_planes_drills, tag, tmp, sm_env)
        try:
            model_dir = _planes_entry(tag, tmp, sm_env, train_dir)
        finally:
            drills()
        _planes_serve(tag, tmp, model_dir)
    print("{} | planes phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _in_background(fn, *args):
    """Start ``fn(*args)`` on a thread -> a function that waits for it and
    returns its result or raises its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # re-raised by the waiter
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box.get("out")

    return wait


class _Evals:
    """Callback: the run's evals log (no sync of its own)."""

    def after_iteration(self, forest, rnd, evals_log):
        self.log = {k: dict(v) for k, v in evals_log.items()}
        return False


def _planes_run(torch, hist, pkg, dtrain, dval, env, tmp, label):
    """The main path through `get_callbacks`' stack with `env` set:
    -> (forest, stdout, launches, evals log)."""
    import contextlib
    import io

    from sagemaker_xgboost_container_tpu_torch.telemetry import device as device_telemetry
    from sagemaker_xgboost_container_tpu_torch.telemetry import model as model_telemetry
    from sagemaker_xgboost_container_tpu_torch.telemetry import tracing
    from sagemaker_xgboost_container_tpu_torch.training import profiling
    from sagemaker_xgboost_container_tpu_torch.training.callbacks import get_callbacks

    saved = {k: os.environ.pop(k, None) for k in PLANES_KNOBS}
    os.environ.update(env)
    # the planes resolve their knobs once a process; start each run afresh
    for mod in (tracing, device_telemetry, model_telemetry):
        mod._reset_for_tests()
    try:
        _, _, callbacks = get_callbacks(
            model_dir=os.path.join(tmp, "model-" + label), checkpoint_dir=None,
            early_stopping_data_name=None, early_stopping_metric=None,
            early_stopping_rounds=None, save_model_on_termination="false", is_master=True,
            num_round=PLANES_ROUNDS, num_rows=dtrain.num_row, train_cfg=MAIN_PARAMS)
        evals = _Evals()
        callbacks.insert(len(callbacks) - 1, evals)  # RoundTimer stays last
        hist.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            with profiling.xla_trace():
                forest = pkg.train(MAIN_PARAMS, dtrain, PLANES_ROUNDS,
                                   evals=[(dval, "validation")], device=DEVICE,
                                   callbacks=callbacks, verbose_eval=False)
            torch.cuda.synchronize()
        return forest, buf.getvalue(), dict(hist.LAUNCHES), evals.log
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        for mod in (tracing, device_telemetry, model_telemetry):
            mod._reset_for_tests()


def _planes_in_process(torch, hist, pkg, dtrain, dval, tag, tmp):
    """16a: the main path twice, with no plane armed and with them all."""
    trace_dir = os.path.join(tmp, "trace")
    runs = {}
    for label, env in (("unarmed", {}), ("armed", dict(PLANES_ENV,
                                                       SM_PROFILER_TRACE_DIR=trace_dir))):
        forest, out, launches, log = _planes_run(torch, hist, pkg, dtrain, dval, env, tmp,
                                                 label)
        rounds = _records(out, "training.round")
        check(len(rounds) == PLANES_ROUNDS, "{}: {} training.round records".format(
            label, len(rounds)))
        check(launches == {"hist_kernel": 8 * PLANES_ROUNDS, "totals_kernel": PLANES_ROUNDS},
              "{} run launches {}".format(label, launches))
        steady_ms = sum(r["round_ms"] for r in rounds[2:PLANES_ROUNDS])
        runs[label] = (forest, out, log, steady_ms)
        print("{} | planes 16a {}: launches {}; rounds/s over rounds 2-9 {:.3f} (RoundTimer's "
              "round_ms); validation logloss {:.6f}".format(
                  tag, label, json.dumps(launches), (PLANES_ROUNDS - 2) / (steady_ms / 1e3),
                  log["validation"]["logloss"][-1]), flush=True)
    _, out, log, _ = runs["armed"]
    learning = _records(out, "training.learning")
    check(len(learning) == PLANES_ROUNDS, "{} training.learning records".format(len(learning)))
    check(all(r["grad_nonfinite"] == 0 and r["margin_nonfinite"] == 0 for r in learning),
          "the armed run saw non-finite gradients")
    counts = {m: len(_records(out, m)) for m in ("training.summary", "training.attribution",
                                                 "training.roofline", "training.compiled",
                                                 "training.trace")}
    check(all(v == 1 for v in counts.values()), "armed run records: {}".format(counts))
    (attribution,) = _records(out, "training.attribution")
    (roofline,) = _records(out, "training.roofline")
    (compiled,) = _records(out, "training.compiled")
    (trace,) = _records(out, "training.trace")
    check(roofline["device_time_source"] == "device_sync" and attribution["device_ms"] > 0,
          "attribution did not read device_sync: {} {}".format(attribution, roofline))
    rounds = _records(out, "training.round")
    check(all({"host_dispatch", "device_sync"} <= set(r["phases_ms"]) for r in rounds),
          "a round without its host_dispatch / device_sync phases")
    print("{} | planes 16a armed: attribution total {:.3f} ms, host {:.3f} ms ({} %), device "
          "{:.3f} ms ({} %), compile {:.3f} ms; roofline {} (source {}), {:.4e} bytes/s and "
          "{:.4e} adds/s achieved against the counted {:.4e} bytes and {:.4e} adds a round, "
          "device {:.3f} ms a round; round peak {} bytes".format(
              tag, attribution["total_ms"], attribution["host_ms"], attribution["host_pct"],
              attribution["device_ms"], attribution["device_pct"], attribution["compile_ms"],
              roofline["binding"], roofline["device_time_source"],
              roofline["achieved_bytes_per_sec"], roofline["achieved_flops_per_sec"],
              compiled["bytes_per_round"], compiled["flops_per_round"],
              roofline["device_ms_per_round"], compiled["hbm_peak_bytes"]), flush=True)
    trace_files = os.listdir(trace_dir)
    check(trace_files and os.path.basename(trace["path"]) in trace_files,
          "no profiler trace in {}".format(trace_dir))
    print("{} | planes 16a armed: torch.profiler trace {} of {} bytes".format(
        tag, os.path.basename(trace["path"]), os.path.getsize(trace["path"])), flush=True)
    ll = {k: runs[k][2]["validation"]["logloss"][-1] for k in runs}
    same = sum(np.array_equal(a.feature, b.feature) and np.array_equal(a.threshold, b.threshold)
               for a, b in zip(runs["armed"][0].trees, runs["unarmed"][0].trees))
    tol = SWEEP_METRIC_TOL if same == PLANES_ROUNDS else SWEEP_SPLIT_TOL
    gap = abs(ll["armed"] - ll["unarmed"]) / max(1.0, abs(ll["unarmed"]))
    print("{} | planes 16a: armed vs unarmed validation logloss {:.6f} vs {:.6f} (gap {:.3e}, "
          "tolerance {:.0e}; {} of {} trees alike)".format(
              tag, ll["armed"], ll["unarmed"], gap, tol, same, PLANES_ROUNDS), flush=True)
    check(gap <= tol, "the armed run's logloss moved by {:.3e}".format(gap))
    _planes_memory_and_stats(torch, pkg, dtrain, tag, runs)


def _planes_memory_and_stats(torch, pkg, dtrain, tag, runs):
    """16a: the watermark against the allocator, the learning stats' extra
    launches and host syncs a round, and the card's latency floor."""
    from sagemaker_xgboost_container_tpu_torch.models import booster
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.telemetry import device as device_telemetry

    keep = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    torch.cuda.synchronize()
    snap = device_telemetry.sample_device_memory(max_age_s=0.0)
    allocated = torch.cuda.memory_allocated()
    print("{} | planes 16a: memory sample {} bytes in use (source {}) against "
          "memory_allocated {} bytes; peak {}, limit {}".format(
              tag, snap["total_bytes_in_use"], snap["source"], allocated,
              snap["peak_bytes_in_use"], snap["bytes_limit"]), flush=True)
    check(snap["source"] == "memory_stats" and keep.numel() <= snap["total_bytes_in_use"]
          <= allocated, "the memory sample disagrees with the allocator")
    del keep

    def session(dm):
        forest = Forest(objective_name="binary:logistic", base_score=0.5,
                        num_feature=dm.num_col, device=DEVICE)
        return booster._TrainingSession(booster.TrainConfig(MAIN_PARAMS), dm, [], forest,
                                        ["logloss"], torch.device(DEVICE))

    s = session(dtrain.slice(np.arange(STATS_ROWS)))
    per = {}
    for flag in (False, True):
        s.learning_stats = flag
        _, launches = device_total(torch, lambda: s.run_round(0), iters=3)
        syncs = host_syncs(torch, lambda: s.run_round(0))
        per[flag] = (launches, syncs)
    extra_launches = per[True][0] - per[False][0]
    extra_syncs = per[True][1] - per[False][1]
    print("{} | planes 16a: a main-path round ({:,} rows) {:.0f} launches and {} host syncs "
          "without the learning stats, {:.0f} and {} with them: {:+.0f} launches, {:+d} host "
          "syncs (torch.profiler; torch's sync debug mode)".format(
              tag, STATS_ROWS, per[False][0], per[False][1], per[True][0], per[True][1],
              extra_launches, extra_syncs), flush=True)
    check(extra_syncs == 0, "the learning stats add {} host syncs a round".format(extra_syncs))
    small = session(dtrain.slice(np.arange(FLOOR_ROWS)))
    floor_ms, floor_launches = device_total(torch, lambda: small.run_round(0), iters=5)
    print("{} | planes 16a: latency floor: a main-path round at {:,} rows takes {:.4f} ms of "
          "device time ({:.0f} launches, torch.profiler); LATENCY_FLOOR_MS = {}".format(
              tag, FLOOR_ROWS, floor_ms, floor_launches, device_telemetry.LATENCY_FLOOR_MS),
          flush=True)


def _planes_entry(tag, tmp, sm_env, train_dir):
    """16b: the entry point in child processes on the SageMaker tree under
    ``tmp``/entry (``sm_env``): the stalled round (exit 79), the resume with
    one transient read, the strict resume under another max_depth. -> the
    resumed model's dir."""
    from sagemaker_xgboost_container_tpu_torch.data import readers
    from sagemaker_xgboost_container_tpu_torch.telemetry import REGISTRY
    from sagemaker_xgboost_container_tpu_torch.utils import faults, integrity

    root = os.path.join(tmp, "entry")
    ckpt = os.path.join(root, "ckpt-drill")

    def child(env, what):
        rc, out, err, secs = _run_entry_child(env, timeout=300, command=ENTRY_CHILD_COMMAND)
        launches = _child_launches(out)
        print("{} | planes 16b {}: exit {} in {:.3f} s; launches {}".format(
            tag, what, rc, secs, json.dumps(launches)), flush=True)
        return rc, out, err, launches

    # the stall: round 3 sleeps 60 s, the 5 s deadline aborts
    env = sm_env("drill")
    env.update(SM_ROUND_DEADLINE_S=DRILL_DEADLINE_S, SM_FAULT_SPEC=DRILL_STALL, SM_TRACE="true")
    rc, out, err, launches = child(env, "stalled round")
    check(rc == 79, "the stalled job exited {}: {}".format(rc, err[-2000:]))
    (abort,) = _records(out, "training.abort")
    check(abort["reason"] == "round_deadline" and abort["stalled_s"] <= 10.0,
          "abort record {}".format(abort))
    check(launches == {"hist_kernel": 32, "totals_kernel": 4},
          "the stalled job's launches {}".format(launches))
    path2 = os.path.join(ckpt, "xgboost-checkpoint.2")
    manifest = integrity.read_manifest(path2)
    check(manifest is not None and integrity.check_model_file(path2) == "verified"
          and manifest["fingerprint"]["max_depth"] == "8", "checkpoint 2's manifest")
    check(os.path.exists(os.path.join(ckpt, "flight-recorder-rank0.json")),
          "no flight-recorder dump in the checkpoint dir")
    print("{} | planes 16b: abort after {} s stalled (deadline {} s), last round {}; "
          "checkpoints {}; flight recorder {}".format(
              tag, abort["stalled_s"], abort["deadline_s"], abort["last_round"],
              sorted(f for f in os.listdir(ckpt) if not f.endswith(".manifest")),
              os.path.basename(abort.get("flight_recorder", ""))), flush=True)

    # the restart: resumes after checkpoint 3, one transient chunk read
    # absorbed (the job streams its channel, as it would by default)
    env = sm_env("drill")
    env.update(SM_MODEL_TELEMETRY="true", SM_FAULT_SPEC="data.chunk:error@1",
               SM_INGEST_MODE="chunked")
    rc, out, err, launches = child(env, "resume with data.chunk:error@1")
    check(rc == 0, "the resumed job exited {}: {}".format(rc, err[-2000:]))
    lines = sorted(_metric_lines(out))
    check(lines == list(range(4, 8)), "resumed rounds {}".format(lines))
    check("transient failure at ingest.chunk" in out + err, "no retry logged by the resumed job")
    check(launches == {"hist_kernel": 32, "totals_kernel": 4},
          "the resumed job's launches {}".format(launches))
    model_dir = os.path.join(root, "model-drill")
    model = os.path.join(model_dir, "xgboost-model")
    manifest = integrity.read_manifest(model)
    check(manifest is not None and integrity.check_model_file(model) == "verified",
          "the final model's manifest")
    check(all(manifest.get(k) for k in ("fingerprint", "learning", "drift_baseline")),
          "the final manifest lacks {}".format(
              [k for k in ("fingerprint", "learning", "drift_baseline") if not manifest.get(k)]))
    print("{} | planes 16b: final manifest: fingerprint {}, learning {}, drift baseline of {} "
          "rows x {} features".format(tag, manifest["fingerprint"], manifest["learning"],
                                      manifest["drift_baseline"]["rows"],
                                      len(manifest["drift_baseline"]["features"])), flush=True)

    # another max_depth under SM_RESUME_STRICT: refused, naming the key
    env = sm_env("drill", "hyperparameters-depth.json")
    env.update(SM_RESUME_STRICT="true", SM_MODEL_DIR=os.path.join(root, "model-strict"),
               SM_OUTPUT_DIR=os.path.join(root, "output-strict"))
    rc, out, err, _ = child(env, "strict resume, max_depth 6")
    failure = os.path.join(root, "output-strict", "failure")
    text = open(failure).read() if os.path.exists(failure) else ""
    check(rc != 0 and "max_depth" in text and "Refusing to resume" in text,
          "the strict resume exited {}: {}".format(rc, text[-1000:] or err[-1000:]))
    print("{} | planes 16b: strict resume refused: {}".format(
        tag, text.strip().splitlines()[0][:160]), flush=True)

    # the retry counted, in this process
    site = "io_retries_total{site=reader.csv}"
    before = _registry_value(REGISTRY, site)
    faults.configure("data.read:error@1")
    try:
        dm = readers.get_data_matrix(train_dir, "csv")
    finally:
        faults.reset()
    after = _registry_value(REGISTRY, site)
    check(after - before == 1 and dm.num_row == ENTRY_TRAIN_ROWS,
          "io_retries_total moved by {}".format(after - before))
    print("{} | planes 16b: in-process read with data.read:error@1: {} rows, "
          "io_retries_total{{site=reader.csv}} +{:.0f}".format(tag, dm.num_row, after - before),
          flush=True)
    return model_dir


def _registry_value(registry, key):
    from sagemaker_xgboost_container_tpu_torch.telemetry import snapshot_fields

    return snapshot_fields(registry).get(key, 0.0)


def _planes_drills(tag, tmp, sm_env):
    """16c: the numeric-poison drill (exit 87) and the device-OOM drill
    (exit 86), at once."""
    out_dir = os.path.join(tmp, "oom")
    os.makedirs(out_dir)
    oom = _in_background(_oom_drill, out_dir)
    env = sm_env("poison")
    env.update(SM_MODEL_TELEMETRY="true", SM_FAULT_SPEC="train.gradient_poison:nan@3")
    try:
        rc, out, err, secs = _run_entry_child(env, timeout=300, command=ENTRY_CHILD_COMMAND)
    finally:
        proc, oom_s = oom()
    launches = _child_launches(out)
    path = os.path.join(tmp, "entry", "ckpt-poison", "learning-forensics-rank0.json")
    check(rc == 87 and os.path.exists(path), "the poison drill exited {}: {}".format(
        rc, err[-2000:]))
    doc = json.load(open(path))
    (abort,) = _records(out, "training.abort")
    check(doc["first_bad_round"] == 2 and abort["round"] == 2,
          "the poison drill named round {}".format(doc.get("first_bad_round")))
    print("{} | planes 16c poison: exit 87 in {:.3f} s, launches {}; forensics name round {} "
          "({} rounds of stats)".format(tag, secs, json.dumps(launches), doc["first_bad_round"],
                                        len(doc["stats_history"])), flush=True)

    path = os.path.join(out_dir, "hbm-forensics-rank0.json")
    check(proc.returncode == 86 and os.path.exists(path), "the OOM drill exited {}: {}".format(
        proc.returncode, proc.stderr[-2000:]))
    cap = [json.loads(line) for line in proc.stdout.splitlines()
           if line.startswith('{"fraction"')][0]
    doc = json.load(open(path))
    blocks = doc.get("top_live_buffers") or []
    check(blocks and doc["memory"]["source"] == "memory_stats",
          "the OOM forensics list no blocks: {}".format(str(doc)[:500]))
    print("{} | planes 16c OOM: exit 86 in {:.3f} s, launches {}; memory fraction {:.3e} "
          "allowed {} of {} bytes; forensics: {} blocks, largest {} bytes, {} in use; error "
          "{}".format(tag, oom_s, json.dumps(_child_launches(proc.stdout)), cap["fraction"],
                      cap["allowed_bytes"], cap["total_bytes"], len(blocks),
                      blocks[0]["total_bytes"], doc["memory"]["total_bytes_in_use"],
                      doc["error"][:120]), flush=True)


def _oom_drill(out_dir):
    """`chip_smoke.py --oom-child out_dir` -> (its CompletedProcess, wall s)."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--oom-child", out_dir],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter() - t


def _drift_rows(seed, shift):
    """DRIFT_ROWS rows drawn as phase 8's training rows were (ENTRY_MISSING
    of the values missing), features 0-7 moved by `shift` sigma."""
    X, _ = make_data(DRIFT_ROWS, N_FEATURES, seed=seed)
    X[np.random.RandomState(seed + 1).rand(*X.shape) < ENTRY_MISSING] = np.nan
    X[:, :DRIFT_FEATURES] += shift
    return X


def _planes_serve(tag, tmp, model_dir):
    """16d: 16b's model behind the single-model endpoint with the drift
    monitor armed: calm traffic, then shifted; the runtime gauges; the
    1-row p50 armed and unarmed."""
    import shutil

    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    serve_dir = os.path.join(tmp, "serve")
    os.makedirs(serve_dir)
    for name in ("xgboost-model", "xgboost-model.manifest"):
        shutil.copy(os.path.join(model_dir, name), serve_dir)
    on_cpu = Forest.load_model(os.path.join(serve_dir, "xgboost-model"), device="cpu")
    calm, shifted = _drift_rows(ENTRY_SEED + 7, 0.0), _drift_rows(ENTRY_SEED + 7, DRIFT_SHIFT)
    one_rows = calm[:50]
    targets = [("/invocations", one_rows[i:i + 1], on_cpu.predict(one_rows[i:i + 1]))
               for i in range(len(one_rows))]
    p50 = {}
    for label, env in (("armed", {"SM_MODEL_TELEMETRY": "true"}), ("unarmed", {})):
        server = _ServerChild(tmp, "planes-" + label, dict(
            env, SM_MODEL_DIR=serve_dir, SM_SERVING_METRICS="true"), multi_model=False)
        try:
            server.wait_ready()
            _poll(lambda: _http(server.base, "/ping")[0], lambda s: s == 200, 120, "/ping")
            if label == "armed":
                _drift_traffic(tag, server.base, calm, shifted, on_cpu)
            lat, wall, failed, statuses = _child_load(server.base, tmp, targets, *DRIFT_LOAD)
            check(not failed, "{} 1-row load failed: {}".format(label, failed[:5]))
            p50[label] = float(np.percentile(lat, 50))
            print("{} | planes 16d {}: 1-row csv load, {} requests from {} client threads: "
                  "{}, {:.1f} requests/s".format(tag, label, len(lat), DRIFT_LOAD[0],
                                                 _percentiles(lat), len(lat) / wall), flush=True)
        finally:
            server.close()
    print("{} | planes 16d: 1-row p50 {:.3f} ms with the drift monitor armed, {:.3f} ms "
          "unarmed".format(tag, p50["armed"], p50["unarmed"]), flush=True)


def _drift_traffic(tag, base, calm, shifted, on_cpu):
    per = DRIFT_ROWS // DRIFT_REQUESTS
    for what, X in (("calm", calm), ("shifted", shifted)):
        for k in range(DRIFT_REQUESTS):
            rows = X[k * per:(k + 1) * per]
            status, _, body = _http(base, "/invocations", _csv_body(rows), accept="text/csv")
            check(status == 200, "{} request answered {}".format(what, status))
            err = np.abs(_decode_scores(body, "text/csv") - on_cpu.predict(rows)).max()
            check(err <= 1e-5, "{} request off the CPU predict by {}".format(what, err))
        check(_http(base, "/ping")[0] == 200, "/ping after the {} rows".format(what))
        scraped = _metrics(base)
        psi, state = scraped.get("model_drift_psi"), scraped.get("serving_state")
        print("{} | planes 16d: after {:,} {} rows: model_drift_psi {}, serving_state {} "
              "(2 = degraded)".format(tag, DRIFT_ROWS, what, psi, state), flush=True)
        check(psi is not None, "no model_drift_psi on /metrics: the monitor is not armed")
        if what == "calm":
            check(psi < 0.2 and state != 2.0, "calm traffic read as drift")
        else:
            check(psi > 0.2 and state == 2.0, "shifted traffic not degraded")
    gauges = {k: scraped.get(k) for k in ("process_rss_bytes", "process_open_fds",
                                          "process_threads", "device_live_bytes")}
    print("{} | planes 16d: runtime gauges {}".format(tag, json.dumps(gauges)), flush=True)
    check(all(v is not None for v in gauges.values()) and gauges["device_live_bytes"] > 0,
          "runtime gauges missing from /metrics: {}".format(gauges))


# ---------------------------------------------------------------- phase 17

# 17a: the main path's rows split unevenly over two ranks on the one card
# (two processes joined by gloo: NCCL refuses two ranks on one device)
DIST_HOSTS = ["127.0.0.1", "localhost"]   # sorted: rank 0, rank 1
DIST_SPLIT, DIST_ROUNDS, DIST_SYNC_ROUND = 500_003, 10, 5
DIST_CHILD_COMMAND = [sys.executable, os.path.abspath(__file__), "--rank-child"]
# 17b / 17c: the train entry point on two hosts, each with its half of
# phase 8's channels
DIST_ENTRY_HP = {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
                 "tree_method": "hist", "eta": "0.2", "num_round": "20",
                 "eval_metric": "logloss,auc"}
DIST_ENTRY_ROUNDS = 20
DIST_ENTRY_COMMAND = ENTRY_CHILD_COMMAND   # prints its launch counts as it exits
DIST_HEARTBEAT_S, DIST_PG_TIMEOUT_S, DIST_KILL_ROUND = 1.0, 30.0, 3


def free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def comm_bytes_from_shapes(max_depth, d, B):
    """The bytes one depthwise round reduces, counted from the shapes: the
    root's histogram and one left child a sibling pair at levels 1 to
    max_depth - 1 (sibling subtraction), each (G, H) f32 [d, B], and the
    last level's (g, h) f32 node totals."""
    nodes = 1 + sum(2 ** (level - 1) for level in range(1, max_depth))
    return nodes * d * B * 2 * 4 + 2 * 2 ** max_depth * 4


def rank_child(spec_path):
    """`chip_smoke.py --rank-child SPEC`: one rank of phase 17a: the
    process group (gloo, the caller's choice, on cuda:0), this rank's rows of
    the main path, DIST_ROUNDS rounds of `train(group=)`, and a JSON file of
    what it measured a round."""
    import warnings

    import torch

    import sagemaker_xgboost_container_tpu_torch as pkg
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist
    from sagemaker_xgboost_container_tpu_torch.parallel import collectives, distributed

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("phase") == 18:
        return option_rank_child(spec)
    rank, device, rounds = spec["rank"], torch.device(spec["device"]), spec["rounds"]
    n, n_val, split, sync_round = spec["n_train"], spec["n_val"], spec["split"], spec["sync_round"]
    cuda = device.type == "cuda"
    group = distributed.init_process_group(DIST_HOSTS, DIST_HOSTS[rank], device,
                                           backend="gloo", port=spec["port"])
    X, y = make_data(n + n_val, N_FEATURES, seed=0)
    rows = slice(0, split) if rank == 0 else slice(split, n)
    half = n + n_val // 2
    vrows = slice(n, half) if rank == 0 else slice(half, n + n_val)
    marks, launches, comm, syncs = [], [], [], {}
    recording = warnings.catch_warnings(record=True)

    def mark():
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        launches.append(dict(hist.LAUNCHES))
        comm.append({"calls": collectives.STATS["calls"],
                     "seconds": collectives.STATS["seconds"],
                     "kinds": dict(collectives.STATS["kinds"])})

    class Meter:
        def before_training(self, forest):
            mark()
            return forest

        def after_iteration(self, forest, rnd, evals_log):
            if rnd == sync_round and cuda:
                # the host syncs of one whole round (its collectives, the
                # metric gather and the round's copy of the trees)
                torch.cuda.set_sync_debug_mode("default")
                recording.__exit__(None, None, None)
                syncs["debug_mode"] = sum("synchronizing CUDA operation" in str(w.message)
                                          for w in self.seen)
            mark()
            self.log = {k: dict(v) for k, v in evals_log.items()}
            if rnd == sync_round - 1 and cuda:
                self.seen = recording.__enter__()
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            return False

    meter = Meter()
    hist.reset_launch_counts()
    collectives.reset_stats()
    t0 = time.perf_counter()
    forest = pkg.train(MAIN_PARAMS, DataMatrix(X[rows], y[rows]), rounds,
                       evals=[(DataMatrix(X[vrows], y[vrows]), "validation")], device=device,
                       group=group, callbacks=[meter], verbose_eval=False)
    forest.save_model(spec["model"])
    distributed.destroy_process_group()
    r0, r1 = 1, rounds - 1      # rounds 2..rounds-1 (1-based)
    per = r1 - r0

    def per_round(a, b):
        return {k: (b.get(k, 0) - a.get(k, 0)) / per for k in b}

    result = {
        "rank": rank, "rows": rows.stop - rows.start, "setup_s": marks[0] - t0,
        "rounds_per_s": per / (marks[r1 + 1] - marks[r0 + 1]),
        "launches_per_round": {k: (launches[-1][k] - launches[0][k]) / rounds
                               for k in launches[-1]},
        "collective_calls_per_round": (comm[r1 + 1]["calls"] - comm[r0 + 1]["calls"]) / per,
        "collective_ms_per_round": (comm[r1 + 1]["seconds"] - comm[r0 + 1]["seconds"])
        * 1e3 / per,
        "bytes_per_round": per_round(comm[r0 + 1]["kinds"], comm[r1 + 1]["kinds"]),
        "host_syncs_round": syncs.get("debug_mode"),
        "sync_round_collectives": comm[sync_round + 1]["calls"] - comm[sync_round]["calls"],
        "logloss": meter.log["validation"]["logloss"],
        "backend": "gloo",
    }
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


def run_distributed(torch, hist, pkg, dtrain, dval, tag):
    """Phase 17: data-parallel training across ranks (see the module
    docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        run_two_ranks(torch, pkg, dtrain, dval, tag, tmp)
        run_two_hosts(tag, tmp)
        run_host_loss(tag, tmp)
    print("{} | distributed phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def run_two_ranks(torch, pkg, dtrain, dval, tag, tmp):
    """17a: two ranks on the card against one rank on all rows."""
    from sagemaker_xgboost_container_tpu_torch.ops.histogram import round_comm_plan

    log = _RoundLog(torch)
    pkg.train(MAIN_PARAMS, dtrain, DIST_ROUNDS, evals=[(dval, "validation")], device=DEVICE,
              callbacks=[log], verbose_eval=False)
    single = log.logloss
    port = free_port()
    procs, specs = [], []
    for rank in range(2):
        spec = {"rank": rank, "port": port, "out": os.path.join(tmp, "rank{}.json".format(rank)),
                "model": os.path.join(tmp, "rank{}-model.json".format(rank)), "device": DEVICE,
                "rounds": DIST_ROUNDS, "n_train": N_TRAIN, "n_val": N_VAL,
                "split": DIST_SPLIT, "sync_round": DIST_SYNC_ROUND}
        specs.append(spec)
        path = os.path.join(tmp, "spec{}.json".format(rank))
        with open(path, "w") as f:
            json.dump(spec, f)
        procs.append(subprocess.Popen(DIST_CHILD_COMMAND + [path], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, "17a: rank {} exited {}: {}".format(rank, p.returncode,
                                                                     out[-3000:]))
    res = []
    for spec in specs:
        with open(spec["out"]) as f:
            res.append(json.load(f))
    with open(specs[0]["model"], "rb") as f0, open(specs[1]["model"], "rb") as f1:
        same_model = f0.read() == f1.read()
    want_bytes = comm_bytes_from_shapes(MAIN_PARAMS["max_depth"], N_FEATURES,
                                        MAIN_PARAMS["max_bin"] + 1)
    planned = round_comm_plan("depthwise", MAIN_PARAMS["max_depth"], 0, N_FEATURES,
                              MAIN_PARAMS["max_bin"] + 1, 2, "psum", True)[1]
    for r in res:
        reduced = r["bytes_per_round"].get("hist", 0) + r["bytes_per_round"].get("totals", 0)
        print("{} | two ranks 17a: rank {} ({:,} rows, {} on {}): {:.3f} rounds/s over "
              "rounds 2-9 (setup {:.1f} s); launches a round {}; host syncs in round {}: {} "
              "(sync debug mode), with {} {} collectives on {} tensors that round (on CUDA "
              "each waits for the device on the host); bytes reduced a round {:,} (hist {:,}, "
              "totals {:,}; from the shapes {:,}; round_comm_plan {:,}); other collective "
              "bytes a round {}; {:.1f} collectives and {:.3f} ms in them a round (host "
              "clock)".format(
                  tag, r["rank"], r["rows"], r["backend"], DEVICE, r["rounds_per_s"],
                  r["setup_s"], json.dumps(r["launches_per_round"]), DIST_SYNC_ROUND + 1,
                  r["host_syncs_round"], r["sync_round_collectives"], r["backend"], DEVICE,
                  int(reduced), int(r["bytes_per_round"].get("hist", 0)),
                  int(r["bytes_per_round"].get("totals", 0)), want_bytes, planned,
                  json.dumps({k: v for k, v in r["bytes_per_round"].items()
                              if k not in ("hist", "totals")}),
                  r["collective_calls_per_round"], r["collective_ms_per_round"]), flush=True)
        check(r["launches_per_round"]["hist_kernel"] == 8
              and r["launches_per_round"]["totals_kernel"] == 1,
              "17a: rank {} launches a round {}".format(r["rank"], r["launches_per_round"]))
        check(reduced == want_bytes == planned,
              "17a: rank {} reduced {} bytes a round, the shapes give {}".format(
                  r["rank"], reduced, want_bytes))
    ll = res[0]["logloss"]
    print("{} | two ranks 17a: validation logloss {} (rank 1 {}); one rank on all rows "
          "{}; last-round difference {:.3e}; models byte-equal: {}".format(
              tag, [round(v, 6) for v in ll], "the same" if res[1]["logloss"] == ll else
              res[1]["logloss"], [round(v, 6) for v in single], abs(ll[-1] - single[-1]),
              same_model), flush=True)
    check(same_model, "17a: the two ranks saved different models")
    check(res[1]["logloss"] == ll, "17a: the ranks printed different metrics")
    check(len(ll) == DIST_ROUNDS and all(b < a for a, b in zip(ll, ll[1:])),
          "17a: validation logloss did not fall every round: {}".format(ll))
    check(abs(ll[-1] - single[-1]) <= ENTRY_METRIC_TOL,
          "17a: two ranks' logloss {} vs one rank's {}".format(ll[-1], single[-1]))


def _dist_entry_hosts(tmp, name, hp, extra, split=None):
    """The SageMaker trees and env of two hosts of one box: each with its
    half of phase 8's channels (or host 0 the first ``split`` = (training,
    validation) rows), its own model and output dirs, and the ports of the
    planes (abort ports distinct: both listen on one box)."""
    X, y = make_data(ENTRY_TRAIN_ROWS + ENTRY_VAL_ROWS, N_FEATURES, seed=ENTRY_SEED)
    X[np.random.RandomState(ENTRY_SEED + 1).rand(*X.shape) < ENTRY_MISSING] = np.nan
    n, nv = ENTRY_TRAIN_ROWS, ENTRY_VAL_ROWS
    h, hv = split or (n // 2, nv // 2)
    ports = {"SM_RENDEZVOUS_PORT": free_port(), "SM_PROCESS_GROUP_PORT": free_port(),
             "SM_HEARTBEAT_PORT": free_port(), "SM_FLEET_TRACE_PORT": free_port(),
             "SM_STATUS_PORT": free_port()}
    envs = []
    for rank in range(2):
        root = os.path.join(tmp, "{}-host{}".format(name, rank))
        t = slice(0, h) if rank == 0 else slice(h, n)
        v = slice(n, n + hv) if rank == 0 else slice(n + hv, n + nv)
        _write_csv_channel(os.path.join(root, "train"), X[t], y[t])
        _write_csv_channel(os.path.join(root, "validation"), X[v], y[v])
        channel = {"ContentType": "csv", "TrainingInputMode": "File",
                   "S3DistributionType": "FullyReplicated"}
        for fname, doc in (("hp.json", hp), ("data.json", {"train": channel,
                                                             "validation": dict(channel)})):
            with open(os.path.join(root, fname), "w") as f:
                json.dump(doc, f)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
        env.update({k: str(v) for k, v in ports.items()})
        env.update({
            "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
            "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(root, "hp.json"),
            "SM_INPUT_DATA_CONFIG_FILE": os.path.join(root, "data.json"),
            "SM_CHECKPOINT_CONFIG_FILE": os.path.join(root, "none.json"),
            "SM_CHANNEL_TRAIN": os.path.join(root, "train"),
            "SM_CHANNEL_VALIDATION": os.path.join(root, "validation"),
            "SM_MODEL_DIR": os.path.join(root, "model"),
            "SM_OUTPUT_DIR": os.path.join(root, "output"),
            "SM_OUTPUT_DATA_DIR": os.path.join(root, "output", "data"),
            "SM_HOSTS": json.dumps(DIST_HOSTS), "SM_CURRENT_HOST": DIST_HOSTS[rank],
            "SM_ABORT_PORT": str(free_port()),
            "SM_PROCESS_GROUP_BACKEND": "gloo",
            "GRAFT_HEARTBEAT_TIMEOUT_S": str(DIST_PG_TIMEOUT_S),
        })
        env.update(extra[rank])
        envs.append((env, root))
    return envs


class _Child:
    """A child process, in a session of its own so that ``kill`` reaches
    what it starts, whose stdout lines are collected by a thread (each with
    the host clock at its arrival), with an event set at its first HPO
    metric line and the time its output ended."""

    def __init__(self, command, env):
        self.started_at = time.perf_counter()
        self.proc = subprocess.Popen(command, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, start_new_session=True)
        self.lines, self.stamps, self.err = [], [], []
        self.first_metric = threading.Event()
        self.ended_at = None
        self._threads = [threading.Thread(target=self._read, daemon=True),
                         threading.Thread(target=lambda: self.err.extend(self.proc.stderr),
                                          daemon=True)]
        for th in self._threads:
            th.start()

    def _read(self):
        for line in self.proc.stdout:
            self.stamps.append(time.perf_counter())
            self.lines.append(line)
            if HPO_LINE.match(line):
                self.first_metric.set()
        self.ended_at = time.perf_counter()

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)

    def wait(self, timeout):
        try:
            self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.kill()
                self.proc.wait(timeout=10)
            for th in self._threads:
                th.join(10)
        return self.proc.returncode

    @property
    def out(self):
        return "".join(self.lines)


def run_two_hosts(tag, tmp):
    """17b: the train entry point on two hosts."""
    extra = [{"SM_TRACE": "true", "SM_FLEET_TRACE": "true", "SM_FLEET_FLUSH_S": "0.5"}] * 2
    envs = _dist_entry_hosts(tmp, "entry", DIST_ENTRY_HP, extra)
    t = time.perf_counter()
    children = [_Child(DIST_ENTRY_COMMAND, env) for env, _root in envs]
    try:
        _two_hosts(tag, envs, children, t)
    finally:
        for c in children:
            c.kill()


def _two_hosts(tag, envs, children, t):
    status = None
    check(children[0].first_metric.wait(300), "17b: rank 0 printed no metric line: {}".format(
        "".join(children[0].err)[-3000:]))
    port = envs[0][0]["SM_STATUS_PORT"]
    deadline = time.monotonic() + 30
    while status is None and time.monotonic() < deadline:
        try:
            with urllib.request.urlopen("http://127.0.0.1:{}/status".format(port),
                                        timeout=5) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
            if doc.get("round", {}).get("round", -1) >= 0:
                status = doc
        except (OSError, ValueError):
            time.sleep(0.05)
    children[1].proc.send_signal(signal.SIGQUIT)
    dump = os.path.join(envs[1][1], "model", "fleet-status-rank1.json")
    deadline = time.monotonic() + 30
    while not os.path.exists(dump) and time.monotonic() < deadline and \
            children[1].proc.poll() is None:
        time.sleep(0.05)
    dumped = os.path.exists(dump)
    codes = [c.wait(300) for c in children]
    wall = time.perf_counter() - t
    for rank, (code, c) in enumerate(zip(codes, children)):
        check(code == 0, "17b: host {} exited {}: {}".format(rank, code, "".join(c.err)[-3000:]))
    lines = [[l for l in c.out.splitlines() if HPO_LINE.match(l)] for c in children]
    model = os.path.join(envs[0][1], "model", "xgboost-model")
    with open(os.path.join(envs[0][1], "model", "trace-fleet.json")) as f:
        lanes = sorted({e["pid"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"})
    launches = [_child_launches(c.out) for c in children]
    print("{} | two hosts 17b: both exit 0 in {:.1f} s; {} HPO lines each, identical: {}; "
          "last {!r}; rank 0's model {} bytes, rank 1 wrote none: {}; trace-fleet.json "
          "lanes {}; GET /status mid-run: round {} of {} planned; SIGQUIT dump of rank 1: "
          "{}; launches {}".format(
              tag, wall, len(lines[0]), lines[0] == lines[1], lines[0][-1] if lines[0] else None,
              os.path.getsize(model) if os.path.exists(model) else 0,
              not os.path.exists(os.path.join(envs[1][1], "model", "xgboost-model")), lanes,
              status and status["round"]["round"], status and status.get("rounds_planned"),
              dumped, json.dumps(launches)), flush=True)
    check(len(lines[0]) == DIST_ENTRY_ROUNDS and lines[0] == lines[1],
          "17b: the hosts printed different HPO lines")
    check(os.path.exists(model), "17b: rank 0 wrote no model")
    check(lanes == [0, 1], "17b: trace-fleet.json has lanes {}".format(lanes))
    check(status is not None, "17b: GET /status never answered with a round")
    check(dumped, "17b: SIGQUIT wrote no dump")
    check(all(l and l["hist_kernel"] == 8 * DIST_ENTRY_ROUNDS for l in launches),
          "17b: launches {}".format(launches))


def run_host_loss(tag, tmp):
    """17c: rank 1 killed at its third round end; rank 0 must exit 80."""
    common = {"SM_ABORT_ON_STALE": "true", "SM_HEARTBEAT_INTERVAL_S": str(DIST_HEARTBEAT_S),
              "SM_STRUCTURED_METRICS": "true"}
    envs = _dist_entry_hosts(tmp, "loss", DIST_ENTRY_HP, [
        dict(common), dict(common, SM_FAULT_SPEC="training.round_end:kill@{}".format(
            DIST_KILL_ROUND))])
    children = [_Child(ENTRY_COMMAND, env) for env, _root in envs]
    try:
        _host_loss(tag, envs, children)
    finally:
        for c in children:
            c.kill()


def _host_loss(tag, envs, children):
    code1 = children[1].wait(300)
    dead_at = time.perf_counter()
    code0 = children[0].wait(DIST_PG_TIMEOUT_S + 60)
    after = time.perf_counter() - dead_at
    out0 = children[0].out
    aborts = [json.loads(l) for l in out0.splitlines() if l.startswith('{"metric": "training.abort"')]
    model = os.path.join(envs[0][1], "model", "xgboost-model")
    lines = [l for l in out0.splitlines() if HPO_LINE.match(l)]
    print("{} | host loss 17c: rank 1 exit {} at round {}; rank 0 exit {} {:.2f} s after "
          "(heartbeat every {} s, GRAFT_HEARTBEAT_TIMEOUT_S {} s, the collectives' timeout "
          "SM_COLLECTIVE_TIMEOUT_S's default); training.abort records {} "
          "({}); rank 0 printed {} of {} rounds; model written: {}".format(
              tag, code1, DIST_KILL_ROUND, code0, after, DIST_HEARTBEAT_S, DIST_PG_TIMEOUT_S,
              len(aborts), aborts[0].get("reason") if aborts else None, len(lines),
              DIST_ENTRY_ROUNDS, os.path.exists(model)), flush=True)
    check(code1 == -signal.SIGKILL, "17c: rank 1 exited {}".format(code1))
    check(code0 == 80, "17c: rank 0 exited {}: {}".format(code0, "".join(children[0].err)[-3000:]))
    check(after <= DIST_PG_TIMEOUT_S + 30, "17c: rank 0 took {:.1f} s".format(after))
    check(len(aborts) == 1, "17c: {} training.abort records".format(len(aborts)))
    check(not os.path.exists(model), "17c: rank 0 wrote a model")



# ---------------------------------------------------------------- phase 18

# 18a-18d: the options that train across ranks, each on two gloo ranks on
# the card (phase 17a's harness, one child process pair for all of them),
# against one rank on all rows: a last-round validation metric within
# OPTION_TOL x max(1, |metric|), the two ranks' models byte-equal and their
# metric lines identical
OPTION_TOL = 2e-3
APPROX_DIST_PARAMS = dict(MAIN_PARAMS, tree_method="approx")
OPTION_ROUNDS = {"approx": 6, "dart": 6, "gblinear": 10, "update": 10, "ndcg": 5, "cox": 6}
# 18c: phase 10a's MSLR-shaped queries, whole queries to each rank
RANK_DIST_SPLIT, RANK_DIST_VAL_SPLIT = RANK_QUERIES // 2, RANK_VAL_QUERIES // 2
# 18d: survival:cox on 200k x 28 rows split unevenly, with 20k validation
# rows (split unevenly too); a third of the labels censored
COX_PARAMS = {"objective": "survival:cox", "max_depth": 8, "max_bin": 256, "eta": 0.2,
              "tree_method": "hist", "eval_metric": ["cox-nloglik"]}
COX_ROWS, COX_VAL, COX_SPLIT, COX_VAL_SPLIT = 200_000, 20_000, 120_007, 11_003
# 18e: k-fold CV through the entry point on two hosts (phase 17b's trees)
KFOLD_DIST_HP = dict(DIST_ENTRY_HP, num_round="10", _kfold="3")
KFOLD_DIST_ROUNDS = 10
# 18f: rank 1 reaches its first collective SLOW_PEER_S late, past the
# heartbeat timeout, while its heartbeat thread beats every second
SLOW_PEER_S, SLOW_HEARTBEAT_TIMEOUT_S, SLOW_HEARTBEAT_S = 12.0, 5.0, 1.0
# the sizes the rank children take from their spec (a rehearsal on the CPU
# sets them small in the parent)
OPTION_SIZES = ("N_TRAIN", "N_VAL", "DIST_SPLIT", "RANK_QUERIES", "RANK_VAL_QUERIES",
                "RANK_FEATURES", "RANK_DIST_SPLIT", "RANK_DIST_VAL_SPLIT", "COX_ROWS", "COX_VAL",
                "COX_SPLIT", "COX_VAL_SPLIT")


def make_cox(n, d, seed):
    """Survival rows: the main path's features, event times from an
    exponential whose rate follows a few of them, a third censored (the
    label's sign, xgboost's convention)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    risk = 0.8 * X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + np.sin(X[:, 3])
    t = (rng.exponential(np.exp(-risk)) * 100 + 1).astype(np.float32)
    return X, np.where(rng.rand(n) < 1 / 3, -t, t).astype(np.float32)


def option_data(case, rank=None):
    """(train (X, y, groups), validation (X, y, groups)) of an option case:
    all rows (``rank`` None) or that rank's share."""
    if case == "ndcg":
        X, y, sizes = make_ranking(RANK_QUERIES, RANK_FEATURES, seed=0)
        Xv, yv, sizes_v = make_ranking(RANK_VAL_QUERIES, RANK_FEATURES, seed=1)
        parts = []
        for A, b, s, q in ((X, y, sizes, RANK_DIST_SPLIT), (Xv, yv, sizes_v, RANK_DIST_VAL_SPLIT)):
            if rank is None:
                parts.append((A, b, s))
                continue
            cut = int(s[:q].sum())
            rows = slice(0, cut) if rank == 0 else slice(cut, None)
            parts.append((A[rows], b[rows], s[:q] if rank == 0 else s[q:]))
        return parts
    if case == "cox":
        X, y = make_cox(COX_ROWS + COX_VAL, N_FEATURES, seed=18)
        n, split, vsplit = COX_ROWS, COX_SPLIT, COX_ROWS + COX_VAL_SPLIT
    else:
        X, y = make_data(N_TRAIN + N_VAL, N_FEATURES, seed=0)
        n, split, vsplit = N_TRAIN, DIST_SPLIT, N_TRAIN + N_VAL // 2
        if case == "update":
            y = y.copy()
            flip = np.random.RandomState(15).rand(len(y)) < UPDATE_FLIP
            y[flip] = 1.0 - y[flip]
    if rank is None:
        return (X[:n], y[:n], None), (X[n:], y[n:], None)
    t = slice(0, split) if rank == 0 else slice(split, n)
    v = slice(n, vsplit) if rank == 0 else slice(vsplit, len(y))
    return (X[t], y[t], None), (X[v], y[v], None)


OPTION_PARAMS = {"approx": APPROX_DIST_PARAMS, "dart": DART_PARAMS,
                 "gblinear": GBLINEAR_PARAMS, "update": UPDATE_PARAMS, "ndcg": RANK_PARAMS,
                 "cox": COX_PARAMS}
OPTION_METRIC = {"approx": "logloss", "dart": "logloss", "gblinear": "logloss",
                 "update": "logloss", "ndcg": "ndcg@10", "cox": "cox-nloglik"}


def _train_option(torch, case, train, val, device, group=None, xgb_model=None):
    """Train option case ``case`` -> what it measured: rounds/s over rounds
    2 to the last, launches, collectives and bytes a round by kind, the
    approx re-sketch's ms a round (CUDA-synchronized around it), the
    validation log and the saved model's sha256."""
    import hashlib

    import sagemaker_xgboost_container_tpu_torch as pkg
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.models import booster
    from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist
    from sagemaker_xgboost_container_tpu_torch.parallel import collectives

    cuda = torch.device(device).type == "cuda"
    marks, launches, comm, sketch = [], [], [], []

    def mark():
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        launches.append(dict(hist.LAUNCHES))
        comm.append({"calls": collectives.STATS["calls"],
                     "seconds": collectives.STATS["seconds"],
                     "kinds": dict(collectives.STATS["kinds"])})

    class Meter:
        def before_training(self, model):
            mark()
            return model

        def after_iteration(self, model, rnd, evals_log):
            mark()
            self.log = list(evals_log["validation"][OPTION_METRIC[case]])
            return False

    resketch = booster._TrainingSession._resketch_bins

    def timed_resketch(session):
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        resketch(session)
        if cuda:
            torch.cuda.synchronize()
        sketch.append(time.perf_counter() - t)

    meter = Meter()
    hist.reset_launch_counts()
    collectives.reset_stats()
    booster._TrainingSession._resketch_bins = timed_resketch
    try:
        model = pkg.train(OPTION_PARAMS[case], DataMatrix(*train[:2], groups=train[2]),
                          OPTION_ROUNDS[case], evals=[(DataMatrix(*val[:2], groups=val[2]),
                                                       "validation")],
                          device=device, group=group, callbacks=[meter], verbose_eval=False,
                          xgb_model=xgb_model)
    finally:
        booster._TrainingSession._resketch_bins = resketch
    with tempfile.TemporaryDirectory(prefix="chip_smoke_option_") as tmp:
        path = os.path.join(tmp, "model.json")
        model.save_model(path)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    rounds = len(marks) - 1
    per = rounds - 1
    last = comm[-1]
    return {
        "rounds_per_s": per / (marks[-1] - marks[1]),
        "launches_per_round": {k: (launches[-1][k] - launches[0][k]) / rounds
                               for k in launches[-1]},
        "collective_calls_per_round": (last["calls"] - comm[1]["calls"]) / per,
        "collective_ms_per_round": (last["seconds"] - comm[1]["seconds"]) * 1e3 / per,
        "bytes_per_round": {k: (v - comm[1]["kinds"].get(k, 0)) / per
                            for k, v in last["kinds"].items()},
        "resketch_ms": [s * 1e3 for s in sketch],
        "log": meter.log, "digest": digest, "rounds": rounds,
    }


def option_rank_child(spec):
    """`chip_smoke.py --rank-child SPEC` for phase 18: one rank of the
    option cases, in one process group with the heartbeat plane up; first
    the slow-peer drill (18f: rank 1 sleeps before the first collective),
    then each case in ``spec["cases"]`` on this rank's rows."""
    import torch

    from sagemaker_xgboost_container_tpu_torch.parallel import collectives, distributed
    from sagemaker_xgboost_container_tpu_torch.telemetry import cluster

    rank, device = spec["rank"], torch.device(spec["device"])
    globals().update(spec["sizes"])
    group = distributed.init_process_group(DIST_HOSTS, DIST_HOSTS[rank], device,
                                           backend="gloo", port=spec["port"])
    plane = cluster.start_cluster_telemetry(DIST_HOSTS, DIST_HOSTS[rank])
    result = {"rank": rank, "collective_timeout_s": distributed.process_group_timeout()}
    sent = plane.sender._m_sent
    before = sent.value
    t = time.perf_counter()
    if rank == 1:
        time.sleep(spec["slow_s"])
    collectives.host_all_gather(np.asarray([rank], np.int64), group, device)
    result["first_collective_s"] = time.perf_counter() - t
    result["beats_before_it"] = sent.value - before
    for case in spec["cases"]:
        train, val = option_data(case, rank)
        result[case] = _train_option(torch, case, train, val, device, group=group,
                                     xgb_model=spec["base"] if case == "update" else None)
    cluster.stop_cluster_telemetry()
    distributed.destroy_process_group()
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


def run_options(torch, hist, pkg, tag):
    """Phase 18: the options that train across ranks (see the module
    docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as tmp:
        run_option_ranks(torch, pkg, tag, tmp)
        run_kfold_hosts(tag, tmp)
    print("{} | options across ranks phase: {:.1f} s".format(tag, time.perf_counter() - t),
          flush=True)


def run_option_ranks(torch, pkg, tag, tmp):
    """18a-18d and 18f: one rank on all rows, then the two-rank child pair."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix

    # the 10-round hist model that 18b's update refreshes and prunes
    base = os.path.join(tmp, "base.json")
    (X, y, _g), (Xv, yv, _gv) = option_data("approx")
    pkg.train(MAIN_PARAMS, DataMatrix(X, y), OPTION_ROUNDS["update"], device=DEVICE,
              verbose_eval=False).save_model(base)
    cases = list(OPTION_ROUNDS)
    single = {}
    t = time.perf_counter()
    for case in cases:
        train, val = option_data(case)
        single[case] = _train_option(torch, case, train, val, DEVICE,
                                     xgb_model=base if case == "update" else None)
    single_s = time.perf_counter() - t
    port, hb_port = free_port(), free_port()
    env = dict(os.environ, GRAFT_HEARTBEAT_TIMEOUT_S=str(SLOW_HEARTBEAT_TIMEOUT_S),
               SM_HEARTBEAT_INTERVAL_S=str(SLOW_HEARTBEAT_S), SM_HEARTBEAT_PORT=str(hb_port))
    env.pop("SM_COLLECTIVE_TIMEOUT_S", None)
    procs, specs = [], []
    t = time.perf_counter()
    for rank in range(2):
        spec = {"phase": 18, "rank": rank, "port": port, "device": DEVICE, "cases": cases,
                "base": base, "slow_s": SLOW_PEER_S,
                "sizes": {k: globals()[k] for k in OPTION_SIZES},
                "out": os.path.join(tmp, "option-rank{}.json".format(rank))}
        specs.append(spec)
        path = os.path.join(tmp, "option-spec{}.json".format(rank))
        with open(path, "w") as f:
            json.dump(spec, f)
        procs.append(subprocess.Popen(DIST_CHILD_COMMAND + [path], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    pair_s = time.perf_counter() - t
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, "18: rank {} exited {}: {}".format(rank, p.returncode,
                                                                    out[-3000:]))
    res = []
    for spec in specs:
        with open(spec["out"]) as f:
            res.append(json.load(f))
    print("{} | options 18: one rank on all rows, {} cases, {:.1f} s; the two-rank child "
          "pair {:.1f} s".format(tag, len(cases), single_s, pair_s), flush=True)
    # 18f
    r0, r1 = res
    print("{} | slow peer 18f: GRAFT_HEARTBEAT_TIMEOUT_S={} and SM_COLLECTIVE_TIMEOUT_S unset "
          "(the process group's timeout {} s); rank 1 slept {} s before the first collective "
          "and sent {} heartbeats meanwhile (every {} s); rank 0 waited {:.2f} s in it; both "
          "ranks exit 0".format(tag, SLOW_HEARTBEAT_TIMEOUT_S, r0["collective_timeout_s"],
                                SLOW_PEER_S, r1["beats_before_it"], SLOW_HEARTBEAT_S,
                                r0["first_collective_s"]), flush=True)
    check(r0["first_collective_s"] > SLOW_HEARTBEAT_TIMEOUT_S,
          "18f: rank 0 did not wait past the heartbeat timeout")
    check(r1["beats_before_it"] >= SLOW_PEER_S / SLOW_HEARTBEAT_S / 2,
          "18f: rank 1 sent {} heartbeats while it slept".format(r1["beats_before_it"]))
    labels = {"approx": "18a approx", "dart": "18b dart", "gblinear": "18b gblinear",
              "update": "18b update", "ndcg": "18c rank:ndcg", "cox": "18d survival:cox"}
    for case in cases:
        a, b, one = r0[case], r1[case], single[case]
        metric = OPTION_METRIC[case]
        diff = abs(a["log"][-1] - one["log"][-1])
        for r in (a, b):
            print("{} | {} rank: {:.3f} rounds/s over rounds 2-{}; launches a round {}; {:.1f} "
                  "collectives and {:.3f} ms in them a round (host clock); bytes a round by "
                  "kind {}{}".format(
                      tag, labels[case], r["rounds_per_s"], r["rounds"],
                      json.dumps(r["launches_per_round"]), r["collective_calls_per_round"],
                      r["collective_ms_per_round"], json.dumps(r["bytes_per_round"]),
                      "; re-sketch + cut gather {:.3f} ms a round (mean of rounds 2-{})".format(
                          float(np.mean(r["resketch_ms"][1:])), r["rounds"])
                      if r["resketch_ms"] else ""), flush=True)
        print("{} | {}: validation {} {} (rank 1 {}); one rank on all rows {} ({:.3f} "
              "rounds/s{}); last-round difference {:.3e}; models byte-equal: {}".format(
                  tag, labels[case], metric, [round(v, 6) for v in a["log"]],
                  "the same" if b["log"] == a["log"] else b["log"],
                  [round(v, 6) for v in one["log"]], one["rounds_per_s"],
                  ", re-sketch {:.3f} ms a round".format(float(np.mean(one["resketch_ms"][1:])))
                  if one["resketch_ms"] else "", diff, a["digest"] == b["digest"]), flush=True)
        check(a["digest"] == b["digest"], "{}: the two ranks saved different models".format(
            labels[case]))
        check(a["log"] == b["log"], "{}: the ranks printed different metrics".format(
            labels[case]))
        check(len(a["log"]) == OPTION_ROUNDS[case] and np.all(np.isfinite(a["log"])),
              "{}: metric log {}".format(labels[case], a["log"]))
        check(diff <= OPTION_TOL * max(1.0, abs(one["log"][-1])),
              "{}: {} {} against one rank's {}".format(labels[case], metric, a["log"][-1],
                                                       one["log"][-1]))
        kernels = case not in ("gblinear", "update")
        for r in (a, b):
            want = ({"hist_kernel": 8, "totals_kernel": 1} if kernels
                    else {"hist_kernel": 0, "totals_kernel": 0})
            check(all(r["launches_per_round"].get(k, 0) == v for k, v in want.items()),
                  "{}: launches a round {}".format(labels[case], r["launches_per_round"]))
        if case == "approx":
            check(all(r["bytes_per_round"].get("cuts", 0) > 0 for r in (a, b)),
                  "18a: no cut gather a round")
        if case == "cox":
            check(all(r["bytes_per_round"].get("rows", 0) > 0 for r in (a, b)),
                  "18d: no global-row gather a round")


def run_kfold_hosts(tag, tmp):
    """18e: `_kfold=3` through the entry point on two hosts."""
    envs = _dist_entry_hosts(tmp, "kfold", KFOLD_DIST_HP, [{}, {}])
    t = time.perf_counter()
    children = [_Child(DIST_ENTRY_COMMAND, env) for env, _root in envs]
    try:
        codes = [c.wait(400) for c in children]
    finally:
        for c in children:
            c.kill()
    wall = time.perf_counter() - t
    for rank, (code, c) in enumerate(zip(codes, children)):
        check(code == 0, "18e: host {} exited {}: {}".format(rank, code, "".join(c.err)[-3000:]))
    lines = [[l for l in c.out.splitlines() if HPO_LINE.match(l)] for c in children]
    rows, preds = [], []
    for rank, (_env, root) in enumerate(envs):
        path = os.path.join(root, "output", "data", "predictions.csv")
        check(os.path.exists(path), "18e: host {} wrote no out-of-fold file".format(rank))
        preds.append(np.loadtxt(path, delimiter=","))
        n, nv = ENTRY_TRAIN_ROWS, ENTRY_VAL_ROWS
        rows.append(n // 2 + nv // 2 if rank == 0 else n - n // 2 + nv - nv // 2)
    models = sorted(f for f in os.listdir(os.path.join(envs[0][1], "model"))
                    if f.startswith("xgboost-model") and not f.endswith(".manifest"))
    launches = [_child_launches(c.out) for c in children]
    print("{} | k-fold 18e: _kfold=3 on two hosts, {} rounds a fold: both exit 0 in {:.1f} s; "
          "{} HPO lines each, identical: {}; CV line {!r}; out-of-fold rows {} (want {}); rank "
          "0's models {}; launches {}".format(
              tag, KFOLD_DIST_ROUNDS, wall, len(lines[0]), lines[0] == lines[1],
              lines[0][-1] if lines[0] else None, [len(p) for p in preds], rows, models,
              json.dumps(launches)), flush=True)
    check(lines[0] == lines[1] and len(lines[0]) == 3 * KFOLD_DIST_ROUNDS + 1,
          "18e: the hosts printed different metric lines")
    check([len(p) for p in preds] == rows and all(np.all(np.isfinite(p)) for p in preds),
          "18e: out-of-fold rows {}".format([len(p) for p in preds]))
    check(models == ["xgboost-model-{}".format(k) for k in range(3)],
          "18e: rank 0's models {}".format(models))
    check(all(l and l["hist_kernel"] == 8 * 3 * KFOLD_DIST_ROUNDS for l in launches),
          "18e: launches {}".format(launches))



# phase 19: streaming (chunked) ingest through the train entry point.
# 19a: the main path's rows rounded to EXACT_GRID (at most 3,905 distinct
# values a feature, so the ingest's sketch stays exact and its cuts are the
# whole-file reader's bit for bit) as csv channels of N_TRAIN + N_VAL rows,
# each value written "%+.9f" (every multiple of 2^-9 exactly), trained 5
# rounds with SM_INGEST_MODE=whole and with auto at 16 MiB chunks
STREAM_HP = {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
             "tree_method": "hist", "eta": "0.2", "num_round": "5", "eval_metric": "logloss"}
STREAM_ROUNDS = 5
STREAM_CHUNK_BYTES = 16 << 20
STREAM_DEFAULT_CHUNK_BYTES = 64 << 20   # SM_INGEST_CHUNK_BYTES' default
# 19b / 19c: phase 8's 200k + 50k channels in 4 MiB chunks; the drills with
# a corrupt file beside the training file; two hosts split unevenly, as
# ShardedByS3Key splits a channel
STREAM_DRILL_CHUNK_BYTES = 4 << 20
STREAM_HOST_SPLIT = (120_007, 30_001)   # host 0's training and validation rows
STREAM_CORRUPT = "1.0,junk,2.0\n0.0\n1.0,2.0,3.0,4.0,5.0,6.0,7.0,8.0,9.0\n"
STREAM_REFUSAL = ("SM_INGEST_MODE=chunked is not supported for this job (tree_method=approx "
                  "re-sketches from float features)")


def write_grid_csv(path, X, y):
    """A csv channel of rows on the EXACT_GRID (|value| < 10), written
    vectorized: each value "%+.9f" (12 bytes, exact), the label one digit.
    -> bytes written."""
    k = np.rint(X / EXACT_GRID).astype(np.int64)
    lo, hi = int(k.min()), int(k.max())
    table = np.frombuffer(b"".join(("%+.9f" % (v * EXACT_GRID)).encode()
                                   for v in range(lo, hi + 1)), np.uint8).reshape(-1, 12)
    n, d = X.shape
    out = np.empty((n, 13 * d + 2), np.uint8)
    out[:, 0] = ord("0") + y.astype(np.uint8)
    body = out[:, 1:13 * d + 1].reshape(n, d, 13)
    body[:, :, 0] = ord(",")
    body[:, :, 1:] = table[k - lo]
    out[:, -1] = ord("\n")
    os.makedirs(path)
    with open(os.path.join(path, "data.csv"), "wb") as f:
        f.write(out.tobytes())
    return out.size


# runs a command, reaps it with os.wait4, prints its peak RSS and exits
# with its code
WAIT4_LAUNCHER = (
    "import json, os, sys\n"
    "pid = os.posix_spawn(sys.argv[1], sys.argv[1:], os.environ)\n"
    "_, status, usage = os.wait4(pid, 0)\n"
    "print(json.dumps({'wait4': {'maxrss_kb': usage.ru_maxrss}}), flush=True)\n"
    "code = os.waitstatus_to_exitcode(status)\n"
    "sys.exit(code if code >= 0 else 128 - code)\n")


def _wait4_child(command, env):
    """``command`` as a ``_Child`` under WAIT4_LAUNCHER, for its peak RSS: a
    process's ru_maxrss starts from the high-water mark of the process that
    spawned it (fork or vfork, then exec), which here is this process,
    several GiB by phase 19."""
    return _Child([sys.executable, "-c", WAIT4_LAUNCHER] + list(command), env)


def _maxrss_mb(out):
    found = [json.loads(line)["wait4"] for line in out.splitlines()
             if line.startswith('{"wait4"')]
    return found[-1]["maxrss_kb"] / 1024.0 if found else float("nan")


def _wait_all(children, timeout):
    """{name: _Child} -> {name: exit code}; every child is killed when the
    first wait fails."""
    try:
        return {name: c.wait(timeout) for name, c in children.items()}
    finally:
        for c in children.values():
            c.kill()


def _ingest_report(out):
    found = [json.loads(line)["ingest"] for line in out.splitlines()
             if line.startswith('{"ingest"')]
    return found[-1] if found else None


def _phase_seconds(out, name):
    return sum(r["seconds"] for r in _records(out, "training.phase") if r["phase"] == name)


def _rounds_per_s(out):
    """Rounds/s over rounds 1.. of the child's `training.round` records."""
    ms = [r["round_ms"] for r in _records(out, "training.round")][1:]
    return len(ms) / (sum(ms) / 1000.0) if ms else float("nan")


def _last_metric(out, key):
    lines = _metric_lines(out)
    return lines[max(lines)][key] if lines else float("nan")


def run_streaming(torch, hist, tag):
    """Phase 19: streaming ingest through the train entry point (see the
    module docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        _stream_main(tag, tmp)
        _stream_drills(tag, tmp)
    print("{} | streaming phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _stream_main(tag, tmp):
    """19a: whole against auto on the main path's rows."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    X, y = exact_rows()
    t = time.perf_counter()
    train_dir, val_dir = os.path.join(tmp, "main", "train"), os.path.join(tmp, "main", "val")
    size = write_grid_csv(train_dir, X[:N_TRAIN], y[:N_TRAIN])
    write_grid_csv(val_dir, X[N_TRAIN:], y[N_TRAIN:])
    wrote = time.perf_counter() - t
    check(size > STREAM_DEFAULT_CHUNK_BYTES, "19a: the channel is {} bytes".format(size))
    conf = os.path.join(tmp, "main", "config")
    os.makedirs(conf)
    channel = {"ContentType": "csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    for name, doc in (("hp.json", STREAM_HP),
                      ("data.json", {"train": channel, "validation": dict(channel)})):
        with open(os.path.join(conf, name), "w") as f:
            json.dump(doc, f)
    children = {}
    for mode in ("whole", "auto"):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
        env.update({
            "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
            "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(conf, "hp.json"),
            "SM_INPUT_DATA_CONFIG_FILE": os.path.join(conf, "data.json"),
            "SM_CHECKPOINT_CONFIG_FILE": os.path.join(conf, "none.json"),
            "SM_CHANNEL_TRAIN": train_dir, "SM_CHANNEL_VALIDATION": val_dir,
            "SM_MODEL_DIR": os.path.join(tmp, "main", "model-" + mode),
            "SM_OUTPUT_DIR": os.path.join(tmp, "main", "output-" + mode),
            "SM_HOSTS": '["algo-1"]', "SM_CURRENT_HOST": "algo-1",
            "SM_INGEST_MODE": mode, "SM_INGEST_CHUNK_BYTES": str(STREAM_CHUNK_BYTES),
            "CHIP_SMOKE_INGEST_REPORT": "1"})
        children[mode] = _wait4_child(ENTRY_CHILD_COMMAND, env)
    codes = _wait_all(children, 600)
    reports = {}
    for mode, c in children.items():
        check(codes[mode] == 0, "19a {}: exit {}: {}".format(mode, codes[mode],
                                                             "".join(c.err)[-3000:]))
        reports[mode] = rep = _ingest_report(c.out)
        launches = _child_launches(c.out)
        train_s = _phase_seconds(c.out, "train")
        rounds_s = sum(r["round_ms"] for r in _records(c.out, "training.round")) / 1000.0
        print("{} | streaming 19a {}: exit 0 in {:.1f} s (both children at once); peak RSS "
              "{:.1f} MiB (os.wait4); ingest {:.3f} s ({}; chunks {}); train span {:.3f} s, "
              "of it {:.3f} s before the first round (binning, upload); {:.3f} rounds/s over "
              "rounds 1-{}; launches {}; validation logloss {}".format(
                  tag, mode, c.ended_at - c.started_at, _maxrss_mb(c.out),
                  _phase_seconds(c.out, "data_ingest"),
                  rep and rep.get("kind"), rep and json.dumps(rep["chunks"]), train_s,
                  train_s - rounds_s, _rounds_per_s(c.out), STREAM_ROUNDS - 1,
                  json.dumps(launches), round(_last_metric(c.out, "validation-logloss"), 6)),
              flush=True)
        check(launches == {"hist_kernel": 8 * STREAM_ROUNDS, "totals_kernel": STREAM_ROUNDS},
              "19a {}: launches {}".format(mode, launches))
    whole, auto = reports["whole"], reports["auto"]
    check(whole["kind"] == "floats" and auto["kind"] == "binned",
          "19a: whole ingested {}, auto {}".format(whole["kind"], auto["kind"]))
    check(auto["chunks"].get("train", 0) >= size // STREAM_CHUNK_BYTES,
          "19a: auto read {} training chunks".format(auto["chunks"]))
    paths = [os.path.join(tmp, "main", "model-" + m, "xgboost-model") for m in ("whole", "auto")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        same_bytes = a.read() == b.read()
    same_ingest = all(whole[k] == auto[k] for k in ("cuts", "bins", "eval_bins"))
    models = [Forest.load_model(p, device="cpu") for p in paths]
    cmp = _compare(models[0], models[1], X[:20_000], X[N_TRAIN:N_TRAIN + 10_000])
    lw, la = (_last_metric(children[m].out, "validation-logloss") for m in ("whole", "auto"))
    print("{} | streaming 19a: {:,} + {:,} rows x {} written as {:,} + {:,} bytes of csv in "
          "{:.1f} s; cuts, training bins and validation bins the session got: whole {} / {} / "
          "{}, auto {} / {} / {} (sha256), equal: {}; model files byte-equal: {}; trees {}; "
          "last validation logloss {:.6f} / {:.6f}".format(
              tag, N_TRAIN, N_VAL, N_FEATURES, size, os.path.getsize(os.path.join(
                  val_dir, "data.csv")), wrote, whole["cuts"], whole["bins"],
              whole["eval_bins"], auto["cuts"], auto["bins"], auto["eval_bins"], same_ingest,
              same_bytes, json.dumps(cmp), lw, la), flush=True)
    check(same_ingest, "19a: the chunked ingest differs from the whole-file path's")
    # on the card the histograms add with f32 atomics in a varying order, so
    # two runs of one job on the same bins may differ in a leaf's last bits
    # (phase 8): byte-equal files are reported, the runs held to phase 8's
    # tolerance
    check(same_bytes or (abs(lw - la) <= ENTRY_METRIC_TOL and cmp["mean_dp"] <= ENTRY_DP_TOL),
          "19a: whole and auto models differ beyond phase 8's tolerance: {}".format(cmp))


def _stream_drills(tag, tmp):
    """19b: a corrupt chunk under skip (exit 0, quarantine) and fail (exit
    85), chunked with approx (refused); 19c: two hosts, chunked."""
    from sagemaker_xgboost_container_tpu_torch.utils import integrity

    drill_hp = dict(STREAM_HP, eval_metric="logloss,auc")
    root = os.path.join(tmp, "drills")
    _, _, _, train_dir, _, sm_env = _entry_tree(root, {
        "hyperparameters.json": drill_hp,
        "hyperparameters-approx.json": dict(drill_hp, tree_method="approx")})
    corrupt_dir = os.path.join(root, "data", "train-corrupt")
    os.makedirs(corrupt_dir)
    os.symlink(os.path.join(train_dir, "data.csv"), os.path.join(corrupt_dir, "data.csv"))
    with open(os.path.join(corrupt_dir, "zz-corrupt.csv"), "w") as f:
        f.write(STREAM_CORRUPT)
    chunked = {"SM_INGEST_MODE": "chunked",
               "SM_INGEST_CHUNK_BYTES": str(STREAM_DRILL_CHUNK_BYTES),
               "SM_IO_RETRY_ATTEMPTS": "1", "CHIP_SMOKE_INGEST_REPORT": "1"}
    envs = {}
    for run, action in (("skip", "skip"), ("fail", "fail")):
        env = sm_env(run)
        env.update(chunked, SM_CHANNEL_TRAIN=corrupt_dir, SM_INGEST_BAD_CHUNK_ACTION=action,
                   SM_TRACE="true")
        envs[run] = env
    envs["approx"] = dict(sm_env("approx", "hyperparameters-approx.json"), **chunked)
    hosts = _dist_entry_hosts(
        os.path.join(tmp, "hosts"), "stream", drill_hp,
        [dict(chunked, MODEL_COPY=os.path.join(tmp, "hosts", "copy-{}".format(r)))
         for r in range(2)], split=STREAM_HOST_SPLIT)
    ingest_port = str(free_port())
    for env, _root in hosts:
        env["SM_INGEST_PORT"] = ingest_port
    children = {run: _wait4_child(ENTRY_CHILD_COMMAND, env) for run, env in envs.items()}
    children.update({"host{}".format(r): _wait4_child(ENTRY_CHILD_COMMAND, env)
                     for r, (env, _root) in enumerate(hosts)})
    codes = _wait_all(children, 600)
    for run, c in children.items():
        print("{} | streaming 19{} {}: exit {} in {:.1f} s (five children at once); peak RSS "
              "{:.1f} MiB; ingest {:.3f} s; launches {}; ingest {}".format(
                  tag, "c" if run.startswith("host") else "b", run, codes[run],
                  c.ended_at - c.started_at, _maxrss_mb(c.out),
                  _phase_seconds(c.out, "data_ingest"),
                  json.dumps(_child_launches(c.out)), json.dumps(_ingest_report(c.out))),
              flush=True)

    # 19b skip: exit 0, the corrupt file's chunk quarantined
    c = children["skip"]
    check(codes["skip"] == 0, "19b skip: exit {}: {}".format(codes["skip"],
                                                             "".join(c.err)[-3000:]))
    model_dir = envs["skip"]["SM_MODEL_DIR"]
    qpath = os.path.join(model_dir, "ingest-quarantine.json")
    check(os.path.exists(qpath), "19b skip: no ingest-quarantine.json")
    with open(qpath) as f:
        quarantine = json.load(f)
    manifest = integrity.read_manifest(os.path.join(model_dir, "xgboost-model"))
    check(manifest is not None and manifest.get("quarantine") == quarantine,
          "19b skip: the manifest's quarantine {}".format(manifest and manifest.get("quarantine")))
    check(quarantine["chunks_skipped"] == 1 and quarantine["skipped_chunks"][0][
        "file"].endswith("zz-corrupt.csv"), "19b skip: quarantine {}".format(quarantine))
    check(_child_launches(c.out) == {"hist_kernel": 8 * STREAM_ROUNDS,
                                     "totals_kernel": STREAM_ROUNDS},
          "19b skip: launches {}".format(_child_launches(c.out)))
    print("{} | streaming 19b skip: quarantine {} chunk(s), {} rows, {} bytes ({}: {}); "
          "manifest quarantine equal to ingest-quarantine.json".format(
              tag, quarantine["chunks_skipped"], quarantine["rows_skipped"],
              quarantine["bytes_skipped"],
              os.path.basename(quarantine["skipped_chunks"][0]["file"]),
              quarantine["skipped_chunks"][0]["error"][:80]), flush=True)
    # fail: exit 85, one training.abort, the flight recorder, no model
    c = children["fail"]
    aborts = _records(c.out, "training.abort")
    fail_dir = envs["fail"]["SM_MODEL_DIR"]
    check(codes["fail"] == 85 and len(aborts) == 1 and aborts[0]["reason"] == "ingest_failed"
          and aborts[0]["ingest_reason"] == "bad_chunk",
          "19b fail: exit {}, aborts {}: {}".format(codes["fail"], aborts,
                                                    "".join(c.err)[-2000:]))
    check(not os.path.exists(os.path.join(fail_dir, "xgboost-model")), "19b fail: a model")
    print("{} | streaming 19b fail: exit 85; training.abort {}; flight recorder {}".format(
        tag, aborts[0]["detail"][:120], os.path.exists(os.path.join(
            fail_dir, "flight-recorder-rank0.json"))), flush=True)
    # approx: refused with the JAX package's UserError
    c = children["approx"]
    failure = os.path.join(envs["approx"]["SM_OUTPUT_DIR"], "failure")
    text = open(failure).read() if os.path.exists(failure) else ""
    check(codes["approx"] == 1 and STREAM_REFUSAL in text,
          "19b approx: exit {}: {}".format(codes["approx"], text[-1000:]
                                           or "".join(c.err)[-1000:]))
    print("{} | streaming 19b approx: exit 1: {}".format(tag, text.strip().splitlines()[0][:200]),
          flush=True)

    # 19c: two hosts, chunked
    host = [children["host0"], children["host1"]]
    for r, c in enumerate(host):
        check(codes["host{}".format(r)] == 0, "19c: host {} exited {}: {}".format(
            r, codes["host{}".format(r)], "".join(c.err)[-3000:]))
    reports = [_ingest_report(c.out) for c in host]
    lines = [[l for l in c.out.splitlines() if HPO_LINE.match(l)] for c in host]
    blobs = []
    for path in (os.path.join(hosts[0][1], "model", "xgboost-model"),
                 os.path.join(tmp, "hosts", "copy-0"), os.path.join(tmp, "hosts", "copy-1")):
        with open(path, "rb") as f:
            blobs.append(f.read())
    two = _last_metric(host[0].out, "validation-logloss")
    one = _last_metric(children["skip"].out, "validation-logloss")
    print("{} | streaming 19c: hosts of {:,} / {:,} training and {:,} / {:,} validation rows; "
          "both exit 0; cuts {} / {} (sha256), equal: {}; {} HPO lines each, identical: {}; "
          "models byte-equal (rank 0's file, both ranks' copies): {}; validation logloss "
          "{:.6f} against one host's {:.6f} (19b skip, the same rows): {:.3e}".format(
              tag, STREAM_HOST_SPLIT[0], ENTRY_TRAIN_ROWS - STREAM_HOST_SPLIT[0],
              STREAM_HOST_SPLIT[1], ENTRY_VAL_ROWS - STREAM_HOST_SPLIT[1], reports[0]["cuts"],
              reports[1]["cuts"], reports[0]["cuts"] == reports[1]["cuts"], len(lines[0]),
              lines[0] == lines[1], blobs[0] == blobs[1] == blobs[2], two, one, abs(two - one)),
          flush=True)
    check(all(r["kind"] == "binned" for r in reports), "19c: the hosts did not stream")
    check(reports[0]["cuts"] == reports[1]["cuts"], "19c: the hosts binned with other cuts")
    check(len(lines[0]) == STREAM_ROUNDS and lines[0] == lines[1],
          "19c: the hosts printed different HPO lines")
    check(blobs[0] == blobs[1] == blobs[2], "19c: the hosts' models differ")
    check(abs(two - one) <= OPTION_TOL * max(1.0, abs(one)),
          "19c: validation logloss {} against one host's {}".format(two, one))
    check(all(_child_launches(c.out) == {"hist_kernel": 8 * STREAM_ROUNDS,
                                         "totals_kernel": STREAM_ROUNDS} for c in host),
          "19c: launches {}".format([_child_launches(c.out) for c in host]))


# ---------------------------------------------------------------- phase 20

# the elastic plane and the consensus guard through the train entry point:
# three hosts of one box, each with its third of the main path's rows (the
# 2^-9 grid of phase 19, so the csv is exact), on cuda:0 over gloo
ELASTIC_HOSTS = ["127.0.0.1", "127.0.0.2", "localhost"]   # sorted: rank 0, 1, 2
ELASTIC_ROUNDS, ELASTIC_KILL_AT = 12, 5   # rank 2 dies at its 5th round end
ELASTIC_HP = {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
              "tree_method": "hist", "eta": "0.2", "num_round": str(ELASTIC_ROUNDS),
              "eval_metric": "logloss"}
# heartbeats every 0.5 s, a host stale after 6 missed (3 s, 17c's threshold)
ELASTIC_PLANES = {"SM_HEARTBEAT_INTERVAL_S": "0.5", "SM_STALE_HEARTBEATS": "6",
                  "SM_STRUCTURED_METRICS": "true", "SM_PROCESS_GROUP_BACKEND": "gloo",
                  "SM_CONSENSUS_EVERY": "1"}
ELASTIC_LOGLOSS_TOL = 1e-2
ELASTIC_TREE_KEYS = ("feature", "threshold", "default_left", "left", "right", "value")


# phase 20's channels and 20a's last validation logloss, kept for phase 22
ELASTIC_KEPT = {}


def run_elastic(torch, hist, tag):
    """Phase 20: the elastic shrink and the consensus guard (see the module
    docstring). Its channels stay for phase 22 (removed there, or at exit)."""
    t = time.perf_counter()
    tmp = ELASTIC_KEPT["tmp"] = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    channels = ELASTIC_KEPT["channels"] = _elastic_channels(tmp)
    ref = ELASTIC_KEPT["logloss"] = _elastic_consensus_run(tag, tmp, channels)
    _elastic_shrink_run(tag, tmp, channels, ref)
    _elastic_drills(tag, tmp, channels)
    print("{} | elastic phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _elastic_channels(tmp):
    """Each host's third of the main path's training and validation rows
    as csv channels -> [(train dir, validation dir)] by rank."""
    X, y = exact_rows()
    n, nv, k = N_TRAIN, N_VAL, len(ELASTIC_HOSTS)
    cuts, vcuts = np.linspace(0, n, k + 1).astype(int), np.linspace(n, n + nv, k + 1).astype(int)
    out = []
    for rank in range(k):
        root = os.path.join(tmp, "channels", str(rank))
        t, v = slice(cuts[rank], cuts[rank + 1]), slice(vcuts[rank], vcuts[rank + 1])
        write_grid_csv(os.path.join(root, "train"), X[t], y[t])
        write_grid_csv(os.path.join(root, "validation"), X[v], y[v])
        out.append((os.path.join(root, "train"), os.path.join(root, "validation")))
    return out


def _elastic_hosts(tmp, name, channels, extra):
    """`--entry-child` processes of len(extra) hosts (the first of
    ELASTIC_HOSTS), host r on channels[r] with ELASTIC_PLANES and extra[r],
    its own model, checkpoint, output dirs and abort port, every rank
    saving its model (MODEL_COPY) -> [(_Child, root)]."""
    hosts = ELASTIC_HOSTS[:len(extra)]
    pg = free_port()
    ports = {"SM_RENDEZVOUS_PORT": free_port(), "SM_PROCESS_GROUP_PORT": pg,
             "SM_HEARTBEAT_PORT": free_port(), "SM_CONSENSUS_PORT": free_port(),
             "SM_REFORM_PORT": free_port(), "SM_FLEET_TRACE_PORT": free_port()}
    out = []
    for rank, more in enumerate(extra):
        root = os.path.join(tmp, name, str(rank))
        os.makedirs(os.path.join(root, "output"))
        channel = {"ContentType": "csv", "TrainingInputMode": "File",
                   "S3DistributionType": "FullyReplicated"}
        for fname, doc in (("hp.json", ELASTIC_HP),
                           ("data.json", {"train": channel, "validation": dict(channel)}),
                           ("checkpoint.json", {"LocalPath": os.path.join(root, "checkpoints")})):
            with open(os.path.join(root, fname), "w") as f:
                json.dump(doc, f)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
        env.update({k: str(v) for k, v in ports.items()})
        env.update(ELASTIC_PLANES)
        env.update({
            "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
            "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(root, "hp.json"),
            "SM_INPUT_DATA_CONFIG_FILE": os.path.join(root, "data.json"),
            "SM_CHECKPOINT_CONFIG_FILE": os.path.join(root, "checkpoint.json"),
            "SM_CHANNEL_TRAIN": channels[rank][0], "SM_CHANNEL_VALIDATION": channels[rank][1],
            "SM_MODEL_DIR": os.path.join(root, "model"),
            "SM_OUTPUT_DIR": os.path.join(root, "output"),
            "SM_OUTPUT_DATA_DIR": os.path.join(root, "output", "data"),
            "SM_HOSTS": json.dumps(hosts), "SM_CURRENT_HOST": hosts[rank],
            "SM_ABORT_PORT": str(free_port()),
            "MODEL_COPY": os.path.join(root, "output", "rank-model"),
        })
        env.update(more)
        out.append((_Child(ENTRY_CHILD_COMMAND, env), root))
    return out


def _wait_hosts(children, timeout):
    """[(_Child, root)] -> exit codes in order (``_wait_all``)."""
    codes = _wait_all(dict(enumerate(c for c, _root in children)), timeout)
    return [codes[i] for i in range(len(children))]


def _round_records(out):
    return {r["round"]: r for r in _records(out, "training.round")}


def _breakdown(records, rounds):
    """Mean ms a round over ``rounds`` of a child's round records: the
    round, each callback phase, the rest (build_eval: the tree build and the
    evaluation) and the collectives' host ms (hist_comm_ms)."""
    picked = [records[r] for r in rounds if r in records]
    if not picked:
        return {}
    keys = {"round_ms", "hist_comm_ms"} | {k for r in picked for k in r.get("phases_ms", {})}
    out = {}
    for k in sorted(keys):
        vals = [r.get(k, r.get("phases_ms", {}).get(k)) for r in picked]
        vals = [v for v in vals if v is not None]
        if vals:
            out[k] = round(sum(vals) / len(vals), 3)
    return out


def _rate(records, rounds):
    ms = [records[r]["round_ms"] for r in rounds if r in records]
    return len(ms) / (sum(ms) / 1000.0) if ms else float("nan")


def _same_bytes(paths):
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return all(b == blobs[0] for b in blobs)


def _elastic_consensus_run(tag, tmp, channels):
    """20a: three hosts, a consensus check every round, uninterrupted ->
    the last validation logloss of rank 0."""
    children = _elastic_hosts(tmp, "20a", channels, [{}, {}, {}])
    t = time.perf_counter()
    codes = _wait_hosts(children, 600)
    wall = time.perf_counter() - t
    for rank, ((c, _root), code) in enumerate(zip(children, codes)):
        check(code == 0, "20a: host {} exited {}: {}".format(rank, code, "".join(c.err)[-3000:]))
    reports = [_child_report(c.out) for c, _root in children]
    recs = [_round_records(c.out) for c, _root in children]
    steady = range(1, ELASTIC_ROUNDS)
    ll = _last_metric(children[0][0].out, "validation-logloss")
    same = _same_bytes([os.path.join(root, "output", "rank-model") for _c, root in children])
    lines = [[l for l in c.out.splitlines() if HPO_LINE.match(l)] for c, _root in children]
    print("{} | elastic 20a: three hosts exit {} in {:.1f} s (one card, gloo); consensus "
          "checks a rank {}; consensus ms a check (rounds 1-{}) {}; rounds/s a rank (rounds "
          "1-{}) {}; rank 0's mean ms a round {}; models byte-equal: {}; HPO lines "
          "identical: {}; launches {}; last validation logloss {:.6f}".format(
              tag, codes, wall, [r.get("consensus_checks") for r in reports],
              ELASTIC_ROUNDS - 1, [_breakdown(r, steady).get("consensus") for r in recs],
              ELASTIC_ROUNDS - 1, [round(_rate(r, steady), 3) for r in recs],
              json.dumps(_breakdown(recs[0], steady)), same,
              lines[0] == lines[1] == lines[2], json.dumps([r.get("launches") for r in reports]),
              ll), flush=True)
    check(all(r.get("consensus_checks") == ELASTIC_ROUNDS for r in reports),
          "20a: consensus checks {}".format([r.get("consensus_checks") for r in reports]))
    check(same, "20a: the ranks' models differ")
    check(len(lines[0]) == ELASTIC_ROUNDS and lines[0] == lines[1] == lines[2],
          "20a: the hosts printed different HPO lines")
    check(all(r.get("launches") == {"hist_kernel": 8 * ELASTIC_ROUNDS,
                                    "totals_kernel": ELASTIC_ROUNDS} for r in reports),
          "20a: launches {}".format([r.get("launches") for r in reports]))
    return ll


def _elastic_shrink_run(tag, tmp, channels, ref_logloss):
    """20b: 20a with SM_ELASTIC=1 and rank 2 killed at its 5th round end."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest
    from sagemaker_xgboost_container_tpu_torch.utils import integrity

    elastic_env = {"SM_ELASTIC": "1"}
    children = _elastic_hosts(tmp, "20b", channels, [
        dict(elastic_env), dict(elastic_env),
        dict(elastic_env, SM_FAULT_SPEC="training.round_end:kill@{}".format(ELASTIC_KILL_AT))])
    (c0, root0), (c1, root1), (c2, _root2) = children
    try:
        code2 = c2.wait(600)
        killed_at = c2.ended_at or time.perf_counter()
        codes = [c0.wait(600), c1.wait(600), code2]
    finally:
        for c, _root in children:
            c.kill()
    for rank, c in ((0, c0), (1, c1)):
        check(codes[rank] == 0, "20b: survivor {} exited {}: {}".format(
            rank, codes[rank], "".join(c.err)[-3000:]))
    check(code2 == -signal.SIGKILL, "20b: rank 2 exited {}".format(code2))
    transitions = [_records(c.out, "training.membership") for c in (c0, c1)]
    model = os.path.join(root0, "model", "xgboost-model")
    manifest = integrity.read_manifest(model) or {}
    log = manifest.get("membership_log") or []
    final = Forest.load_model(model, device="cpu")
    ckpt = Forest.load_model(os.path.join(root0, "checkpoints", "xgboost-checkpoint.{}".format(
        ELASTIC_KILL_AT - 1)), device="cpu")
    head_same = len(ckpt.trees) == ELASTIC_KILL_AT and all(
        np.array_equal(getattr(a, k), getattr(b, k))
        for a, b in zip(final.trees[:ELASTIC_KILL_AT], ckpt.trees) for k in ELASTIC_TREE_KEYS)
    same = _same_bytes([os.path.join(r, "output", "rank-model") for r in (root0, root1)])
    # the new generation's first round: rank 0's first training.round line
    # after its training.membership line, on this process's clock
    member_at = next(i for i, l in enumerate(c0.lines) if '"training.membership"' in l) \
        if transitions[0] else len(c0.lines)
    first_after = next((c0.stamps[i] for i in range(member_at, len(c0.lines))
                        if c0.lines[i].startswith('{"metric": "training.round"')), None)
    to_first_round = (first_after - killed_at) if first_after is not None else float("nan")
    recs = [_round_records(c.out) for c in (c0, c1)]
    before, after = range(1, ELASTIC_KILL_AT), range(ELASTIC_KILL_AT + 1, ELASTIC_ROUNDS)
    reports = [_child_report(c.out) for c in (c0, c1)]
    at_reform = [_reform_launches(c.out) for c in (c0, c1)]
    per_round_after = [{k: (r.get("launches", {}).get(k, 0) - a.get(k, 0)) /
                        float(ELASTIC_ROUNDS - ELASTIC_KILL_AT)
                        for k in ("hist_kernel", "totals_kernel")}
                       for r, a in zip(reports, at_reform)]
    ll = _last_metric(c0.out, "validation-logloss")
    rounds_printed = [sorted(_metric_lines(c.out)) for c in (c0, c1)]
    print("{} | elastic 20b: rank 2 killed at its round-{} end (exit {}); survivors exit {}; "
          "{:.3f} s from the kill to the new generation's first round (rank 0); membership "
          "{}; manifest membership_log {}; rounds 1-{} equal to checkpoint {}: {}; survivor "
          "models byte-equal: {} ({} rounds); rounds/s a rank before (rounds 1-{}) {} and "
          "after (rounds {}-{}) the shrink {}; rank 0's mean ms a round before {} and after "
          "{}; launches at the reform {}, a round after it {}; consensus checks {}; last "
          "validation logloss {:.6f} against 20a's {:.6f}".format(
              tag, ELASTIC_KILL_AT - 1, code2, codes[:2], to_first_round,
              json.dumps(transitions[0]), json.dumps(log), ELASTIC_KILL_AT,
              ELASTIC_KILL_AT - 1, head_same, same, final.num_boosted_rounds,
              ELASTIC_KILL_AT - 1, [round(_rate(r, before), 3) for r in recs],
              ELASTIC_KILL_AT + 1, ELASTIC_ROUNDS - 1, [round(_rate(r, after), 3) for r in recs],
              json.dumps(_breakdown(recs[0], before)), json.dumps(_breakdown(recs[0], after)),
              json.dumps(at_reform), json.dumps(per_round_after),
              [r.get("consensus_checks") for r in reports], ll, ref_logloss), flush=True)
    check(transitions[0] == transitions[1] and len(transitions[0]) == 1,
          "20b: membership records {}".format(transitions))
    t = transitions[0][0]
    check((t["old_world_size"], t["new_world_size"], t["surviving_ranks"]) == (3, 2, [0, 1]),
          "20b: transition {}".format(t))
    check(len(log) == 1 and log[0]["surviving_ranks"] == [0, 1]
          and (log[0]["old_world_size"], log[0]["new_world_size"]) == (3, 2),
          "20b: the manifest's membership_log is {}".format(log))
    check(final.num_boosted_rounds == ELASTIC_ROUNDS, "20b: {} rounds".format(
        final.num_boosted_rounds))
    check(head_same, "20b: rounds 1-{} differ from the checkpoint".format(ELASTIC_KILL_AT))
    check(same, "20b: the survivors' models differ")
    check(all(p == list(range(ELASTIC_ROUNDS)) for p in rounds_printed),
          "20b: rounds printed {}".format(rounds_printed))
    check(all(p == {"hist_kernel": 8.0, "totals_kernel": 1.0} for p in per_round_after),
          "20b: launches a round after the shrink {}".format(per_round_after))
    check(abs(ll - ref_logloss) <= ELASTIC_LOGLOSS_TOL,
          "20b: logloss {} against 20a's {}".format(ll, ref_logloss))


def _reform_launches(out, local_rank=0):
    """The launch counts a rank printed as its elastic reform began
    (`{"reform_launches": ...}`; a worker's line names its local rank)."""
    found = [json.loads(l) for l in out.splitlines() if l.startswith('{"reform_launches"')]
    return ([r["reform_launches"] for r in found if r.get("local_rank", 0) == local_rank]
            or [{}])[0]


def _elastic_drills(tag, tmp, channels):
    """20c (two hosts, rank 1's digest perturbed: exit 81) and 20d (three
    hosts, rank 2 killed, the reform faulted: exit 82 with a flight-recorder
    dump), at once."""
    t = time.perf_counter()
    c = _elastic_hosts(tmp, "20c", channels, [
        {}, {"SM_FAULT_SPEC": "consensus.check:error@3"}])
    reform_fault = {"SM_ELASTIC": "1", "SM_TRACE": "true", "SM_IO_RETRY_ATTEMPTS": "2",
                    "SM_FAULT_SPEC": "rendezvous.reform:error:injected reform outage"}
    d = _elastic_hosts(tmp, "20d", channels, [
        dict(reform_fault), dict(reform_fault),
        {"SM_ELASTIC": "1", "SM_FAULT_SPEC": "training.round_end:kill@{}".format(
            ELASTIC_KILL_AT)}])
    codes = _wait_hosts(c + d, 600)
    wall = time.perf_counter() - t
    divergence = [_records(ch.out, "training.divergence") for ch, _root in c]
    aborts = [_records(ch.out, "training.abort") for ch, _root in c + d]
    dumps = [a[0].get("flight_recorder") if a else None for a in aborts[2:4]]
    print("{} | elastic 20c / 20d (five children at once, {:.1f} s): 20c exits {}, "
          "training.divergence records {}; 20d exits {}, abort reasons {}, flight-recorder "
          "dumps {}".format(
              tag, wall, codes[:2], json.dumps(divergence), codes[2:],
              [a[0]["reason"] if a else None for a in aborts[2:]],
              [p if p and os.path.exists(p) else None for p in dumps]), flush=True)
    for rank in range(2):
        check(codes[rank] == 81, "20c: host {} exited {}: {}".format(
            rank, codes[rank], "".join(c[rank][0].err)[-3000:]))
        recs = divergence[rank]
        check(len(recs) == 1 and set(recs[0]["digests"]) == {"0", "1"}
              and recs[0]["digests"]["0"] != recs[0]["digests"]["1"],
              "20c: host {}'s divergence records {}".format(rank, recs))
    for rank in range(2):
        check(codes[2 + rank] == 82, "20d: survivor {} exited {}: {}".format(
            rank, codes[2 + rank], "".join(d[rank][0].err)[-3000:]))
        check(dumps[rank] and os.path.exists(dumps[rank]),
              "20d: survivor {} left no flight-recorder dump".format(rank))
    check(codes[4] == -signal.SIGKILL, "20d: rank 2 exited {}".format(codes[4]))


# (phase, wall seconds) of this run, printed at its end
# ---------------------------------------------------------------- phase 21

# one training process per local GPU (SM_LOCAL_RANKS, parallel/local.py)
# through the train entry point. The box has one card, so two local ranks
# share it over gloo (NCCL refuses two ranks on one device); 21d runs NCCL
# between two cards only where there are two
LOCAL_ROUNDS = 10
LOCAL_HP = dict(STREAM_HP, num_round=str(LOCAL_ROUNDS))
LOCAL_HOSTS_HP = dict(DIST_ENTRY_HP, num_round=str(LOCAL_ROUNDS))
LOCAL_KILL_ROUND = 3
LOCAL_PIDS = re.compile(r"spawned local ranks .* pids \[([0-9, ]*)\]")


def run_local_ranks(torch, tag):
    """Phase 21: local ranks through the train entry point (see the module
    docstring)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_local_") as tmp:
        _local_one_host(tag, tmp)
        _local_two_hosts(tag, tmp)
        _local_nccl(torch, tag, tmp)
    print("{} | local ranks phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


def _local_env(tmp, name, train_dir, val_dir, hp, extra):
    """The env of one host's `--entry-child` on the given channels."""
    root = os.path.join(tmp, name)
    os.makedirs(root)
    channel = {"ContentType": "csv", "TrainingInputMode": "File",
               "S3DistributionType": "FullyReplicated"}
    for fname, doc in (("hp.json", hp),
                       ("data.json", {"train": channel, "validation": dict(channel)})):
        with open(os.path.join(root, fname), "w") as f:
            json.dump(doc, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SM_", "SAGEMAKER_"))}
    env.update({
        "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
        "SM_INPUT_TRAINING_CONFIG_FILE": os.path.join(root, "hp.json"),
        "SM_INPUT_DATA_CONFIG_FILE": os.path.join(root, "data.json"),
        "SM_CHECKPOINT_CONFIG_FILE": os.path.join(root, "none.json"),
        "SM_CHANNEL_TRAIN": train_dir, "SM_CHANNEL_VALIDATION": val_dir,
        "SM_MODEL_DIR": os.path.join(root, "model"),
        "SM_OUTPUT_DIR": os.path.join(root, "output"),
        "SM_OUTPUT_DATA_DIR": os.path.join(root, "output", "data"),
        "SM_HOSTS": '["algo-1"]', "SM_CURRENT_HOST": "algo-1",
        "SM_PROCESS_GROUP_PORT": str(free_port()),
        "SM_INGEST_MODE": "whole", "CHIP_SMOKE_INGEST_REPORT": "1"})
    env.update(extra)
    return env, root


def _rank_reports(out):
    """{local rank: the `{"rank_launches": ...}` line} of a leader's workers."""
    return {r["local_rank"]: r for r in (json.loads(line) for line in out.splitlines()
                                         if line.startswith('{"rank_launches"'))}


def _local_pids(out):
    return [int(v) for m in LOCAL_PIDS.finditer(out) for v in m.group(1).split(",")
            if v.strip()]


def _pid_alive(pid):
    try:
        with open("/proc/{}/stat".format(pid)) as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return False


def _first_round_s(child):
    """Seconds from the child's start to its first HPO line."""
    for stamp, line in zip(child.stamps, child.lines):
        if HPO_LINE.match(line):
            return stamp - child.started_at
    return float("nan")


def _local_one_host(tag, tmp):
    """21a: one rank (no SM_LOCAL_RANKS) and 21b: SM_LOCAL_RANKS=2 over
    gloo on the one card, on 19a's channels at the main path's width."""
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    X, y = exact_rows()
    train_dir, val_dir = os.path.join(tmp, "main", "train"), os.path.join(tmp, "main", "val")
    write_grid_csv(train_dir, X[:N_TRAIN], y[:N_TRAIN])
    write_grid_csv(val_dir, X[N_TRAIN:], y[N_TRAIN:])
    runs = {}
    for name, extra in (("21a", {}), ("21b", {"SM_LOCAL_RANKS": "2",
                                              "SM_PROCESS_GROUP_BACKEND": "gloo"})):
        env, root = _local_env(tmp, name, train_dir, val_dir, LOCAL_HP, extra)
        child = _wait4_child(ENTRY_CHILD_COMMAND, env)
        code = child.wait(600)
        check(code == 0, "{}: exit {}: {}".format(name, code, "".join(child.err)[-3000:]))
        runs[name] = (child, root)
    (a, root_a), (b, root_b) = runs["21a"], runs["21b"]
    lines = {n: [l for l in c.out.splitlines() if HPO_LINE.match(l)]
             for n, (c, _r) in runs.items()}
    ll = {n: _last_metric(c.out, "validation-logloss") for n, (c, _r) in runs.items()}
    ingest = {n: _ingest_report(c.out) for n, (c, _r) in runs.items()}
    launches = {n: _child_launches(c.out) for n, (c, _r) in runs.items()}
    workers = _rank_reports(b.out)
    want = {"hist_kernel": 8 * LOCAL_ROUNDS, "totals_kernel": LOCAL_ROUNDS}
    models = [Forest.load_model(os.path.join(r, "model", "xgboost-model"), device="cpu")
              for r in (root_a, root_b)]
    cmp = _compare(models[0], models[1], X[:20_000], X[N_TRAIN:N_TRAIN + 10_000])
    records = _records(b.out, "training.round")[1:LOCAL_ROUNDS - 1]   # rounds 2-9
    rate = len(records) / (sum(r["round_ms"] for r in records) / 1000.0)
    comm_ms = float(np.mean([r.get("hist_comm_ms", 0.0) for r in records]))
    worker = workers.get(1, {})
    rounds_s_a = _records(a.out, "training.round")[1:LOCAL_ROUNDS - 1]
    rate_a = len(rounds_s_a) / (sum(r["round_ms"] for r in rounds_s_a) / 1000.0)
    print("{} | local 21a (no SM_LOCAL_RANKS): exit 0, spawned {} process(es); launches {}; "
          "{:.3f} rounds/s over rounds 2-9; peak RSS {:.1f} MiB (os.wait4); {:.1f} s from "
          "start to the first round; last validation logloss {:.6f}".format(
              tag, len(_local_pids(a.out)), json.dumps(launches["21a"]), rate_a,
              _maxrss_mb(a.out), _first_round_s(a), ll["21a"]), flush=True)
    print("{} | local 21b (SM_LOCAL_RANKS=2, gloo, both ranks on cuda:0): exit 0; {} HPO "
          "lines, each once: {}; launches leader {} / local rank 1 {}; cuts sha256 {} "
          "(21a's {}); {:.3f} rounds/s a rank over rounds 2-9; histogram collective "
          "{:.3f} ms a round (leader's records), local rank 1's collectives {} calls "
          "{:.3f} s in all; peak RSS: the leader's os.wait4 {:.1f} MiB; VmRSS sampled every "
          "50 ms: leader {:.1f} MiB, local rank 1 {:.1f} MiB; {:.1f} s from "
          "start to the first round; last validation logloss {:.6f} (21a's {:.6f}); "
          "against 21a: {}".format(
              tag, len(lines["21b"]), len(set(lines["21b"])) == len(lines["21b"]),
              json.dumps(launches["21b"]), json.dumps(worker.get("rank_launches")),
              ingest["21b"]["cuts"], ingest["21a"]["cuts"], rate, comm_ms,
              worker.get("collective_calls"), worker.get("collective_s", float("nan")),
              _maxrss_mb(b.out), _child_report(b.out).get("rss_peak_mb", float("nan")),
              worker.get("rss_peak_mb", float("nan")), _first_round_s(b), ll["21b"], ll["21a"],
              json.dumps(cmp)), flush=True)
    check(not _local_pids(a.out) and not _rank_reports(a.out),
          "21a: a process was spawned without SM_LOCAL_RANKS")
    check(launches["21a"] == want, "21a: launches {}".format(launches["21a"]))
    check(abs(ll["21a"] - ll["21b"]) <= ENTRY_METRIC_TOL and cmp["mean_dp"] <= ENTRY_DP_TOL,
          "21a: one rank's model and 21b's differ beyond phase 8's tolerance: {}".format(cmp))
    check(len(_local_pids(b.out)) == 1 and sorted(workers) == [1],
          "21b: workers {} / reports {}".format(_local_pids(b.out), sorted(workers)))
    check(len(lines["21b"]) == LOCAL_ROUNDS and len(set(lines["21b"])) == LOCAL_ROUNDS,
          "21b: HPO lines {}".format(lines["21b"]))
    check(sorted(os.listdir(os.path.join(root_b, "model"))) ==
          ["xgboost-model", "xgboost-model.manifest"], "21b: model dir {}".format(
              os.listdir(os.path.join(root_b, "model"))))
    check(launches["21b"] == want and worker.get("rank_launches") == want,
          "21b: launches {} / {}".format(launches["21b"], worker.get("rank_launches")))
    check(ingest["21b"]["cuts"] == ingest["21a"]["cuts"],
          "21b: the session's cuts are not one rank's on all the rows")
    check(abs(ll["21b"] - ll["21a"]) <= OPTION_TOL * max(1.0, abs(ll["21a"])),
          "21b: validation logloss {} vs one rank's {}".format(ll["21b"], ll["21a"]))


def _local_two_hosts(tag, tmp):
    """21c: two entry hosts x SM_LOCAL_RANKS=2 (four gloo ranks on the
    card) on phase 8's channels halved, uninterrupted and, at the same
    time, with local rank 1 of host 1 SIGKILLed at its 3rd round end."""
    common = {"SM_LOCAL_RANKS": "2"}
    runs = {
        "ok": _dist_entry_hosts(tmp, "local-ok", LOCAL_HOSTS_HP, [dict(common)] * 2),
        "kill": _dist_entry_hosts(tmp, "local-kill", dict(LOCAL_HOSTS_HP, num_round="40"), [
            dict(common), dict(common, SM_LOCAL_FAULT_SPEC="1=training.round_end:kill@{}".format(
                LOCAL_KILL_ROUND))]),
    }
    t = time.perf_counter()
    children = {name: [_Child(ENTRY_CHILD_COMMAND, env) for env, _root in envs]
                for name, envs in runs.items()}
    try:
        codes = {name: [c.wait(400) for c in cs] for name, cs in children.items()}
    finally:
        for cs in children.values():
            for c in cs:
                c.kill()
    wall = time.perf_counter() - t
    ok, kill = children["ok"], children["kill"]
    lines = [[l for l in c.out.splitlines() if HPO_LINE.match(l)] for c in ok]
    want = {"hist_kernel": 8 * LOCAL_ROUNDS, "totals_kernel": LOCAL_ROUNDS}
    launches = [[_child_launches(c.out)] + [r["rank_launches"] for _k, r in sorted(
        _rank_reports(c.out).items())] for c in ok]
    models = [os.path.exists(os.path.join(root, "model", "xgboost-model"))
              for _env, root in runs["ok"]]
    pids = [p for c in kill for p in _local_pids(c.out)]
    deadline = time.monotonic() + 10
    while any(_pid_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = [p for p in pids if _pid_alive(p)]
    with open(os.path.join(runs["kill"][1][1], "output", "failure")) as f:
        failure = f.read()
    print("{} | local 21c (two hosts x SM_LOCAL_RANKS=2, four gloo ranks on cuda:0; both "
          "runs at once, {:.1f} s): exits {}; {} HPO lines a host, identical: {}; models "
          "written by host 0 / host 1: {} / {}; launches (leader, local rank 1) by host {}; "
          "kill of host 1's local rank 1 at its round {}: exits {}, host 1's failure file "
          "{!r}, worker pids {} left alive: {}".format(
              tag, wall, codes["ok"], len(lines[0]), lines[0] == lines[1], models[0],
              models[1], json.dumps(launches), LOCAL_KILL_ROUND, codes["kill"],
              failure[:160], pids, left), flush=True)
    for rank, (code, c) in enumerate(zip(codes["ok"], ok)):
        check(code == 0, "21c: host {} exited {}: {}".format(rank, code,
                                                             "".join(c.err)[-3000:]))
    check(len(lines[0]) == LOCAL_ROUNDS and lines[0] == lines[1],
          "21c: HPO lines {} / {}".format(len(lines[0]), len(lines[1])))
    check(models == [True, False], "21c: models written {}".format(models))
    check(all(l == [want, want] for l in launches), "21c: launches {}".format(launches))
    check(codes["kill"] == [80, 80], "21c: the kill run exited {}: {}".format(
        codes["kill"], "".join(kill[0].err)[-2000:]))
    check(len(pids) == 2 and not left, "21c: worker pids {}, alive {}".format(pids, left))
    check("local rank 1" in failure, "21c: failure file {!r}".format(failure))


def _local_nccl(torch, tag, tmp):
    """21d: 21b over NCCL between two cards, under both GRAFT_HIST_COMM
    lowerings, where the box has two."""
    if torch.cuda.device_count() < 2:
        print("{} | nccl_local: not run (1 GPU)".format(tag), flush=True)
        return
    X, y = exact_rows()
    train_dir, val_dir = os.path.join(tmp, "nccl", "train"), os.path.join(tmp, "nccl", "val")
    write_grid_csv(train_dir, X[:N_TRAIN], y[:N_TRAIN])
    write_grid_csv(val_dir, X[N_TRAIN:], y[N_TRAIN:])
    want = {"hist_kernel": 8 * LOCAL_ROUNDS, "totals_kernel": LOCAL_ROUNDS}
    for comm in ("psum", "reduce_scatter"):
        env, _root = _local_env(tmp, "21d-" + comm, train_dir, val_dir, LOCAL_HP,
                                {"SM_LOCAL_RANKS": "2", "GRAFT_HIST_COMM": comm})
        child = _wait4_child(ENTRY_CHILD_COMMAND, env)
        code = child.wait(600)
        check(code == 0, "21d {}: exit {}: {}".format(comm, code, "".join(child.err)[-3000:]))
        records = _records(child.out, "training.round")[1:LOCAL_ROUNDS - 1]
        worker = _rank_reports(child.out).get(1, {})
        print("{} | nccl_local 21d {}: exit 0; {:.3f} rounds/s a rank over rounds 2-9; "
              "histogram collective {:.3f} ms a round; launches {} / {}; last validation "
              "logloss {:.6f}".format(
                  tag, comm, len(records) / (sum(r["round_ms"] for r in records) / 1000.0),
                  float(np.mean([r.get("hist_comm_ms", 0.0) for r in records])),
                  json.dumps(_child_launches(child.out)),
                  json.dumps(worker.get("rank_launches")),
                  _last_metric(child.out, "validation-logloss")), flush=True)
        check(_child_launches(child.out) == want and worker.get("rank_launches") == want,
              "21d {}: launches".format(comm))


# ---------------------------------------------------------------- phase 22

# elastic shrink-to-continue with local ranks: phase 20's three hosts, each
# SM_LOCAL_RANKS=2 (six gloo ranks on the one card), host 2's local rank 1
# killed at its round-5 end: host 2 exits 80, hosts 0-1 shrink to 2 x 2
ELASTIC_LOCAL_ENV = {"SM_ELASTIC": "1", "SM_LOCAL_RANKS": "2"}


def run_elastic_local(torch, tag):
    """Phase 22: the elastic shrink with two local ranks a host (see the
    module docstring), on phase 20's channels."""
    import shutil

    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    t = time.perf_counter()
    tmp, channels, ref_logloss = (ELASTIC_KEPT[k] for k in ("tmp", "channels", "logloss"))
    children = _elastic_hosts(tmp, "22", channels, [
        dict(ELASTIC_LOCAL_ENV), dict(ELASTIC_LOCAL_ENV),
        dict(ELASTIC_LOCAL_ENV, SM_LOCAL_FAULT_SPEC="1=training.round_end:kill@{}".format(
            ELASTIC_KILL_AT))])
    (c0, root0), (c1, root1), (c2, _root2) = children
    codes = _wait_hosts(children, 600)
    for rank, (c, _root) in enumerate(children):
        want = 80 if rank == 2 else 0
        check(codes[rank] == want, "22: host {} exited {} (want {}): {}".format(
            rank, codes[rank], want, "".join(c.err)[-3000:]))
    # the kill: host 2's leader logs its worker's death as it sees it
    killed_at = next((c2.stamps[i] for i, l in enumerate(c2.lines)
                      if "local rank 1 failed" in l), c2.ended_at)
    transitions = [_records(c.out, "training.membership") for c in (c0, c1)]
    model = os.path.join(root0, "model", "xgboost-model")
    final = Forest.load_model(model, device="cpu")
    ckpt = Forest.load_model(os.path.join(root0, "checkpoints", "xgboost-checkpoint.{}".format(
        ELASTIC_KILL_AT - 1)), device="cpu")
    head_same = len(ckpt.trees) == ELASTIC_KILL_AT and all(
        np.array_equal(getattr(a, k), getattr(b, k))
        for a, b in zip(final.trees[:ELASTIC_KILL_AT], ckpt.trees) for k in ELASTIC_TREE_KEYS)
    same = _same_bytes([os.path.join(r, "output", "rank-model") for r in (root0, root1)])
    member_at = next((i for i, l in enumerate(c0.lines) if '"training.membership"' in l),
                     len(c0.lines))
    first_after = next((c0.stamps[i] for i in range(member_at, len(c0.lines))
                        if c0.lines[i].startswith('{"metric": "training.round"')), None)
    to_first_round = (first_after - killed_at) if first_after is not None else float("nan")
    recs = [_round_records(c.out) for c in (c0, c1)]
    before, after = range(1, ELASTIC_KILL_AT), range(ELASTIC_KILL_AT + 1, ELASTIC_ROUNDS)
    # every rank's launches a round after the reform: (at exit - at the
    # reform) over the rounds after it; the leader, then its worker
    rounds_after = float(ELASTIC_ROUNDS - ELASTIC_KILL_AT)
    per_round_after, rss = [], []
    for c in (c0, c1):
        worker = _rank_reports(c.out).get(1, {})
        for final_counts, local_rank in ((_child_launches(c.out), 0),
                                         (worker.get("rank_launches"), 1)):
            at = _reform_launches(c.out, local_rank)
            per_round_after.append({k: ((final_counts or {}).get(k, 0) - at.get(k, 0)) /
                                    rounds_after for k in ("hist_kernel", "totals_kernel")})
        rss += [_child_report(c.out).get("rss_peak_mb"), worker.get("rss_peak_mb")]
    ll = _last_metric(c0.out, "validation-logloss")
    rounds_printed = [sorted(_metric_lines(c.out)) for c in (c0, c1)]
    print("{} | elastic local 22 (three hosts x SM_LOCAL_RANKS=2, six gloo ranks on cuda:0): "
          "host 2's local rank 1 killed at its round-{} end; exits {}; {:.3f} s from the kill "
          "to the new generation's first round (host 0); membership {}; rounds 1-{} equal to "
          "checkpoint {}: {}; survivor models byte-equal: {} ({} rounds); rounds/s a rank "
          "before (rounds 1-{}) {} and after (rounds {}-{}) the shrink {} (the leaders' "
          "records; a host's ranks run in step); histogram collective ms a round before {} "
          "and after {}; launches a round after the reform, host 0 leader / worker, host 1 "
          "leader / worker {}; peak RSS MiB (VmRSS sampled) {}; last validation logloss "
          "{:.6f} against 20a's {:.6f}".format(
              tag, ELASTIC_KILL_AT - 1, codes, to_first_round, json.dumps(transitions[0]),
              ELASTIC_KILL_AT, ELASTIC_KILL_AT - 1, head_same, same, final.num_boosted_rounds,
              ELASTIC_KILL_AT - 1, [round(_rate(r, before), 3) for r in recs],
              ELASTIC_KILL_AT + 1, ELASTIC_ROUNDS - 1, [round(_rate(r, after), 3) for r in recs],
              [_breakdown(r, before).get("hist_comm_ms") for r in recs],
              [_breakdown(r, after).get("hist_comm_ms") for r in recs],
              json.dumps(per_round_after), rss, ll, ref_logloss), flush=True)
    print("{} | elastic local 22: nccl: not run (1 GPU)".format(tag), flush=True)
    check(transitions[0] == transitions[1] and len(transitions[0]) == 1,
          "22: membership records {}".format(transitions))
    tr = transitions[0][0]
    check((tr["old_world_size"], tr["new_world_size"], tr["surviving_ranks"]) == (3, 2, [0, 1]),
          "22: transition {}".format(tr))
    check(final.num_boosted_rounds == ELASTIC_ROUNDS, "22: {} rounds".format(
        final.num_boosted_rounds))
    check(head_same, "22: rounds 1-{} differ from the checkpoint".format(ELASTIC_KILL_AT))
    check(same, "22: the survivors' models differ")
    check(all(p == list(range(ELASTIC_ROUNDS)) for p in rounds_printed),
          "22: rounds printed {}".format(rounds_printed))
    check(all(p == {"hist_kernel": 8.0, "totals_kernel": 1.0} for p in per_round_after),
          "22: launches a round after the shrink {}".format(per_round_after))
    check(abs(ll - ref_logloss) <= ELASTIC_LOGLOSS_TOL,
          "22: logloss {} against 20a's {}".format(ll, ref_logloss))
    shutil.rmtree(ELASTIC_KEPT.pop("tmp"), ignore_errors=True)
    print("{} | elastic local phase: {:.1f} s".format(tag, time.perf_counter() - t), flush=True)


# ---------------------------------------------------------------- phase 23
NATIVE_ROWS = 200_000             # ~60 MB of libsvm text at N_FEATURES
NATIVE_PYTHON_SHARE = 10          # the Python tokenizer parses a tenth of it
NATIVE_PREDICT_CALLS = 200        # host predicts a payload size and route
NATIVE_PREDICT_TOL = 1e-6


def native_libsvm_text(n, d, seed):
    """Seeded libsvm rows (str each) of ``n`` rows x ``d`` features as
    users write them: ``label:weight qid:q 0:v ... d-1:v``, query ids in
    runs of about 20 rows, values on a 1e-4 grid as "%.7g" prints them."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, d) * 10.0, 4)
    labels = rng.randint(0, 2, n)
    weights = np.round(rng.rand(n) * 2.0 + 0.5, 3)
    qids = np.cumsum(rng.rand(n) < 0.05)
    fmt = "%d:%.4g qid:%d " + " ".join("{}:%.7g".format(j) for j in range(d)) + "\n"
    return [fmt % ((labels[i], weights[i], qids[i]) + tuple(X[i])) for i in range(n)]


def _same_parse(a, b):
    return (a[0].shape == b[0].shape
            and all(np.array_equal(getattr(a[0], k), getattr(b[0], k))
                    for k in ("indptr", "indices", "data"))
            and all((x is None and y is None) or np.array_equal(x, y)
                    for x, y in zip(a[1:], b[1:])))


def _median_us(fn, calls):
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e6)
    return float(np.median(times))


def run_native(tag):
    """Phase 23: the native data plane (``data/native.py`` over
    ``native/fastdata.cpp``) on the card's host (see the module
    docstring)."""
    import shutil

    from sagemaker_xgboost_container_tpu_torch.data import native, readers
    from sagemaker_xgboost_container_tpu_torch.models.forest import Forest

    t0 = time.perf_counter()
    # ---- the library, built from the checkout's source
    shutil.rmtree(native.cache_dir(), ignore_errors=True)
    native._reset_for_tests()
    check(native.native_available() and native.forest_predictor_available(),
          "23: the native library did not load")
    info = native.load_info()
    check(info["route"] in ("built", "packaged"), "23: library {}".format(info))
    print("{} | native library: {} in {:.3f} s ({})".format(
        tag, info["route"], info["build_s"], info["path"]), flush=True)

    # ---- the tokenizer: native on the default threads and on one, Python
    # on a tenth of the text
    t = time.perf_counter()
    rows = native_libsvm_text(NATIVE_ROWS, N_FEATURES, seed=23)
    text = "".join(rows)
    part = "".join(rows[:NATIVE_ROWS // NATIVE_PYTHON_SHARE])
    make_s = time.perf_counter() - t
    mb, part_mb = len(text) / 1e6, len(part) / 1e6
    parsed, rates = {}, {}
    saved = os.environ.pop(native.PARSE_THREADS_ENV, None)
    try:
        for label, threads, body in (("native", None, text), ("native 1 thread", "1", text),
                                     ("native slice", "1", part)):
            if threads is not None:
                os.environ[native.PARSE_THREADS_ENV] = threads
            native.reset_native_routes()
            t = time.perf_counter()
            parsed[label] = readers.parse_libsvm_text(body)
            rates[label] = len(body) / 1e6 / (time.perf_counter() - t)
            check(native.NATIVE_ROUTES["parse_native"] == 1,
                  "23: {} parse took route {}".format(label, native.NATIVE_ROUTES))
    finally:
        os.environ.pop(native.PARSE_THREADS_ENV, None)
        if saved is not None:
            os.environ[native.PARSE_THREADS_ENV] = saved
    real = native.parse_libsvm_native
    native.parse_libsvm_native = lambda data: None
    try:
        t = time.perf_counter()
        parsed["python"] = readers.parse_libsvm_text(part)
        rates["python"] = part_mb / (time.perf_counter() - t)
    finally:
        native.parse_libsvm_native = real
    threads = native._parse_threads(len(text))
    csr, labels, weights, qids = parsed["native"]
    check(csr.shape == (NATIVE_ROWS, N_FEATURES) and weights is not None and qids is not None,
          "23: parsed {} weights {} qids {}".format(csr.shape, weights is not None,
                                                    qids is not None))
    same_threads = _same_parse(parsed["native"], parsed["native 1 thread"])
    same_python = _same_parse(parsed["native slice"], parsed["python"])
    print("{} | native parse: {:.1f} MB of libsvm ({} rows x {} features, weights and qid:; "
          "made in {:.3f} s): native {} threads {:.1f} MB/s, native 1 thread {:.1f} MB/s; "
          "Python tokenizer on {:.1f} MB ({} rows) {:.1f} MB/s (native 1 thread on the same "
          "{:.1f} MB/s); threaded == 1 thread: {}; native == Python on the slice: {}".format(
              tag, mb, NATIVE_ROWS, N_FEATURES, make_s, threads, rates["native"],
              rates["native 1 thread"], part_mb, NATIVE_ROWS // NATIVE_PYTHON_SHARE,
              rates["python"], rates["native slice"], same_threads, same_python), flush=True)
    check(same_threads, "23: the threaded parse differs from the one-thread parse")
    check(same_python, "23: the native parse differs from the Python tokenizer's")

    # ---- the small-payload traversal: phase 7's model, native and numpy
    check("serve" in MODELS, "23 needs phase 7's model")
    forest = Forest.load_model(os.path.join(MODELS["serve"], "xgboost-model"), device=DEVICE)
    rounds = (0, SERVE_BEST_ITERATION + 1)
    x, _ = make_data(32, N_FEATURES, seed=24)
    x[np.random.RandomState(25).rand(*x.shape) < 0.02] = np.nan
    us, answers, routes = {}, {}, {}
    saved = os.environ.pop("GRAFT_HOST_PREDICT_IMPL", None)
    try:
        for impl in ("native", "numpy"):
            os.environ["GRAFT_HOST_PREDICT_IMPL"] = impl
            native.reset_native_routes()
            for n in (1, 32):
                answers[impl, n] = forest.predict_margin(x[:n], iteration_range=rounds)
                us[impl, n] = _median_us(
                    lambda: forest.predict_margin(x[:n], iteration_range=rounds),
                    NATIVE_PREDICT_CALLS)
            routes[impl] = dict(native.NATIVE_ROUTES)
    finally:
        os.environ.pop("GRAFT_HOST_PREDICT_IMPL", None)
        if saved is not None:
            os.environ["GRAFT_HOST_PREDICT_IMPL"] = saved
    err = max(float(np.abs(answers["native", n] - answers["numpy", n]).max()) for n in (1, 32))
    calls = 2 * (NATIVE_PREDICT_CALLS + 1)
    print("{} | native host predict (phase 7's model, {} trees of up to {} nodes, median of "
          "{} calls): 1 row native {:.1f} us, numpy {:.1f} us; 32 rows native {:.1f} us, "
          "numpy {:.1f} us; native against numpy max_abs_err {:.3e}; routes {}".format(
              tag, forest.iteration_indptr[rounds[1]], max(t.num_nodes for t in forest.trees),
              NATIVE_PREDICT_CALLS, us["native", 1], us["numpy", 1], us["native", 32],
              us["numpy", 32], err, json.dumps(routes)), flush=True)
    check(err <= NATIVE_PREDICT_TOL, "23: native and numpy host predicts differ by {}".format(err))
    check(routes["native"]["predict_native"] == calls and not routes["native"]["predict_numpy"]
          and routes["numpy"]["predict_numpy"] == calls,
          "23: host traversal routes {}".format(routes))
    print("{} | native phase: {:.1f} s".format(tag, time.perf_counter() - t0), flush=True)


PHASE_WALL = []


def phase(name, fn, *args):
    """Run phase ``name`` (``fn(*args)``) and note its wall time."""
    t = time.perf_counter()
    out = fn(*args)
    PHASE_WALL.append((name, time.perf_counter() - t))
    return out


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    try:
        import sagemaker_xgboost_container_tpu_torch as pkg
        from sagemaker_xgboost_container_tpu_torch import _build
        from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist
    except ImportError as e:
        print("run chip_smoke.py from a checkout of the repository: {}".format(e),
              file=sys.stderr)
        return 1

    tag = card_tag()
    print("python {} torch {} cuda {}".format(
        sys.version.split()[0], torch.__version__, torch.version.cuda), flush=True)
    try:
        # the kernels' library is cached by a digest of its sources: remove
        # it, so that this run builds from the checkout and reports the build
        import shutil

        shutil.rmtree(_build.build_dir(), ignore_errors=True)
        t = time.perf_counter()
        k = _build.kernels()
        check(k.build_log, "the kernels were loaded, not built")
        print("{} | build: {:.1f} s ({}, nvcc {:.1f} s)".format(
            tag, time.perf_counter() - t, k.route, k.build_s), flush=True)
        report_kernels(k, "hist_", atomic_free=False)
        report_kernels(k, "totals_", atomic_free=True)
        PHASE_WALL.append(("1 build", time.perf_counter() - t))

        results = {}

        def hist_cases():
            for n, d, W, B, dt, kind, timed in HIST_CASES:
                r = hist_case(torch, hist, n, d, W, B, dt, kind, 10 + W, timed, tag)
                if r is not None:
                    results["hist W={} {}".format(W, kind)] = r
            for n, d, W, B, dt, kind, timed, C in HIST_CLASS_CASES:
                hist_case(torch, hist, n, d, W, B, dt, kind, 40 + W + C, timed, tag, classes=C)
            results["hist exact"] = hist_exact_width(torch, hist, tag)
            for n, d, W, B, dt, kind, timed in HIST_WIDE_CASES:
                hist_case(torch, hist, n, d, W, B, dt, kind, 60 + W, timed, tag)

        def totals_cases():
            for n, W, kind, timed in TOTALS_CASES:
                r = totals_case(torch, hist, n, W, kind, 3 + W, timed, tag)
                if r is not None:
                    results["totals"] = r
            for n, W, kind, timed, C in TOTALS_CLASS_CASES:
                totals_case(torch, hist, n, W, kind, 30 + W + C, timed, tag, classes=C)

        phase("2 hist_kernel", hist_cases)
        phase("3 totals_kernel", totals_cases)
        launches, dtrain, dval = phase("4 slice", run_slice, torch, hist, pkg, tag)
        phase("5 small parity", run_small_parity, torch, pkg, tag)
        phase("6 profile", run_profile, torch, pkg, dtrain, dval, tag)
        phase("7 serve", run_serve, torch, pkg, hist, tag)
        phase("8 train entry", run_entry, torch, hist, tag)
        phase("9 multiclass", run_multiclass, torch, hist, pkg, tag)
        phase("10a ranking", run_ranking, torch, hist, pkg, tag)
        phase("10b lossguide", run_lossguide, torch, hist, pkg, dtrain, dval, tag)
        phase("11 sampling", run_sampling, torch, hist, pkg, dtrain, dval, tag)
        phase("12 mme", run_mme, torch, hist, tag)
        phase("13 boosters", run_boosters, torch, hist, pkg, dtrain, dval, tag)
        phase("14 methods", run_methods, torch, hist, pkg, dtrain, dval, tag)
        phase("15 formats", run_formats, torch, hist, dval, tag)
        phase("16 planes", run_planes, torch, hist, pkg, dtrain, dval, tag)
        phase("17 distributed", run_distributed, torch, hist, pkg, dtrain, dval, tag)
        phase("18 options across ranks", run_options, torch, hist, pkg, tag)
        phase("19 streaming ingest", run_streaming, torch, hist, tag)
        phase("20 elastic and consensus", run_elastic, torch, hist, tag)
        phase("21 local ranks", run_local_ranks, torch, tag)
        phase("22 elastic with local ranks", run_elastic_local, torch, tag)
        phase("23 native data plane", run_native, tag)
    except Exception as e:  # every phase failure ends the run non-zero
        print("FAILED: {}: {}".format(type(e).__name__, e), file=sys.stderr, flush=True)
        raise
    finally:
        import shutil

        if MODEL_ROOT is not None:
            shutil.rmtree(MODEL_ROOT, ignore_errors=True)
        if "tmp" in ELASTIC_KEPT:
            shutil.rmtree(ELASTIC_KEPT["tmp"], ignore_errors=True)

    total = sum(seconds for _name, seconds in PHASE_WALL)
    for name, seconds in PHASE_WALL:
        print("{} | wall phase {}: {:.1f} s ({:.1%} of {:.1f} s)".format(
            tag, name, seconds, seconds / total, total), flush=True)
    kernels = []
    for name, key in (("hist_kernel", HIST_MAIN), ("totals_kernel", "totals")):
        r = results[key]
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[name]}
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "shape")})
        if "device_ms" in r:
            entry["device_ms"] = r["device_ms"]
        kernels.append(entry)
    print(tag)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-probe"]:
        sys.exit(host_probe(sys.argv[2]))
    if sys.argv[1:2] == ["--load"]:
        sys.exit(load_child(sys.argv[2]))
    if sys.argv[1:2] == ["--entry-child"]:
        entry_child()
    if sys.argv[1:2] == ["--oom-child"]:
        sys.exit(oom_child(sys.argv[2]))
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2]))
    sys.exit(main())
