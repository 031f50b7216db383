#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, production, ranking,
preprocessing and multi-device paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root, on a machine with one card

Phases (any failure raises and exits non-zero):
  1. device    the card's name and power limit (nvidia-smi); fails without CUDA
  2. build     every CUDA source of the port, compiled by nvcc for sm_90a, one
               nvcc per source, all started together; the top-k pass 1's
               blocks per SM from the occupancy API; the host C++
               (csrc/host/furusato_host.cpp) by g++, whose failure fails the run
  3. kernels   each kernel against its plain PyTorch version on the card.
               masked_topk (d=64, M=20000, B in {1, 8, 64, 512}, k in
               {10, 20, 128}; and the tiling's edges: (M, d) in {(127, 32),
               (20001, 100), (20000, 30)}, B in {1, 33, 65, 1000}, k in
               {1, 20, 128}; k in {129, 200, 256} above csrc/streaming_topk.cu's
               128, through the radix select of csrc/streaming_topk_wide.cu,
               at (M, d) in {(20000, 64), (10000, 32)} for B in {1, 65, 512,
               2048}, and k = M = 300; the radix select also called directly
               at k in {1, 50, 128} (M = 10000, d = 32) and on tie-heavy
               tables: scores the sigmoid saturates, zero user rows, an item
               table of one repeated row, rows masked down to fewer than k
               items, and k = 10000 (its sort in device memory); each with
               and without mask and sigmoid, one user twice in a tile, one
               launch counted a call):
               (a) exact inputs (multiples of 1/8, duplicated items, one row
                   masked so densely that -1024 entries rank): ids and values equal
               (b) Gaussian inputs: values within rtol 1e-5 / atol 1e-6; ids equal
                   wherever the plain version's neighbouring values differ by
                   more than 1e-5 relative, the value multiset elsewhere
               the first call, and the radix select's first, run under
               torch.cuda.set_sync_debug_mode("error")
               scatter_add_rows ((N, R, D) = (50000, 8192, 64) and
               (20000, 16384, 64), the bench step's user and item gathers;
               R = 999; R = 0; one id 5,000 times; ids out of range, D = 50;
               and the kernel's edges: one id 285,000 times, ids that are all
               multiples of a tile's hash slot count, R = T - 1, T and T + 1
               under the item-side tree gather's tile plan, and the row mode
               forced at that gather's shape):
               (a) exact inputs (multiples of 1/8): bit-equal
               (b) Gaussian inputs: within 1e-5 + 1e-5 * (the sum of the
                   magnitudes added into the element): only the order of the
                   float32 sums differs, and with atomics it changes from run
                   to run
               the first call runs under torch.cuda.set_sync_debug_mode("error"):
               the wrapper never waits for the card
  4. serve     lgn, d=64, L=2, bfloat16 SpMM, on synthetic_dataset(50000 users,
               20000 items, avg degree 30, seed 0), random 0.1 * N(0, 1)
               parameters: Recommender on the card, requests of 1 / 8 / 64 / 512
               users at k = 10 and 20 and over HTTP, each answer held against
               the plain version under rule 3(b); propagation held against a
               float64 CPU propagation on the same rounded inputs
  5. numbers   the serve path's timings (printed at the end), and masked_topk
               at the evaluation's tile (B = 1024, k = 20)
  6. train     Trainer for lgn, d=64, L=2, bfloat16 SpMM, B=8192, lr 1e-3 on the
               same graph: test(), one warm-up epoch, two timed epochs,
               test(); the scatter kernel launched at least once per step and
               masked_topk once per evaluation tile; the loss of the last
               epoch below the first's; recall@20 above its value at
               initialisation
  7. card/CPU  two steps on the card and two on the CPU (plain versions) from
               the same parameters on the same batches (sampled on the card):
               losses within rtol 1e-5 (step 1) and 1e-4 (step 2); after two
               steps every parameter within 4 * lr, and all but 1e-3 of them
               within 1e-6 + 1e-5 * |p| (Adam's first steps are +-lr where a
               gradient is within rounding of 0, so a sign there may differ);
               one evaluation of the trained tables through masked_topk and
               through masked_topk_reference on the card: ids equal where
               neighbouring values differ by more than 1e-5 relative, metric
               sums equal (bit-equal when every id is)
  8. numbers   the train path's numbers (samples/s, the step split by
               torch.profiler into SpMM forward / backward, scatter, gather,
               sampler, Adam and the rest, the evaluation, the card's idle
               share)
  9. serve-textsage-100k
               the TextSAGE flagship (ddp_flagship_config: d=32, L=2, fanout 5,
               features n / w / t, bfloat16 SpMM) on synthetic_dataset(100000
               users, 30000 items, avg degree 8, seed 0) with
               synthetic_features(seed 0), random xavier parameters from a
               seeded generator: data and features built (host time), the
               index refreshed (host and device time), requests of 1 / 8 / 64
               / 512 users at k = 20 and two over HTTP, each answer held
               against the plain version under rule 3(b); the propagation on
               the card held against a CPU propagation of the same parameters
               (rtol 2e-2, atol 2e-3 x the largest magnitude: both round the
               SpMM operands to bfloat16, and a float32 sum on the other side of
               a rounding boundary moves an element by a bfloat16 step)
 10. train-textsage-100k
               Trainer(ddp_recipe=True), B=5000, lr 1e-3: an evaluation, a
               warm-up of 10 steps, one timed epoch (421 steps of alias-sampled
               triplets, fanout trees and dropout on the card), an evaluation;
               the loss of the epoch's last tenth below its first tenth's;
               scatter_add_rows launched twice a step (one tree gather per
               side), masked_topk once per evaluation tile; one evaluation
               through the kernel against the plain version (phase 7's rule);
               one --inference sample pass over all 130000 entities, timed;
               one step on the card and on the CPU from the same parameters on
               the same batch and trees, dropout 0: losses within rtol 1e-4,
               every parameter within 2 x lr, all but 1e-3 of them within 1e-6
               + 1e-5 |p| (Adam's first step is +-lr, so a gradient within
               rounding of 0 may take the other sign)
 11. numbers   one JSON line of kernels (time, plain time, library time,
               bound, launches on the main paths; masked_topk also at the
               evaluation's tile and at TextSAGE's d = 32 over 30000 items;
               scatter_add_rows at each shape: its plan (mode, T, blocks,
               shared memory), the kernel, its row mode forced and index_add_
               timed in ten alternating rounds, median and quartiles, each
               one's device time, and the global adds the plan implies for
               those ids, counted on the card outside the timed window; also
               at the TextSAGE step's tree gathers and a categorical gather),
               the serve and train lines of the lgn paths and of the TextSAGE
               paths (samples/s, host and device ms a step with the profiler's
               split, the idle share)
 12. train-textsage-20k
               the flagship recipe (eval tiles of 2048 users) on the anchor20k
               shape of the TPU records (benchmarks/anchor20k.py):
               synthetic_structured_dataset(20000, 10000, avg degree 8, seed
               0, rank 16, signal 3, popularity 0.8), 139,576 train edges, with
               informative_synthetic_features(seed 0). relin_every R = 8 for 6
               epochs: the loss falls, recall@10 at epoch 6 at least 0.10 (the
               records, at R = 1: 0.1533-0.1624); one epoch each of R = 0 (its
               loss only finite), feature_update_every T = 8 (the feature
               parameters bit-identical inside each super-step, moved at its
               end; optimizer step hooks) and dask (the numeric columns in
               .npy files under a temporary directory, read through
               MemmapNumeric; the numeric linears held inside the epoch and
               moved after it; stream_project on the card, in one chunk and
               in chunks of 2048 rows, equal to the in-core projection within
               rtol 1e-5; stream_project_grad in chunks of 2048 rows equal to
               X^T G within 1e-5 of the magnitudes summed into each element),
               the loss of T = 8 and dask falling from the epoch's first
               tenth to its last; scatter_add_rows launched twice a step and
               masked_topk once per evaluation tile over the whole phase; one
               evaluation of the R = 8 trainer through the kernel against the
               plain version (phase 7's rule); one R = 8 block and
               one T = 8 super-step on the card and on the CPU from the same
               parameters, batches and trees, dropout 0, each optimizer step
               under phase 10's rule from the CPU's state (the card takes the
               CPU's parameters and Adam moments after each step; held only
               at the end, a near-zero gradient's +-lr step grows over the
               steps after it: tools/card_vs_cpu_spread.py); then samples/s, host and device ms a step, device
               operations a step and the idle share for R = 1, R = 8, T = 8
               and dask at this shape, and train-textsage-100k at R = 8
               beside phase 10's R = 1 (a {"train_cadences": ...} line)
 13. attention-20k
               the attention SAGE models on phase 12's graph and features:
               serve-tgrec-20k (seeded xavier tgrec: the refresh held against a
               CPU propagation under phase 9's rule; requests of 1 / 8 / 64 /
               512 users at k = 20 and of 512 at k = 200, two more over HTTP,
               one at k = 200, each under rule 3(b), one masked_topk launch a
               request, the radix select's at k = 200); train-tgrec-20k (Trainer(ddp_recipe=True), R = 1, 3
               epochs between two evaluations: the last epoch's loss below the
               first's, recall@10 above its start); one epoch and one
               evaluation each of tgrec2, gnn --conv gat and gnn --conv
               transformer (the loss falling from the epoch's first tenth to
               its last); scatter_add_rows twice a step, masked_topk once a
               request and per evaluation tile; every evaluation
               held against the plain top-k (phase 7's rule); 4 tgrec steps on
               the card and on the CPU (phase 12's step-by-step rule); then the refresh's
               times, masked_topk at B = 512, k = 200 beside the library call
               and the bound, and each key's step numbers beside phase 12's
               TextSAGE R = 1 (a {"train_attention": ...} line)
 14. edge-20k  the edge-feature SAGE models on phase 12's graph and features:
               seeded relation sets (favourites: 30% of the train pairs drawn
               without replacement plus 10% of E uniform pairs; reviews: 10% of
               the train pairs; 209,362 message edges) written as the
               reference's two CSVs under a temporary directory and read
               through load_relation_edges into build_relational_graph, and
               uniform purchase times per train edge aligned to the user-CSR
               order. serve-rsage-20k (seeded xavier rsage add: the refresh
               held against a CPU propagation under phase 9's rule; requests
               of 1 / 8 / 64 / 512 users at k = 20 and two over HTTP, each under
               rule 3(b), one masked_topk launch a request); the refresh of
               rsage sum and prod, tgsrec and sasgnn each held against the CPU
               the same way; train-rsage-20k (Trainer(ddp_recipe=True), R = 1,
               3 epochs between two evaluations: the last epoch's loss below
               the first's, recall@10 above its start); one epoch and one
               evaluation each of rsage sum, rsage prod, tgsrec and sasgnn (the
               loss falling from the epoch's first tenth to its last);
               scatter_add_rows 4 times an rsage step (the two tree gathers and
               one relation-row gather a layer) and twice a tgsrec / sasgnn
               step, masked_topk once a request and per evaluation tile; every
               evaluation held against the plain top-k (phase 7's rule); 4
               rsage steps on the card and on the CPU (phase 12's
               step-by-step rule); the
               recency conv's first-maximum slot on the card as on the CPU
               over tied times; then the refresh times, each key's step
               numbers beside phase 12's TextSAGE R = 1 and phase 13's tgrec,
               and the relation-row scatter at (3, 450000, 32) and (3, 75000,
               32) from a step's labels: kernel, row mode, index_add_ and plain
               in ten alternating rounds (a {"train_edge": ...} line)
 15. sequence-attr-20k
               the sequence and attribute models on phase 12's graph and
               features: sasrec's item sequences (the train items in order,
               the last 50) and asage's attribute graphs (the categorical
               columns: 4 user and 5 item fields over 32 clusters).
               serve-sasrec-20k (seeded xavier sasrec at the anchor recipe of
               the JAX package's TPU record: d 64, L 2, features n / w / t)
               and serve-asage-20k (the flagship recipe): the refresh held
               against a CPU propagation, sasrec's at rtol 1e-4, atol 1e-5 x
               the largest magnitude (its items assembled per id, float32
               throughout), asage's under phase 9's rule; requests of 1 /
               8 / 64 / 512 users at k = 20 and two over HTTP, each under rule
               3(b), one masked_topk launch a request; train-sasrec-20k (B
               2048, lr 1e-3, decay 1e-6, the uniform sampler, 69 steps an
               epoch) and train-asage-20k (Trainer(ddp_recipe=True), R = 1),
               3 epochs each between two evaluations: the last epoch's loss
               below the first's, recall@10 above its start, sasrec's at
               least 0.013 (half the record's 0.0263 at epoch 3);
               scatter_add_rows twice a sasrec step (the item rows and the
               items' text-bag word rows) and 6 times an asage step (two tree
               gathers, two attribute-row gathers, the word rows of each
               side's entity levels), masked_topk once a request and per
               evaluation tile;
               every evaluation held against the plain top-k (phase 7's
               rule); 4 steps of each key on the card and on the CPU (phase
               12's step-by-step rule); then the refresh times, each key's step numbers
               beside phase 12's TextSAGE R = 1, and the new scatter shapes
               at the ids that one step's table gathers record (sasrec's
               item rows (10000, 106496, 64), their pad id included, and
               word rows (500, 360000, 32);
               asage's attribute rows (32, 25000, 32) and (32, 50000, 32) and
               word rows (500, 4680000, 16) and (500, 9360000, 16)): plan,
               kernel, row mode, index_add_ and plain in ten alternating
               rounds (a {"train_sequence": ...} line)
 16. production-20k
               the production tier on phase 12's graph and features, from the
               R = 8 TextSAGE trainer saved with Trainer.save after its 6
               epochs (nothing trains): the data written in the reference's
               layout under a temporary directory (cf/train.txt, test.txt and
               inference.txt, train + test per user; the features through
               write_reference_features), read back equal (the train CSR by
               load_text_dataset, every feature tensor bit-equal by
               load_reference_features); then as a user calls them, through
               tools.main with --data_path: evaluate --save_result (one
               masked_topk launch an evaluation tile; the metrics held against
               the restored trainer's own evaluation under phase 7's rule;
               one CSV row per test user, its predict_ids the evaluation's
               top topks[0]), two infer calls inside obs.profiler.trace
               (--user_batch 1000 --target_batches 0,9,25 --k 20, batch 25
               skipped with the JAX package's line; --target_batches 19 --k
               200 in one radix-select launch: 1 + 1 + 1 launches), each CSV's
               ids held against masked_topk_reference over a
               Recommender(use_inference_edges=True) of the same checkpoint
               under rule 3(b), no train positive predicted, at least one
               user's top 20 otherwise over the train edges alone, the trace
               naming the kernel, device_memory_stats logged through
               log_device_memory (0 < in use <= peak <= the card's, above
               70,000 MiB); recommend --users 3,17,19999 --k 10 (one launch),
               each line under rule 3(b); the launch counts set to 0 before
               each call and read after it; then the host seconds of each
               call's parts and masked_topk at B = 1000, k = 20 and 200, its
               device time from a profile that recorded every operation of
               its calls (2 a call at k = 20; at k = 200 the radix passes,
               the sort and the fill: 9; a {"production": ...} line with the
               card's name and power limit)
 17. rank-20k  the two-stage ranker on phase 12's graph and features, from
               phase 16's data directory, as tools/rank20k_torch.py runs the
               JAX record's protocol (benchmarks/rank20k.py) with the epochs
               cut: the for_lgbm split read by load_text_dataset (128,736
               reduced and 10,840 held edges, the record's); lgn (d 32, B
               2048, lr 0.01) and TextSAGE (the flagship recipe) trained 6
               epochs on the reduced set, each user's top 50 dumped
               (dump_candidates, 10 masked_topk launches a dump, sigmoid
               off); the parity and aux groups; the parity ranker and the aux
               ranker (15 warm epochs on wa alone, the users % 5 != 0 groups)
               fitted 10 epochs (NeuralRanker at its defaults, 256 groups a
               batch, lr 1e-3: one scatter_add_rows launch a joint step, none
               a warm one); both retrievers retrained 6 epochs on the full set
               and dumped again; rerank_eval of the parity, aux and
               val-calibrated stack rankers; then tools dump-candidates from
               phase 12's R = 8 checkpoint (20 launches at its batch of 1024),
               train-ranker --epochs 1 on that dump and rerank-eval of that
               ranker; the launch counts set to 0 before each part and read
               after it. Checks: every dump against masked_topk_reference
               (sigmoid off) on the embeddings the dump scored (a
               propagation does not repeat itself bit for bit on the card)
               under rule 3(b) against a plain top (k + 1), neighbouring
               values within 2 x atol counted as ties, rows unique, no train
               positive; the trainer's evaluation against the plain top-k on
               its own embeddings, and the stage-B dumps' first 10 columns
               against it (the same ids but near-ties; recall@10 equal when
               no id moved); the parity loss on 2048
               groups below its value at the fit's initial parameters; 4
               ranker steps on the card against the CPU (phase 10's rule, each
               step from the CPU's state); rank() in tiles of 2048 against one
               tile (ids equal but near-ties); the stack's recall@10 above the
               parity rerank's and at least 0.95 x the best retriever alone;
               then the host seconds of each part, masked_topk at the dump's
               shape (B 2048, k 50, unmasked, sigmoid off) beside the same
               call through the radix select, matmul + torch.topk and
               torch.topk alone, scatter_add_rows at the ids
               of one real ranker step (N 32, R 256 x C x 9, D 16), rank() at
               4096 users x 100 candidates (a {"rank": ...} line with the
               card's name and power limit)
 18. preprocess-20k
               preprocessing on the host, then training on its output:
               synthetic_raw_tables(seed 0) written as CSV files under a
               temporary directory (20,000 customers; 12,000 product rows that
               dedup to the 10,000 planted products; 1,741 partners; 40
               categories; about 180,000 transactions; 20,000 reviews);
               tools preprocess --incremental_frac 0.1 --test_holdout 1 run
               twice into two directories, every file byte-equal between
               them, n_product the planted count; load_text_dataset and
               load_reference_features read the directory back (user
               features n / c / t, item features n / c / t / s / r, as
               tests/test_full_chain.py trains), the shapes those of the
               summary; tools convert-recbole --k_core 5 --iterate on the
               transactions, its .inter read back by read_recbole with every
               user and item at 5 rows or more; the flagship recipe
               (Trainer(ddp_recipe=True), d 32, L 2, fanout 5, B 5000, tiles
               of 2048 users) for 3 epochs between two evaluations: the last
               epoch's loss below the first's, recall@10 above its start,
               scatter_add_rows 4 times a step (a tree gather and a
               categorical gather a side) and masked_topk once per
               evaluation tile, counted from 0 over the training; one
               evaluation against the plain top-k (phase 7's rule); 2 steps
               on the card against the CPU (phase 12's step-by-step rule);
               then the host seconds of each stage of both runs and of
               cuckoo_build at this phase's edges and at phase 6's (a
               {"preprocess": ...} line with the card's name and power limit)
 19. mesh-20k  the (data, model) mesh of torch.distributed at (2, 2): 4 rank
               processes, all on cuda:0, collectives over gloo (NCCL refuses
               two ranks on one card), each building its Trainer from phase
               16's data directory as a user does. The cases of MESH_CASES:
               the DDP flagship (textsage, ddp_flagship_config, d 32), lgn (d
               64), lgn under the in-batch InfoNCE (loss_fn infonce) and
               asage with its views' InfoNCE (ssl_weight 0.1), all with the
               ddp recipe and float32 SpMM operands (MESH_DTYPE says why); the
               two InfoNCE cases score each data rank's rows against the whole
               batch's, gathered over the data axis, whose backward sums the
               rows' gradients over it. Each case against the same config,
               seed and draws in one process on the card: 2 steps from fresh
               parameters on the same batches under
               phase 7's rule (losses within rtol 1e-5 and 1e-4, every
               parameter within 4 x lr, all but 1e-3 of them within 1e-6 +
               1e-5 |p|), the first step's gradients within 1e-6 + 1e-4 x
               their tensor's largest magnitude, their launches counted from
               0 (asage-ssl runs these steps alone); then an evaluation, 2
               epochs (lgn-infonce 1) and an evaluation: losses within rtol
               MESH_LOSS_RTOL,
               metrics within MESH_METRIC_ATOL, every parameter within
               MESH_PARAM_LRS x lr (the scatter's atomic adds and the GEMMs
               over a data rank's rows round otherwise, and Adam turns a
               near-zero gradient's rounding into +-lr; two one-process
               runs of textsage are printed beside them); the four ranks
               bit-equal to rank 0 in losses, metrics, the first step's
               gradients, whole parameters and Adam moments (the replicas
               must not drift apart); textsage saved with Trainer.save on
               every rank: rank 0 alone writes, the keys and shapes of the
               one-process checkpoint, whole tables and moments bit-equal to
               the ranks', the one-process run's generator state (the mesh
               draws what one process draws), and a one-process Trainer
               restores it and evaluates within MESH_RESTORE_ATOL of the
               mesh; on every rank scatter_add_rows launched 2 times a
               textsage step, 4 times an lgn step and 6 times an asage step,
               masked_topk once a tile of each evaluation (the rank's half of
               each tile of 2048 users against its half of the catalog),
               counted from 0 over each path, every launch at one of its
               case's shapes, which phase 3 holds against the plain
               versions; each rank's MiB of row-sharded parameters and Adam
               moments against the whole tables'; sharded_masked_topk at (M,
               d) = (10000, 32) and (10000, 64), the rank's 1024 of 2048
               users, k in {20, 200} against the plain top-k over the whole
               catalog (rule 3(b)), and sharded_embedding_lookup's rows
               (equal) and gradient (within 1e-5 + 1e-5 x the magnitudes
               summed into the element) against the plain gather and scatter
               at 285,000 ids over the 10000-row table; then in one more
               process a one-rank NCCL world runs every collective helper and
               those two checks once. Its samples/s are 4
               processes sharing one card through host-memory collectives:
               printed and so labelled, no scaling claim (a {"mesh": ...}
               line)
 20. registry-20k
               the registry keys that no other phase drives (REG_KEYS), on
               phase 12's graph and features (run after phase 15): mf, rgcn,
               radj (r 0.5, the CLI's default) and lgcnssm at phase 19's lgn
               recipe (d 64, B 5000, lr 1e-3, decay 1e-6, bfloat16 SpMM
               operands, the uniform sampler with cuckoo rejection), and
               textsage_id, sage, fsage, fastsage, lightsage, pinsage, mrec,
               nssage, gnn --conv gcn (the CLI's default conv) and gnn --conv
               ggnn at the flagship recipe (Trainer(ddp_recipe=True), features
               n / w / t: no JAX constructor of these keys needs another
               flag). Each served (serve_20k: requests of 1 / 8 / 64 / 512
               users at k = 20 and two over HTTP, each under rule 3(b), no
               train positive served, one masked_topk launch a request; the
               refresh against the CPU's propagation, mf and the LightGCN keys
               under phase 4's rule against a float64 one, the SAGE keys under
               phase 9's), then trained: mf, rgcn and textsage_id 3 epochs
               between two evaluations (the last epoch's loss below the
               first's, recall@10 above its start but mf's: RECALL_FLAT),
               every other key one epoch and one evaluation (the loss falling
               from the epoch's first tenth to its last); scatter_add_rows
               scatter_per_step(key) times a step, masked_topk once a request
               and per evaluation tile, counted from 0 over the whole path and
               asserted exactly; every launch's shape recorded and held among
               those phase 3 checked; every evaluation held against the plain
               top-k (phase 7's rule); 2 steps of each key on the card and on
               the CPU (phase 12's step-by-step rule); then each refresh's
               host and device times, each key's step numbers, and the
               scatter at the ids of one textsage_id step's tree gathers at
               node width 64 (a {"registry": ...} line with the card's name
               and power limit)

Kernel cases at TextSAGE's shapes join phase 3: masked_topk at d = 32, M =
30000, B in {1, 64, 512, 1024}, k in {10, 20}, and at phase 12's evaluation
tile (M = 10000, B = 2048); scatter_add_rows at (N, R, D) = (100000, 180000,
32), (30000, 285000, 32) (a step's tree gathers, Zipf(1.2) ids here, ids of
sampled trees in phase 11), (40, 400000, 32), all in tile mode, and the same
gathers on phase 12's graph, (20000, 180000, 32) and (10000, 285000, 32); and
rsage's relation-row gathers of phase 14, (3, 450000, 32) and (3, 75000, 32),
labels drawn in the message graph's shares; and phase 15's: sasrec's item rows
(10000, 106496, 64), 0.86 of them the pad id 0, asage's attribute rows
(32, 25000, 32) and (32, 50000, 32), and the text bags' word rows (500,
360000, 32) and (500, 4680000, 16), half of them pads on word 0; and phase
17's: masked_topk at k = 50 over the anchor20k catalog in tiles of 2048 and
1024 users, and scatter_add_rows at (32, 255744, 16), the ranker step's
categorical rows; and phase 19's, a (2, 2) mesh rank's: masked_topk at (B,
M, d) = (1024, 5000, 32) and (1024, 5000, 64), k in {10, 20}, each model
rank's block under the local CSR that local_mask builds from a whole train
mask, and scatter_add_rows at (20000, 90000, 32), (10000, 142500, 32),
(20000, 2500, 64) and (10000, 5000, 64), the rank's half of textsage's tree
gathers and of lgn's batch rows, and at (32, 12500, 32), (32, 25000, 32),
(500, 12480000, 16) and (500, 24960000, 16), the rank's half of asage's
attribute rows and of its word rows (the text read back 64 words wide); and
phase 20's: masked_topk at (M, d) = (10000, 64) and (10000, 32), B in {1, 2,
8, 64, 512, 2048}, k in {10, 20}, and scatter_add_rows at (20000, 180000, 64)
and (10000, 285000, 64), the id-embedding keys' tree gathers, and at (20000,
5000, D) and (10000, 10000, D) for D = 64 and 32, the batch rows that mf and
the LightGCN keys (D = 64) and nssage (D = 32) gather from whole tables.

A device profile (torch.profiler) counts the kernels of a range of n calls,
after 512 one-element kernels that take the records a session drops at its
start and a 50 ms sleep; masked_topk's profiles must hold pass 1 and the merge
of every call, or are taken again (three at most).

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import glob
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

from furusato_recommend_tpu_torch.config import Config, MeshConfig, ddp_flagship_config
from furusato_recommend_tpu_torch import tools as ttools
from furusato_recommend_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_numpy,
    flatten_params,
    params_from_jax,
    params_to_numpy,
)
from furusato_recommend_tpu_torch.core.checkpoint import load_checkpoint
from furusato_recommend_tpu_torch.core.distributed import initialize_multihost, shutdown
from furusato_recommend_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from furusato_recommend_tpu_torch.data import synthetic_dataset
from furusato_recommend_tpu_torch.data.artifacts import (
    synthetic_edge_times,
    write_edge_artifacts,
    write_reference_features,
    write_text_dataset,
)
from furusato_recommend_tpu_torch.data.dataset import load_text_dataset, synthetic_structured_dataset
from furusato_recommend_tpu_torch.data.features import (
    edge_time_in_csr_order,
    informative_synthetic_features,
    load_reference_features,
    load_relation_edges,
    synthetic_features,
)
from furusato_recommend_tpu_torch.data.graph import CSR, build_relational_graph
from furusato_recommend_tpu_torch.data.ooc import MemmapNumeric, stream_project, stream_project_grad
from furusato_recommend_tpu_torch.eval.metrics import batch_metric_sums
from furusato_recommend_tpu_torch.eval.sharded import item_block, local_mask, sharded_masked_topk
from furusato_recommend_tpu_torch.data.sequence import build_sequences
from furusato_recommend_tpu_torch.models import asage, sage, sasrec
from furusato_recommend_tpu_torch.models.lightgcn import LightGCN
from furusato_recommend_tpu_torch.models.registry import SAGE_KEYS, build_model
from furusato_recommend_tpu_torch.models.sage_convs import N_HEADS, edge_feature, get_conv
from furusato_recommend_tpu_torch.obs.log import MetricLogger
from furusato_recommend_tpu_torch.obs.profiler import log_device_memory, trace
from furusato_recommend_tpu_torch.ops import _cuda
from furusato_recommend_tpu_torch.ops import scatter as sc
from furusato_recommend_tpu_torch.ops import streaming_topk as st
from furusato_recommend_tpu_torch.ops.csr_search import csr_gather_padded
from furusato_recommend_tpu_torch.ops.cuckoo import build_cuckoo_set
from furusato_recommend_tpu_torch.ops.sharded_embedding import sharded_embedding_lookup
from furusato_recommend_tpu_torch.preprocessing import native
from furusato_recommend_tpu_torch.preprocessing.filtering import read_recbole
from furusato_recommend_tpu_torch.preprocessing.pipeline import STAGES as PRE_PIPELINE_STAGES
from furusato_recommend_tpu_torch.preprocessing.synthetic import synthetic_raw_tables
from furusato_recommend_tpu_torch.rank.pipeline import _compact_rows, _dedup_rows
from furusato_recommend_tpu_torch.rank.ranker import NeuralRanker, epoch_batches
from furusato_recommend_tpu_torch.sampling.bpr import sample_bpr
from furusato_recommend_tpu_torch.serve import Recommender, make_server
from furusato_recommend_tpu_torch.train.trainer import Trainer

SEED = 0
D, M_KERNEL, N_KERNEL = 64, 20000, 600
TILES = (1, 8, 64, 512)
EVAL_TILE = 1024  # the evaluator's users per masked_topk call (eval_user_batch)
# (M, d) of the top-k tiling's edges: M not a multiple of the item tile, d
# resident and in chunks, d not a multiple of 4
TOPK_EDGES = ((127, 32), (20001, 100), (20000, 30))
# k above csrc/streaming_topk.cu's MAX_K = 128, through the radix select:
# (M, d), B and k
TOPK_WIDE_SHAPES = ((20000, 64), (10000, 32))
TOPK_WIDE_TILES = (1, 65, 512, 2048)
TOPK_WIDE_KS = (129, 200, 256)
WIDE_DIRECT_KS = (1, 50, 128)  # k at which phase 3 calls the radix select directly
# H100 SXM published peaks (dense, 700 W): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
RTOL, ATOL, TIE_RTOL = 1e-5, 1e-6, 1e-5
# the bench.py training step: B = 8192 triplets gather 8192 user rows and
# 16384 item rows (positives and negatives in one gather)
TRAIN_B, TRAIN_LR = 8192, 1e-3
SCATTER_SHAPES = ((50_000, 8_192), (20_000, 16_384))  # (N, R) at D = 64
SC_TOL = 1e-5
# the TextSAGE flagship: the shape of benchmarks/textsage_bench.py
TS_USERS, TS_ITEMS, TS_DEGREE = 100_000, 30_000, 8
TS_D = 32
TS_TILES = (1, 8, 64, 512)
TS_K = 20
TS_WARMUP = 10
# (N, R) of a flagship step's two tree gathers at D = 32 (B = 5000, fanout 5,
# L = 2: users 5000 + 2 x 25000 + 125000, items 25000 + 2 x (5000 + 125000)),
# and a categorical gather (100000 users x 4 fields into 40 categories)
TS_SCATTER = ((TS_USERS, 180_000), (TS_ITEMS, 285_000), (40, 400_000))
# the anchor20k shape (benchmarks/anchor20k.py): a structured 20k x 10k graph
# with informative features, whose TPU records (benchmarks/results/
# anchor20k_textsage_tpu_inf_s*.jsonl, relin_every 1) reach recall@10
# 0.1533-0.1624 at epoch 6 and passed 0.10 by epoch 3 in every seed
A20_USERS, A20_ITEMS, A20_EDGES = 20_000, 10_000, 139_576
A20_EPOCHS, A20_RECALL10_FLOOR, A20_RECORDS_EPOCH6 = 6, 0.10, (0.1533, 0.1624)
A20_EVAL_TILE = 2048  # the anchor20k evaluation's users per masked_topk call
OOC_CHUNK = 2048  # rows a streamed chunk takes in the dask check: ten chunks
# phase 13: the attention SAGE models on the anchor20k graph ((registry key,
# config fields); tgrec first, trained longest), a request above k = 128 (the
# radix select), tgrec's epochs and its steps against the CPU
ATT_KEYS = (("tgrec", {}), ("tgrec2", {}), ("gnn", {"conv": "gat"}), ("gnn", {"conv": "transformer"}))
ATT_K = 200
ATT_EPOCHS = 3
ATT_STEPS_VS_CPU = 4
ATT_PROFILE_STEPS = 8
# phase 14: the edge-feature SAGE models on the anchor20k graph (rsage add
# first, trained longest), rsage's steps against the CPU, and the relation
# rows a layer of a step gathers from rsage's 3-row table: 3 x (B F + B F^2)
# for layer 0 and 3 x B F for layer 1 (B = 5000, F = 5), the label shares of
# the message graph (purchases, favourites, reviews: 1 : 0.4 : 0.1)
EDGE_KEYS = (("rsage", {"multi_relational": "add"}), ("rsage", {"multi_relational": "sum"}),
             ("rsage", {"multi_relational": "prod"}), ("tgsrec", {}), ("sasgnn", {}))
EDGE_EPOCHS = 3
EDGE_STEPS_VS_CPU = 4
REL_ROWS = (450_000, 75_000)
REL_SHARES = (1 / 1.5, 0.4 / 1.5, 0.1 / 1.5)
# phase 15: the sequence and attribute models on the anchor20k graph. sasrec
# at the anchor recipe of the JAX package's TPU record (benchmarks/anchor20k.py
# sasrec: d 64, L 2, B 2048, lr 1e-3, decay 1e-6, features n / w / t, the
# uniform sampler; benchmarks/results/anchor20k_sasrec_tpu_s0.jsonl reads
# recall@10 0.0263 at epoch 3), asage at the flagship recipe; a sasrec step
# gathers B x 50 sequence rows and B positives and B negatives from the item
# table, an asage step B F user and 2 B F item attribute rows (B = 5000, F =
# 5); both assemble entities per id, whose text bags gather word rows (3
# fields of 12 slots an entity, pads read word 0) from the 500-word table:
# sasrec every item's (d / 2 = 32 wide), asage the attribute trees' entity
# levels' (B + B F^2 users, 2 (B + B F^2) items; 16 wide)
SEQ_KEYS = (("sasrec", {}), ("asage", {}))
SEQ_EPOCHS = 3
SEQ_RECALL10_FLOOR, SEQ_RECORD_EPOCH3 = 0.013, 0.0263
SEQ_STEPS_VS_CPU = 4
SEQ_B, SEQ_D = 2048, 64
SEQ_ROWS = SEQ_B * 52
SEQ_ATTRS, SEQ_WORDS = 32, 500  # attributes a side, words of the text vocabulary
ATTR_ROWS = (25_000, 50_000)
WORD_ROWS = (360_000, 4_680_000, 9_360_000)
# the scatter launches a step of each key makes with the features n / w / t:
# one a table gather (rsage: two tree gathers and a relation-row gather a
# layer; sasrec: the item rows and the items' word rows; asage: two tree
# gathers, two attribute-row gathers and the word rows of each side's entity
# levels; the LightGCN keys: the batch rows from the propagated and from the
# ego tables; every other key 2: mf's batch rows, the other SAGE keys' tree
# gathers, nssage's batch rows from its full propagation), as
# tests/test_torch_registry.py counts the table gathers on the CPU
SCATTER_PER_STEP = {"rsage": 4, "sasrec": 2, "asage": 6, "lgn": 4, "rgcn": 4, "radj": 4, "lgcnssm": 4}
CADENCE_BLOCK = 8  # R = 8 and T = 8
# phase 16: the infer calls' batch of users (the reference's USER_BATCH_SIZE)
# and k, recommend's users and k, and the top-k kernel's names in a trace
PROD_BATCH, PROD_K = 1000, 20
PROD_USERS, PROD_REC_K = (3, 17, A20_USERS - 1), 10
TOPK_KERNEL_NAMES = ("score_segments", "wide_radix_pass")
# phase 17: the two-stage ranker (tools/rank20k_torch.py's protocol) with the
# retrievers' and the rankers' epochs cut from the record's 30 and 40; the
# dumps' k and batch (tools dump-candidates' default batch: 1024); a ranker
# step's categorical rows at the record's group width, 256 groups x 111
# candidates x 9 columns into the 32-row table at emb 16 (phase 3's case)
RANK_RETRIEVER_EPOCHS, RANK_RANKER_EPOCHS, RANK_STEPS_VS_CPU = 6, 10, 4
RANK_K, RANK_DUMP_B, RANK_TOOL_B = 50, 2048, 1024
RANK_ROWS, RANK_VOCAB, RANK_EMB = 256 * 111 * 9, 32, 16
RANK_STACK_OF_BEST = 0.95  # the stack's recall@10 against the best retriever alone
RANK_LATENCY_USERS, RANK_LATENCY_WIDTH = 4096, 100
# phase 18: tools preprocess on synthetic_raw_tables' default sizes (20,000
# customers, 12,000 product rows of 10,000 products, 1,741 partners, 40
# categories, 20,000 reviews), then the flagship recipe on its output with
# the features tests/test_full_chain.py trains with; the card's steps held
# against the CPU
PRE_UNIQUE = 10_000
PRE_FEATURES = {"user_feature": "nct", "item_feature": "nctsr"}
PRE_EPOCHS, PRE_STEPS_VS_CPU, PRE_RECBOLE_K = 3, 2, 5
PRE_STAGES = ("read",) + PRE_PIPELINE_STAGES
# phase 19: the (data, model) mesh of 4 ranks on card 0 over gloo; lgn's
# width; the epochs between the two evaluations; float32 SpMM operands (under
# bfloat16 each data rank rounds its own cotangent before the transposed SpMM,
# where one process rounds their sum: the gradients then differ by up to 2^-8
# relative, and Adam turns a near-zero one's sign into +-lr). Against one
# process: the first steps from the same state, the first step's gradients
# within 1e-6 + MESH_GRAD_RTOL x their tensor's largest magnitude (a missing
# or doubled term shows there, which Adam's scale invariance hides in the
# parameters), the parameters under phase 7's rule; after 2 epochs the losses
# within MESH_LOSS_RTOL (the JAX package's mesh tests'), the metrics within
# MESH_METRIC_ATOL, every parameter within MESH_PARAM_LRS x lr: the scatter
# kernel's atomic adds sum in no fixed order, so one process does not repeat
# itself bit for bit on the card either, and over 168 steps Adam turns that
# rounding into +-lr moves where a gradient is near 0 (the phase prints two
# one-process runs' spread beside the mesh's). The four ranks are held bit-equal
# to one another: world-averaged gradients leave no replica to drift. The
# checkpoint restored into one process evaluates within MESH_RESTORE_ATOL of the
# mesh (the same parameters; only the merge's and the sums' order differ).
# The sharded top-k's users and k, and the sharded lookup's ids (a step's
# item-side tree gather, B = 5000)
MESH = (2, 2)
MESH_LGN_D = 64
MESH_EPOCHS = 2
MESH_DTYPE = "float32"
MESH_FIRST_STEPS = 2
MESH_GRAD_RTOL = 1e-4
MESH_LOSS_RTOL = 2e-3
MESH_METRIC_ATOL = 1e-2
MESH_PARAM_LRS = 10
MESH_TOPK_B = A20_EVAL_TILE  # a data rank scores its half, as on the path
MESH_TOPK_KS = (20, 200)
MESH_RESTORE_ATOL = 1e-6
MESH_LOOKUP_R = 285_000
MESH_TIMEOUT_S = 600
# the kernels' shapes on a rank of the (2, 2) mesh's path, checked against
# their plain versions in phase 3 and held against the shapes every rank's
# path launches: scatter_add_rows (N, R, D) at the rank's half of textsage's
# tree gathers and of lgn's batch rows (the propagated and the ego tables);
# masked_topk (B, M, d, k) at the rank's half of a tile against its half of
# the catalog, in local ids under its local_mask CSR
MESH_B = ddp_flagship_config().bpr_batch_size
MESH_EVAL_K = 20
MESH_SSL_WEIGHT = 0.1
_MESH_TREES = ((A20_USERS, TS_SCATTER[0][1] // MESH[0], TS_D), (A20_ITEMS, TS_SCATTER[1][1] // MESH[0], TS_D))
_MESH_LGN = ((A20_USERS, MESH_B // MESH[0], MESH_LGN_D), (A20_ITEMS, 2 * MESH_B // MESH[0], MESH_LGN_D))
# asage's attribute rows (the first level of a rank's B / 2 user and B
# positive and negative seeds' attribute trees, F = 5 a seed) and the word
# rows of its entity levels (the seeds and the second level: B / 2 (1 + F^2)
# users, twice as many items), each entity 3 text fields of the width a data
# directory's text is read at (phase 15's features are 12 wide)
MESH_F, MESH_TEXT_WIDTH = ddp_flagship_config().num_neighbors, 64
_MESH_ENTITIES = MESH_B // MESH[0] * (1 + MESH_F**2)
_MESH_ATTR = ((SEQ_ATTRS, MESH_B // MESH[0] * MESH_F, TS_D), (SEQ_ATTRS, 2 * MESH_B // MESH[0] * MESH_F, TS_D),
              (SEQ_WORDS, _MESH_ENTITIES * 3 * MESH_TEXT_WIDTH, TS_D // 2),
              (SEQ_WORDS, 2 * _MESH_ENTITIES * 3 * MESH_TEXT_WIDTH, TS_D // 2))


def _mesh_topk_shape(d: int) -> tuple:
    return A20_EVAL_TILE // MESH[0], -(-A20_ITEMS // MESH[1]), d, MESH_EVAL_K


# phase 19's cases, each a config on phase 16's data directory beside the
# others' (over a20_config, float32 SpMM operands) held against one process:
# its config fields and model keyword arguments, the epochs of its path
# between two evaluations (0: no path; its first steps are what it launches),
# the scatter launches a step, and the (N, R, D) / (B, M, d, k) of every
# launch on a rank. lgn-infonce scores each data rank's rows against the whole
# batch's positives, asage-ssl its views' rows against the whole batch's
# other view: both gather rows over the data axis, whose backward sums over it
MESH_CASES = {
    "textsage": {"over": {}, "model_kw": {}, "epochs": MESH_EPOCHS, "scatter_per_step": 2,
                 "scatter_shapes": _MESH_TREES, "topk_shapes": (_mesh_topk_shape(TS_D),)},
    "lgn": {"over": {"model": "lgn", "latent_dim": MESH_LGN_D}, "model_kw": {}, "epochs": MESH_EPOCHS,
            "scatter_per_step": 4, "scatter_shapes": _MESH_LGN, "topk_shapes": (_mesh_topk_shape(MESH_LGN_D),)},
    "lgn_infonce": {"over": {"model": "lgn", "latent_dim": MESH_LGN_D, "loss_fn": "infonce"}, "model_kw": {},
                    "epochs": 1, "scatter_per_step": 4, "scatter_shapes": _MESH_LGN,
                    "topk_shapes": (_mesh_topk_shape(MESH_LGN_D),)},
    "asage_ssl": {"over": {"model": "asage"}, "model_kw": {"ssl_weight": MESH_SSL_WEIGHT}, "epochs": 0,
                  "scatter_per_step": 6, "scatter_shapes": _MESH_TREES + _MESH_ATTR, "topk_shapes": ()},
}
MESH_SCATTER_SHAPES = tuple(sorted({x for case in MESH_CASES.values() for x in case["scatter_shapes"]}))
MESH_TOPK_SHAPES = tuple(sorted({x for case in MESH_CASES.values() for x in case["topk_shapes"]}))
# phase 20: the registry keys that no other phase drives, on the anchor20k
# graph and features, in two families: the MF / LightGCN keys at phase 19's
# lgn recipe (d 64, B 5000, lr 1e-3, decay 1e-6, bfloat16 SpMM operands, the
# uniform sampler) and the SAGE keys at the flagship recipe; mf, rgcn and
# textsage_id trained REG_EPOCHS, the others one epoch. Their new scatter shapes
# (N, R, D): the id-embedding keys' tree gathers at node width 2d, and the
# batch rows that mf and the LightGCN keys (d 64) and nssage (d 32) gather
# from whole tables (B users, B positives and B negatives)
REG_KEYS = (("mf", {}), ("rgcn", {}), ("radj", {}), ("lgcnssm", {}), ("textsage_id", {}), ("sage", {}),
            ("fsage", {}), ("fastsage", {}), ("lightsage", {}), ("pinsage", {}), ("mrec", {}), ("nssage", {}),
            ("gnn", {"conv": "gcn"}), ("gnn", {"conv": "ggnn"}))
# (keys, how many of them train REG_EPOCHS): mf's recall@10 does not rise
# in 3 epochs (RECALL_FLAT), so the LightGCN family's rise is held on rgcn,
# which trains as long
REG_FAMILIES = ((REG_KEYS[:4], 2), (REG_KEYS[4:], 1))
REG_LGN_D = MESH_LGN_D
REG_ID_KEYS = ("textsage_id", "sage", "fsage")
REG_EPOCHS = 3
REG_STEPS_VS_CPU = 2
# keys whose recall@10 is printed, not held to rise, after their epochs: mf's
# N(0, 1) tables (the reference's init) move at most lr = 1e-3 an Adam step,
# 0.084 in 3 epochs of 28 steps, so its random ranking stands; its loss is
# held to fall over the epochs
RECALL_FLAT = ("mf",)
# keys whose steps against the CPU run at float32 SpMM operands: nssage's step
# is the whole propagation, its bfloat16 operands rounded forward and
# backward over every node; the card's and the CPU's float32 sums differ in
# order, a bfloat16 rounding of a cotangent then lands a step apart, and the
# feature parameters at the end of that chain part past phase 7's rule (as
# the mesh's data ranks did: MESH_DTYPE)
REG_FLOAT32_VS_CPU = ("nssage",)
_REG_B = ddp_flagship_config().bpr_batch_size
REG_SCATTER_SHAPES = ((A20_USERS, TS_SCATTER[0][1], 2 * TS_D), (A20_ITEMS, TS_SCATTER[1][1], 2 * TS_D)) + tuple(
    (n, r, d) for d in (REG_LGN_D, TS_D) for n, r in ((A20_USERS, _REG_B), (A20_ITEMS, 2 * _REG_B)))
# profiler ranges (ops/segment.py, ops/scatter.py, sampling/bpr.py,
# sampling/neighbor.py, eval/evaluate.py, torch.optim's own) and the step part
# each one names
RANGES = {
    "spmm_fwd": "spmm_fwd", "spmm_bwd": "spmm_bwd", "table_gather": "gather",
    "scatter_add_rows": "scatter", "sample_bpr": "sampler", "evaluate": "eval",
    "sample_neighbors": "trees", "Optimizer.step#Adam.step": "adam",
}
# the port's kernels, launched through ctypes outside any torch operation
OWN_KERNELS = {
    "scatter_add_rows_kernel": "scatter", "scatter_tile_kernel": "scatter",
    "score_segments": "masked_topk",
    "merge_segments": "masked_topk",
    "wide_radix_pass": "masked_topk",
    "wide_sort_rows": "masked_topk",
}


def log(*a):
    print(*a, flush=True)


def compare(kv, ki, rv, ri, exact: bool, tie_atol: float = 0.0) -> float:
    """Rule 3 of the module docstring; returns the max abs value error.
    ``tie_atol``: neighbouring values closer than that are ties too (scores
    near 0, whose rounding error is not relative to them)."""
    kv, ki, rv, ri = (x.cpu().numpy() for x in (kv, ki, rv, ri))
    if exact:
        np.testing.assert_array_equal(ki, ri)
        np.testing.assert_array_equal(kv, rv)
        return 0.0
    np.testing.assert_allclose(kv, rv, rtol=RTOL, atol=ATOL)
    gap = np.abs(np.diff(rv, axis=1)) > TIE_RTOL * np.abs(rv[:, 1:]) + tie_atol
    sep = np.ones(ri.shape, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(ki[sep], ri[sep])
    np.testing.assert_allclose(np.sort(kv, axis=1), np.sort(rv, axis=1), rtol=RTOL, atol=ATOL)
    return float(np.abs(kv - rv).max())


def _topk_cases(dev, rng, n, m, d, tiles, ks, first_checked, topk=None) -> tuple:
    """masked_topk (or ``topk``: st.masked_topk_wide) against its plain
    version on one (N, M, d); returns (cases, max abs err). The first call
    runs under sync debug mode "error" unless ``first_checked``."""
    topk = st.masked_topk if topk is None else topk
    exact_u = (rng.integers(-4, 5, size=(n, d)) / 8).astype(np.float32)
    exact_i = (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32)
    exact_i[1::2] = exact_i[0::2][: m // 2]  # every item has a twin: ties
    scale = 0.3 * (64 / d) ** 0.5
    gauss_u = (scale * rng.standard_normal((n, d))).astype(np.float32)
    gauss_i = (scale * rng.standard_normal((m, d))).astype(np.float32)
    rows = []
    for u in range(n):
        # row 0 leaves 50 items unmasked: at k > 50, -1024 entries rank; it
        # is longer than the kernel stages in shared memory
        deg = m - 50 if u == 0 else int(rng.integers(0, min(m, 80)))
        rows.append(np.sort(rng.choice(m, size=deg, replace=False)))
    indptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    ).to(dev)
    indices = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    max_err, n_cases = 0.0, 0
    for kind, (u, i) in (("exact", (exact_u, exact_i)), ("gauss", (gauss_u, gauss_i))):
        U, I = torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)
        for b in tiles:
            users = torch.from_numpy(rng.permutation(n)[:b]).to(dev)
            users[0] = 0
            if b > 3:
                users[3] = users[2]  # one user twice in a tile
            for k in (k for k in ks if k <= m):
                for masked in (False, True):
                    mask = (indptr, indices) if masked else (None, None)
                    for sig in (False, True):
                        before = (st.launches, st.wide_launches)
                        if not first_checked:
                            torch.cuda.synchronize()
                            torch.cuda.set_sync_debug_mode("error")  # raises on a host sync
                            try:
                                kv, ki = topk(U, I, users, k, *mask, sigmoid=sig)
                            finally:
                                torch.cuda.set_sync_debug_mode(0)
                            first_checked = True
                        else:
                            kv, ki = topk(U, I, users, k, *mask, sigmoid=sig)
                        # one launch a call, the radix select's above MAX_K
                        wide = int(topk is st.masked_topk_wide or k > st.MAX_K)
                        assert (st.launches, st.wide_launches) == (before[0] + 1, before[1] + wide), (
                            k, st.launches - before[0], st.wide_launches - before[1])
                        rv, ri = st.masked_topk_reference(U, I, users, k, *mask, sigmoid=sig)
                        torch.cuda.synchronize()
                        err = compare(kv, ki, rv, ri, exact=kind == "exact")
                        max_err = max(max_err, err)
                        n_cases += 1
                        if masked and k > 50:
                            # row 0: 50 unmasked items, then sentinels by id
                            assert (kv[0, 50:] == st.MASK_SENTINEL).all()
    return n_cases, max_err


def kernel_cases(dev) -> tuple:
    """Phase 3, masked_topk: both kernels against their plain version;
    returns the max abs error, the (B, M, d, k) held and the radix select's
    max abs error."""
    held = set()

    def cases(rng, n, m, d, tiles, ks, first_checked):
        held.update((b, m, d, k) for b in tiles for k in ks if k <= m)
        return _topk_cases(dev, rng, n, m, d, tiles, ks, first_checked)

    rng = np.random.default_rng(SEED)
    n, max_err = cases(rng, N_KERNEL, M_KERNEL, D, TILES, (10, 20, 128), False)
    for m, d in TOPK_EDGES:
        c, e = cases(rng, 1100, m, d, (1, 33, 65, 1000), (1, 20, 128), True)
        n, max_err = n + c, max(max_err, e)
    # TextSAGE's serving and evaluation shape
    c, e = cases(rng, 1100, TS_ITEMS, TS_D, (1, 64, 512, 1024), (10, 20), True)
    n, max_err = n + c, max(max_err, e)
    # the anchor20k evaluation's tile (phase 12)
    c, e = cases(rng, A20_USERS, A20_ITEMS, TS_D, (A20_EVAL_TILE,), (10, 20), True)
    n, max_err = n + c, max(max_err, e)
    # k > MAX_K: the radix select, its first call under the sync check; the
    # whole catalog; the radix select called directly at k <= MAX_K; its ties
    wide, wide_err = 0, 0.0
    for i, (m, d) in enumerate(TOPK_WIDE_SHAPES):
        c, e = cases(rng, 2100, m, d, TOPK_WIDE_TILES, TOPK_WIDE_KS, i > 0)
        wide, wide_err = wide + c, max(wide_err, e)
    c, e = cases(rng, 600, 300, TS_D, (1, 65, 512), (300,), True)
    wide, wide_err = wide + c, max(wide_err, e)
    held.update((b, A20_ITEMS, TS_D, k) for b in TOPK_WIDE_TILES for k in WIDE_DIRECT_KS)
    c, e = _topk_cases(dev, rng, 2100, A20_ITEMS, TS_D, TOPK_WIDE_TILES, WIDE_DIRECT_KS, True,
                       topk=st.masked_topk_wide)
    wide, wide_err = wide + c, max(wide_err, e)
    c, e = wide_tie_cases(dev)
    wide, wide_err = wide + c, max(wide_err, e)
    # the ranker's candidate dumps (phase 17): k = 50 over the anchor20k
    # catalog, tiles of 2048 and of tools dump-candidates' 1024 users
    c, e = cases(np.random.default_rng(SEED + 17), A20_USERS, A20_ITEMS, TS_D,
                 (RANK_DUMP_B, RANK_TOOL_B), (RANK_K,), True)
    n, max_err = n + c, max(max_err, e)
    # the registry keys of phase 20: requests (the HTTP ones of 1 and 2 users
    # too) and evaluation tiles at d = 64 (mf, the LightGCN keys, the
    # id-embedding keys) and at d = 32 over the anchor20k catalog
    for d in (REG_LGN_D, TS_D):
        c, e = cases(np.random.default_rng(SEED + 20 + d), A20_USERS, A20_ITEMS, d,
                     (1, 2) + TS_TILES[1:] + (A20_EVAL_TILE,), (10, TS_K), True)
        n, max_err = n + c, max(max_err, e)
    log(f"kernels: {n + wide} cases equal to the plain version (max abs err {max(max_err, wide_err):.3g}), "
        f"{wide} of them through the radix select (k > {st.MAX_K}, k in {WIDE_DIRECT_KS} called directly, "
        f"the tie tables; max abs err {wide_err:.3g}); one launch a call; no host sync in the wrappers")
    return max(max_err, wide_err), held, wide_err


def wide_tie_cases(dev) -> tuple:
    """Phase 3, the radix select on tie-heavy tables against the plain
    version, ids and values equal: exact user rows x 8192 under the sigmoid
    (every score a multiple of 128: exactly 1.0 above zero, 0.0 below, 0.5
    at it); every third user row zero (every score +-0.0); an item table of
    one repeated row; every fifth row masked down to 20 items (runs of -1024
    tied by id at k > 20). k in {1, 50, 128} called directly, {129, 200, 300}
    through masked_topk, and 10000 (the sort in device memory). Returns
    (cases, max abs err)."""
    rng = np.random.default_rng(SEED + 18)
    n, m, d = 600, A20_ITEMS, TS_D
    base_u = (rng.integers(-4, 5, size=(n, d)) / 8).astype(np.float32)
    base_i = (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32)
    rows = [np.sort(rng.choice(m, size=m - 20 if r % 5 == 0 else int(rng.integers(0, 40)), replace=False))
            for r in range(n)]
    ip = torch.from_numpy(np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)).to(dev)
    ix = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    zero_u = base_u.copy()
    zero_u[::3] = 0.0
    tables = {"sigmoid_saturated": (8192 * base_u, base_i, True), "zero_user": (zero_u, base_i, False),
              "all_equal": (base_u, np.tile(base_i[7:8], (m, 1)), False)}
    n_cases = 0
    for kind, (u, i, sig) in tables.items():
        U, I = torch.from_numpy(np.ascontiguousarray(u)).to(dev), torch.from_numpy(i).to(dev)
        for b in (1, 65, 512):
            users = torch.from_numpy(rng.permutation(n)[:b]).to(dev)
            for k in WIDE_DIRECT_KS + TOPK_WIDE_KS[:2] + (300, 10_000):
                for mask in ((None, None), (ip, ix)):
                    topk = st.masked_topk_wide if k <= st.MAX_K else st.masked_topk
                    before = st.wide_launches
                    kv, ki = topk(U, I, users, k, *mask, sigmoid=sig)
                    assert st.wide_launches == before + 1
                    rv, ri = st.masked_topk_reference(U, I, users, k, *mask, sigmoid=sig)
                    torch.cuda.synchronize()
                    compare(kv, ki, rv, ri, exact=True)
                    if mask[0] is not None and k > 20:  # row 0 of every fifth: 20 items, then -1024 by id
                        masked_rows = (users % 5 == 0).nonzero().flatten()
                        assert (kv[masked_rows, 20:] == st.MASK_SENTINEL).all()
                    n_cases += 1
    return n_cases, 0.0


def mesh_topk_cases(dev) -> float:
    """Phase 3, masked_topk at a (2, 2) mesh rank's shapes on phase 19's path
    (MESH_TOPK_SHAPES): each model rank's block of an anchor20k-sized
    catalog under the local CSR that ``local_mask`` builds from a whole
    train mask (1 to 40 positives a user, one user masked on all but 50
    items), k in {10, 20}, with and without the sigmoid, against the plain
    version on the same block and mask under rule 3 (exact inputs: equal);
    returns the max abs error."""
    rng = np.random.default_rng(SEED + 19)
    n, m = A20_USERS, A20_ITEMS
    rows = [np.unique(rng.integers(0, m, rng.integers(1, 40))) for _ in range(n)]
    rows[0] = np.sort(rng.choice(m, m - 50, replace=False))
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)).to(dev)
    indices = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    max_err, n_cases = 0.0, 0
    for b, m_block, d, k_path in MESH_TOPK_SHAPES:
        users = torch.from_numpy(rng.choice(n, b, replace=False).astype(np.int32)).to(dev)
        users[0] = 0
        exact = (torch.from_numpy((rng.integers(-4, 5, (n, d)) / 8).astype(np.float32)).to(dev),
                 torch.from_numpy((rng.integers(-2, 3, (m, d)) / 8).astype(np.float32)).to(dev))
        gauss = (torch.from_numpy((0.3 * rng.standard_normal((n, d))).astype(np.float32)).to(dev),
                 torch.from_numpy((0.3 * rng.standard_normal((m, d))).astype(np.float32)).to(dev))
        for r in range(MESH[1]):
            rank = Mesh(MESH[0], MESH[1], r, dev, {})  # model rank r of data row 0; no collective
            mask = local_mask(CSR(indptr, indices), m, rank, m)
            for kind, (U, I) in (("exact", exact), ("gauss", gauss)):
                block = item_block(I, rank)
                assert tuple(block.shape) == (m_block, d), block.shape
                for k in (10, k_path):
                    for sig in (False, True):
                        before = st.launches
                        kv, ki = st.masked_topk(U, block, users, k, *mask, sigmoid=sig)
                        assert st.launches == before + 1
                        rv, ri = st.masked_topk_reference(U, block, users, k, *mask, sigmoid=sig)
                        torch.cuda.synchronize()
                        max_err = max(max_err, compare(kv, ki, rv, ri, exact=kind == "exact"))
                        n_cases += 1
    log(f"kernels at the mesh rank's shapes {MESH_TOPK_SHAPES} under local_mask: {n_cases} cases equal to the "
        f"plain version (max abs err {max_err:.3g})")
    return max_err


def reference_propagate(graph, params, n_layers, cdt, r=None) -> np.ndarray:
    """LightGCN propagation in float64 on the CPU with x and the weights
    rounded to ``cdt`` as the port rounds them; with ``r``, radj's weights
    deg(src)^-r deg(dst)^-(1 - r) in float64 from the edges' degrees; [N + M,
    d]."""
    e = graph.norm_edges
    n = graph.num_nodes
    if r is None:
        w = e.weight.to(cdt).double()
    else:
        deg = torch.bincount(e.src.long(), minlength=n).double().clamp_min(1.0)
        w = deg[e.src.long()] ** -r * deg[e.dst.long()] ** -(1.0 - r)
    adj = torch.sparse_coo_tensor(
        torch.stack([e.dst.long(), e.src.long()]), w, (n, n)
    ).coalesce().to_sparse_csr()
    x = torch.cat([torch.from_numpy(params["user_emb"]), torch.from_numpy(params["item_emb"])])
    acc = x.double()
    h = x
    for _ in range(n_layers):
        h = torch.sparse.mm(adj, h.to(cdt).double()).float()
        acc = acc + h.double()
    return (acc / (n_layers + 1)).numpy()


def event_ms(fn, reps=30, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def alternating_ms(fns: dict, rounds=10, reps=30) -> dict:
    """CUDA-event times of several functions taken in turns: in each of
    ``rounds`` rounds every function is timed once (``event_ms``, the median
    of ``reps`` calls), in reversed order every other round. {name: {"ms":
    median of the round medians, "quartiles": [first, third], "rounds": [...]}}"""
    per = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            per[name].append(event_ms(fns[name], reps=reps))
    return {name: {"ms": float(np.median(v)),
                   "quartiles": [float(np.percentile(v, 25)), float(np.percentile(v, 75))],
                   "rounds": v} for name, v in per.items()}


def host_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _is_range(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name in RANGES


PROFILE_WINDOW = "chip_smoke.window"
PROFILE_PAD = 512  # one-element kernels launched before the window
PROFILE_GAP_S = 0.05  # sleep on either side of the window


def _window_profile(fn, n):
    """torch.profiler over PROFILE_PAD one-element kernels, then n calls of
    fn inside a range, PROFILE_GAP_S of sleep on either side: the device
    events within half a gap of the range, the range's wall time in us and
    the pad's records kept. A session drops the records of the first
    kernels launched in it (0 to 120 of them in whole-script runs on the
    H100, after a sleep as well), so the pad takes that loss; the gap keeps
    the pad out of the window although the card's clock and the host's may
    differ a little."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad = torch.zeros(1, device="cuda")
        for _ in range(PROFILE_PAD):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_GAP_S)
        with record_function(PROFILE_WINDOW):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(PROFILE_GAP_S)
    events = prof.events()
    win = [e for e in events if e.name == PROFILE_WINDOW and e.device_type == torch.autograd.DeviceType.CPU]
    if len(win) != 1:
        raise RuntimeError(f"the profile holds {len(win)} window ranges")
    margin = 0.5e6 * PROFILE_GAP_S
    lo, hi = win[0].time_range.start - margin, win[0].time_range.end + margin
    # the port's profiler ranges also show as spans on the card: not work
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not _is_range(e)
              and e.name != PROFILE_WINDOW]
    inside = [e for e in device if lo <= e.time_range.start < hi]
    return inside, wall_us, sum(e.time_range.start < lo for e in device)


def device_profile(fn, n=20, per_call=None):
    """torch.profiler over n calls of fn: device time per call by kernel name
    (ms), all device time and device operations per call, and the share of
    the calls' wall time with nothing running on the card (the profiler's
    own overhead counts as idle); the pad's records kept (of PROFILE_PAD +
    1). None when the profiler records no device activity. ``per_call``:
    kernel name part -> the records each call must give; a profile that
    gives another count is taken again, and after three such profiles the
    call raises."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        inside, wall_us, pad_kept = _window_profile(fn, n)
        counts = {part: sum(part in e.name for e in inside) for part in (per_call or {})}
        if all(counts[part] == want * n for part, want in (per_call or {}).items()):
            break
    else:
        raise RuntimeError(f"three profiles of {n} calls recorded {counts} kernels, want {per_call} a call")
    by_name = {}
    for e in inside:
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:48]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        return None
    busy = sum(by_name.values())
    return {
        "by_kernel_ms": {k: v / n / 1e3 for k, v in sorted(by_name.items(), key=lambda x: -x[1])},
        "device_ms": busy / n / 1e3,
        "device_ops_per_call": len(inside) / n,
        "idle_share": 1.0 - busy / wall_us,
        "attempts": attempt,
        "pad_kept": pad_kept,
    }


def scatter_cases(dev) -> tuple:
    """Phase 3, scatter_add_rows: the kernel against its plain version;
    returns the max abs error of the Gaussian cases and the (N, R, D) held."""
    rng = np.random.default_rng(SEED + 1)
    cases = [(n, rng.integers(0, n, r), D, None) for n, r in SCATTER_SHAPES]
    cases += [
        (1000, rng.integers(0, 1000, 999), D, None),  # R not a multiple of 32
        (500, np.zeros(0, np.int64), D, None),  # no rows: a zero table
        (100, np.concatenate([np.full(5000, 7), rng.integers(0, 100, 300)]), D, None),  # a hub
        (300, np.concatenate([rng.integers(0, 300, 2000), [-3, 300, 10**6]]), 50, None),  # clamped
    ]
    # TextSAGE's tree gathers (Zipf items hit often, as tree neighbours are)
    # and a categorical gather, at D = 32
    zipf = np.minimum(rng.zipf(1.2, TS_SCATTER[1][1]) - 1, TS_ITEMS - 1)
    cases += [
        (TS_USERS, rng.integers(0, TS_USERS, TS_SCATTER[0][1]), TS_D, None),
        (TS_ITEMS, zipf, TS_D, None),
        (40, rng.integers(0, 40, TS_SCATTER[2][1]), TS_D, None),
    ]
    # the modes' edges: every row on one id; ids that are all multiples of a
    # tile's hash slot count; R = T - 1, T, T + 1 under the item-side gather's
    # tile plan; and the row mode forced at that gather's shape
    sms = sc.sm_count(_cuda.device_index(dev))
    user_plan = sc.plan_scatter(TS_USERS, TS_SCATTER[0][1], TS_D, sms)
    item_plan = sc.plan_scatter(TS_ITEMS, TS_SCATTER[1][1], TS_D, sms)
    assert (user_plan.mode, item_plan.mode) == ("tile", "tile"), (user_plan, item_plan)
    slots = 2 * user_plan.tile
    cases += [
        (TS_ITEMS, np.full(TS_SCATTER[1][1], TS_ITEMS - 1), TS_D, None),
        (TS_USERS, rng.integers(0, TS_USERS // slots, TS_SCATTER[0][1]) * slots, TS_D, None),
    ]
    cases += [(TS_ITEMS, zipf[: item_plan.tile + e], TS_D, item_plan) for e in (-1, 0, 1)]
    cases.append((TS_ITEMS, zipf, TS_D, sc.plan_scatter(TS_ITEMS, len(zipf), TS_D, sms, "row")))
    # the flagship step's tree gathers on the anchor20k graph (phase 12)
    rng20 = np.random.default_rng(SEED + 20)
    cases += [
        (A20_USERS, rng20.integers(0, A20_USERS, TS_SCATTER[0][1]), TS_D, None),
        (A20_ITEMS, np.minimum(rng20.zipf(1.2, TS_SCATTER[1][1]) - 1, A20_ITEMS - 1), TS_D, None),
    ]
    # rsage's relation rows: a step's two layers' gathers from the 3-row table
    cases += [(3, rng.choice(3, size=r, p=REL_SHARES), TS_D, None) for r in REL_ROWS]
    # sasrec's item rows (0.86 of them the pad id 0, as at the anchor20k
    # shape) and asage's attribute rows (32 attributes a side)
    seq_ids = np.where(rng.random(SEQ_ROWS) < 0.86, 0, rng.integers(0, A20_ITEMS, SEQ_ROWS))
    cases += [(A20_ITEMS, seq_ids, SEQ_D, None)]
    cases += [(SEQ_ATTRS, rng.integers(0, SEQ_ATTRS, r), TS_D, None) for r in ATTR_ROWS]
    # and the word rows of their per-id text bags (half of them pads on word 0)
    cases += [(SEQ_WORDS, np.where(rng.random(r) < 0.5, 0, rng.integers(0, SEQ_WORDS, r)), d, None)
              for r, d in zip(WORD_ROWS[:2], (SEQ_D // 2, TS_D // 2))]
    # a (2, 2) mesh rank's half of phase 19's step gathers (MESH_SCATTER_SHAPES):
    # Zipf items as in a tree, word rows half pads on word 0
    rng19 = np.random.default_rng(SEED + 19)

    def mesh_ids(n, r):
        if n == A20_ITEMS:
            return np.minimum(rng19.zipf(1.2, r) - 1, n - 1)
        if n == SEQ_WORDS:
            return np.where(rng19.random(r) < 0.5, 0, rng19.integers(0, n, r))
        return rng19.integers(0, n, r)

    cases += [(n, mesh_ids(n, r), d, None) for n, r, d in MESH_SCATTER_SHAPES]
    # phase 20's: the id-embedding keys' tree gathers at node width 64 and the
    # batch rows gathered from whole tables (Zipf items, as trees and the
    # popularity-drawn negatives hit them)
    cases += [(n, mesh_ids(n, r), d, None) for n, r, d in REG_SCATTER_SHAPES]
    # the ranker's categorical rows (phase 17): 9 columns of 256 groups x 111
    # candidates into the 32-row table at emb 16, about 8,000 rows an id
    cases.append((RANK_VOCAB, np.random.default_rng(SEED + 17).integers(0, RANK_VOCAB, RANK_ROWS), RANK_EMB, None))
    max_err, n_cases = 0.0, 0
    for n, ids, d, plan in cases:
        ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
        for exact in (True, False):
            if exact:
                rows = (rng.integers(-8, 9, (len(ids), d)) / 8).astype(np.float32)
            else:
                rows = rng.standard_normal((len(ids), d)).astype(np.float32)
            rows_t = torch.from_numpy(rows).to(dev)
            before = sc.launches
            if n_cases == 0:
                torch.cuda.set_sync_debug_mode("error")  # raises on a host sync
                try:
                    got = sc.scatter_add_rows(ids_t, rows_t, n)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            elif plan is None:
                got = sc.scatter_add_rows(ids_t, rows_t, n)
            else:
                got = sc._launch(ids_t, rows_t, n, plan)
            want = sc.scatter_add_rows_reference(ids_t, rows_t, n)
            mag = sc.scatter_add_rows_reference(ids_t, rows_t.abs(), n)
            torch.cuda.synchronize()
            assert sc.launches == before + 1, "scatter_add_rows did not launch its kernel"
            got, want, mag = (x.cpu().numpy() for x in (got, want, mag))
            assert got.shape == (n, d)
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                err = np.abs(got - want)
                assert (err <= SC_TOL + SC_TOL * mag).all(), f"scatter N={n} R={len(ids)}: {err.max()}"
                max_err = max(max_err, float(err.max(initial=0.0)))
            n_cases += 1
    log(f"scatter: {n_cases} cases equal to the plain version (exact cases bit-equal, "
        f"max abs err {max_err:.3g}); no host sync in the wrapper")
    return max_err, {(n, len(ids), d) for n, ids, d, _ in cases}


def _own_kernel(name: str):
    return next((part for key, part in OWN_KERNELS.items() if key in name), None)


def _is_memset(name: str) -> bool:
    return name.startswith("Memset")


def _step_part(e) -> str:
    """The step part of a profiler CPU event: the innermost port range
    around it (RANGES), else "other"."""
    while e is not None:
        if e.name in RANGES:
            return RANGES[e.name]
        e = e.cpu_parent
    return "other"


def split_profile(fn, n):
    """torch.profiler over n calls of fn: device time per call split into
    step parts (the port's own kernels by name, every other kernel by the
    port range around the torch operation that launched it; "unattributed"
    is what the profiler ties to no operation), all device time and the
    number of device operations per call, and the share of the window's
    wall time with nothing running on the card (the profiler's own overhead
    counts as idle). None when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    # the host's runtime calls by correlation id: a memset goes by the range
    # around the cudaMemsetAsync that issued it, since the profiler ties it to
    # the torch operation around the ctypes call (the scatter entry zeroes its
    # table so), which lies outside the port's range
    runtime = {e.id: e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda")}
    split, device_us, n_device = {}, 0.0, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not _is_range(e):
                us = e.time_range.elapsed_us()
                device_us += us
                n_device += 1
                part = _own_kernel(e.name)
                if part is None and _is_memset(e.name) and e.id in runtime:
                    part = _step_part(runtime[e.id])
                if part is not None:
                    split[part] = split.get(part, 0.0) + us
        elif e.kernels:
            spent = sum(k.duration for k in e.kernels if k.name not in RANGES
                        and _own_kernel(k.name) is None and not _is_memset(k.name))
            if spent:
                part = _step_part(e)
                split[part] = split.get(part, 0.0) + spent
    split["unattributed"] = device_us - sum(split.values())
    if device_us == 0.0:
        return None
    return {
        "split_ms": {k: v / n / 1e3 for k, v in sorted(split.items(), key=lambda x: -x[1])},
        "device_ms": device_us / n / 1e3,
        "device_ops_per_call": n_device / n,  # kernels, copies and fills
        "wall_ms": wall_us / n / 1e3,
        "idle_share": 1.0 - device_us / wall_us,
    }


def host_syncs(fn) -> list:
    """The messages of torch's sync debug mode while fn runs: one per
    operation that made the host wait for the card."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]


def train_config() -> Config:
    return Config(
        model="lgn", latent_dim=D, n_layers=2, compute_dtype="bfloat16",
        bpr_batch_size=TRAIN_B, lr=TRAIN_LR, seed=SEED, topks=(10, 20), eval_user_batch=1024,
    )


def train_path(ds, dev):
    """Phase 6: the trainer on the card; returns (trainer, facts)."""
    cfg = train_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, build_model("lgn", cfg, ds.graph),
                      logger=MetricLogger(quiet=True), device=dev)
    trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_tiles = int(trainer.eval_data.users.shape[0])

    sc.launches = st.launches = 0
    t0 = time.perf_counter()
    before = trainer.test()
    first_eval_s = time.perf_counter() - t0
    losses, epoch_s = [], []
    for _ in range(3):  # one warm-up epoch, then two timed ones
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_one_epoch())  # ends in the epoch's one host sync
        epoch_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    after = trainer.test()
    eval_s = time.perf_counter() - t0
    launches = {"scatter_add_rows": sc.launches, "masked_topk": st.launches}

    steps = 3 * trainer.num_batches
    assert launches["scatter_add_rows"] >= steps, f"scatter launched {launches} in {steps} steps"
    assert launches["masked_topk"] == 2 * n_tiles, f"masked_topk launched {launches} for {n_tiles} tiles"
    for res in (before, after):
        assert all(np.isfinite(v) for v in res.values()), res
    assert np.isfinite(losses).all() and losses[-1] < losses[0], f"loss did not fall: {losses}"
    assert after["recall@20"] > before["recall@20"], (before["recall@20"], after["recall@20"])
    log(f"train: {steps} steps of {trainer.samples_per_epoch // trainer.num_batches} triplets, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, recall@20 {before['recall@20']:.5f} -> "
        f"{after['recall@20']:.5f}; scatter launches {launches['scatter_add_rows']} "
        f"({launches['scatter_add_rows'] / steps:g} per step), masked_topk launches "
        f"{launches['masked_topk']} ({n_tiles} tiles per evaluation)")
    return trainer, {
        "steps_per_epoch": trainer.num_batches,
        "samples_per_epoch": trainer.samples_per_epoch,
        "epoch_s": epoch_s,
        "samples_per_s": trainer.samples_per_epoch / float(np.mean(epoch_s[1:])),
        "step_ms": 1e3 * float(np.mean(epoch_s[1:])) / trainer.num_batches,
        "loss": losses,
        "recall@20": [before["recall@20"], after["recall@20"]],
        "ndcg@20": [before["ndcg@20"], after["ndcg@20"]],
        "eval_s": eval_s,
        "first_eval_s": first_eval_s,
        "setup_s": setup_s,
        "eval_tiles": n_tiles,
        "launches": launches,
        "scatter_launches_per_step": launches["scatter_add_rows"] / steps,
    }


def card_vs_cpu(ds, trainer) -> dict:
    """Phase 7, first half: two steps on the card and on the CPU."""
    cfg = trainer.config
    rng = np.random.default_rng(SEED + 2)
    params = {
        "user_emb": (0.1 * rng.standard_normal((ds.n_users, D))).astype(np.float32),
        "item_emb": (0.1 * rng.standard_normal((ds.m_items, D))).astype(np.float32),
    }
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 2)
    batches = sample_bpr(gen, trainer.graph, 2 * TRAIN_B, cfg.neg_candidates)
    out = {}
    for name, dev, graph in (("card", trainer.device, trainer.graph),
                             ("cpu", torch.device("cpu"), ds.graph)):
        model = build_model("lgn", cfg, ds.graph)
        params_from_jax(params, model)
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        losses = []
        for step in range(2):
            batch = batches.slice(step * TRAIN_B, (step + 1) * TRAIN_B).to(dev)
            opt.zero_grad(set_to_none=True)
            loss, _ = model.loss(graph, batch)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        out[name] = (params_to_numpy(model), losses)
    (pc, lc), (pp, lp) = out["card"], out["cpu"]
    np.testing.assert_allclose(lc[0], lp[0], rtol=1e-5)
    np.testing.assert_allclose(lc[1], lp[1], rtol=1e-4)
    worst, off = 0.0, 0
    total = 0
    for k in pp:
        diff = np.abs(pc[k] - pp[k])
        assert (diff <= 4 * cfg.lr).all(), f"{k}: {diff.max()}"
        off += int((diff > 1e-6 + 1e-5 * np.abs(pp[k])).sum())
        total += diff.size
        worst = max(worst, float(diff.max()))
    assert off <= 1e-3 * total, f"{off} of {total} parameters differ"
    log(f"card vs CPU: losses {lc} / {lp}; parameters within 1e-6 + 1e-5 |p| but "
        f"{off} of {total} (max abs diff {worst:.3g})")
    return {"losses_card": lc, "losses_cpu": lp, "params_off": off, "params_total": total,
            "max_abs_diff": worst}


def eval_kernel_vs_plain(trainer) -> dict:
    """Phase 7, second half: one evaluation through the kernel and through
    its plain version on the card."""
    g, data, cfg = trainer.graph, trainer.eval_data, trainer.config
    with torch.no_grad():
        U, I = trainer.model.propagate(g)
    U, I = U.detach().float().contiguous(), I.detach().float().contiguous()  # mf's are its parameters
    kmax = max(cfg.topks)
    sums = {"kernel": None, "plain": None}
    moved = 0
    sig = trainer.model.score_sigmoid
    for users, valid in zip(data.users, data.valid):
        kv, ki = st.masked_topk(U, I, users, kmax, g.user_pos.indptr, g.user_pos.indices, sigmoid=sig)
        rv, ri = st.masked_topk_reference(U, I, users, kmax, g.user_pos.indptr, g.user_pos.indices, sigmoid=sig)
        compare(kv, ki, rv, ri, exact=False)
        moved += int((ki != ri).sum())
        for name, ids in (("kernel", ki), ("plain", ri)):
            b = batch_metric_sums(
                ids, users, valid, g.test_pos, cfg.topks, None, data.item_popularity,
                n_users_norm=float(g.n_users), max_test_degree=g.max_test_degree or None,
            )
            sums[name] = b if sums[name] is None else {k: sums[name][k] + v for k, v in b.items()}
    for k in sums["plain"]:
        a, b = sums["kernel"][k].cpu().numpy(), sums["plain"][k].cpu().numpy()
        if moved == 0:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:  # ids swapped only inside near-ties (checked above)
            np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=k)
    log(f"evaluation: metric sums through masked_topk equal to the plain version's "
        f"({moved} ids in near-ties placed otherwise)")
    return {"ids_moved_in_ties": moved}


def scatter_numbers(trainer, dev) -> list:
    """Phase 8: scatter_add_rows at the bench step's two shapes, on the ids
    of a sampled batch."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    batch = sample_bpr(gen, trainer.graph, TRAIN_B, trainer.config.neg_candidates)
    cases = [(n, ids) for (n, _), ids in zip(SCATTER_SHAPES, (batch.user, torch.cat([batch.pos, batch.neg])))]
    assert [ids.shape[0] for _, ids in cases] == [r for _, r in SCATTER_SHAPES]
    return scatter_numbers_at(cases, dev, D, rows_seed=SEED + 4)


def textsage_config() -> Config:
    return ddp_flagship_config().replace(seed=SEED, topks=(10, 20), eval_user_batch=EVAL_TILE)


def textsage_data():
    """Phase 9's data: the flagship graph and its side features (host)."""
    t0 = time.perf_counter()
    ds = synthetic_dataset(n_users=TS_USERS, m_items=TS_ITEMS, avg_degree=TS_DEGREE, seed=SEED)
    graph = ds.graph
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = synthetic_features(ds, textsage_config(), seed=SEED)
    features_s = time.perf_counter() - t0
    log(f"textsage data: {ds.n_users} users, {ds.m_items} items, {graph.train_size} train edges "
        f"({data_s:.1f} s); features ({features_s:.1f} s)")
    return ds, fs, {"data_s": data_s, "features_s": features_s}


def _textsage_model(ds, fs, seed):
    cfg = textsage_config()
    return build_model("textsage", cfg, ds.graph, features=fs,
                       generator=torch.Generator().manual_seed(seed))


def serve_textsage(ds, fs, dev, host_s) -> dict:
    """Phase 9: the flagship's serving path and its numbers."""
    cfg = textsage_config()
    model = _textsage_model(ds, fs, SEED)
    params = params_to_numpy(model)
    users = {b: np.random.default_rng(SEED + 10 + b).choice(ds.n_users, size=b, replace=False)
             for b in TS_TILES}

    st.launches = sc.launches = 0
    t0 = time.perf_counter()
    rec = Recommender(model, ds, cfg, None, device="cuda")
    torch.cuda.synchronize()
    first_refresh_s = time.perf_counter() - t0
    answers = {}
    for b in TS_TILES:
        before = st.launches
        answers[b] = rec.recommend(users[b], k=TS_K)
        assert st.launches == before + 1, "a request did not launch the kernel"
    srv = make_server(rec, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        before = st.launches
        one = json.load(urllib.request.urlopen(f"{base}/recommend?user=17&k={TS_K}", timeout=60))
        req = urllib.request.Request(
            f"{base}/recommend", data=json.dumps({"users": [3, ds.n_users - 1], "k": TS_K}).encode(),
            method="POST",
        )
        batch = json.load(urllib.request.urlopen(req, timeout=60))
        assert st.launches == before + 2, "an HTTP request did not launch the kernel"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
    assert not th.is_alive()
    assert launches["scatter_add_rows"] == 0, "the serve path launched the scatter kernel"

    U, I = rec._user_emb, rec._item_emb
    mask = (rec._mask.indptr, rec._mask.indices)
    max_err = 0.0
    pos = ds.all_pos()
    for b, (ids, scores) in answers.items():
        assert ids.shape == (b, TS_K) and np.isfinite(scores).all()
        rv, ri = st.masked_topk_reference(U, I, torch.from_numpy(users[b]).to(dev), TS_K, *mask)
        max_err = max(max_err, compare(torch.from_numpy(scores), torch.from_numpy(ids), rv, ri, exact=False))
        for u, row in zip(users[b], ids):
            assert not set(row.tolist()) & set(pos[u].tolist()), "a train positive was served"
    assert one["items"] == rec.recommend([17], k=TS_K)[0][0].tolist()
    assert [r["items"] for r in batch] == rec.recommend([3, ds.n_users - 1], k=TS_K)[0].tolist()

    # the propagation on the card against the CPU's on the same parameters
    cpu_model = build_model("textsage", cfg, ds.graph, features=fs)
    params_from_jax(params, cpu_model)
    with torch.no_grad():
        cu, ci = cpu_model.propagate(ds.graph)
    got = torch.cat([U, I]).cpu().numpy()
    want = torch.cat([cu, ci]).numpy()
    assert got.shape == (ds.n_users + ds.m_items, TS_D) and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3 * scale)
    prop_err = float(np.abs(got - want).max())
    log(f"serve-textsage: {len(answers) + 2} requests, {launches['masked_topk']} masked_topk launches, "
        f"answers equal to the plain version (max abs err {max_err:.3g}); propagation equal to the "
        f"CPU's (max abs err {prop_err:.3g} of max |x| {scale:.3g}); first refresh {first_refresh_s:.2f} s")

    refresh_ms = host_ms(lambda: rec.refresh(None), reps=10)
    refresh_profile = device_profile(lambda: rec.refresh(None), n=5)
    if refresh_profile is not None:
        log(f"serve-textsage: refresh {refresh_ms:.3f} ms on the host, "
            f"{refresh_profile['device_ms']:.3f} ms on the device")
    tiles = []
    pos_csr = CSR(*mask)
    for b in TS_TILES + (EVAL_TILE,):
        u = torch.from_numpy(np.random.default_rng(SEED + 20 + b).choice(ds.n_users, b, replace=False)).to(dev)
        tiles.append(topk_numbers(U, I, u, TS_K, mask, pos_csr, dev,
                                  request=(lambda u=u: rec.recommend(u.cpu().numpy(), k=TS_K))))
    return {
        **host_s,
        "first_refresh_s": first_refresh_s,
        "refresh_ms": refresh_ms,
        "refresh_profile": refresh_profile,
        "launches": launches,
        "max_abs_err": max_err,
        "propagate_vs_cpu_max_abs_err": prop_err,
        "tiles": tiles,
    }


def topk_kernels(k, m) -> dict:
    """Kernel name -> launches of one masked_topk call at this k over M items."""
    if k > st.MAX_K:
        return st.wide_kernels(m)
    return dict.fromkeys(("score_segments", "merge_segments"), 1)


def topk_numbers(U, I, users, k, mask, pos_csr, dev, request=None) -> dict:
    """masked_topk's times at one tile, beside its plain version's, the
    library call's (matmul + index_put_ + topk) and its bound."""
    b, d, m = users.shape[0], U.shape[1], I.shape[0]
    deg = pos_csr.degrees()[users.long()]
    cols, valid = csr_gather_padded(pos_csr, users, int(deg.max()))
    rows = torch.arange(b, device=dev)[:, None].expand_as(cols)
    mrows, mcols = rows[valid], cols[valid].long()
    sentinel = torch.tensor(float(st.MASK_SENTINEL), device=dev)

    def library():
        s = U[users] @ I.T
        s.index_put_((mrows, mcols), sentinel)
        return torch.topk(s, k)

    nbytes = 4 * (I.numel() + b * d + b + 2 * b + int(deg.sum())) + 12 * b * k
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, 2 * b * m * d / F32_FLOP_PER_S
    out = {
        "B": b, "k": k, "M": m, "d": d,
        "ms": event_ms(lambda: st.masked_topk(U, I, users, k, *mask)),
        "plain_ms": event_ms(lambda: st.masked_topk_reference(U, I, users, k, *mask)),
        "library_ms": event_ms(library),
        "bound_ms": 1e3 * max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        # every record of the calls: pass 1 and the merge, or the radix passes
        # and the sort
        "kernel_profile": device_profile(lambda: st.masked_topk(U, I, users, k, *mask),
                                         per_call=topk_kernels(k, m)),
    }
    if request is not None:
        out["request_ms"] = host_ms(request)
        out["request_profile"] = device_profile(request)
    return out


def tree_gather_ids(model, graph, batch, gen):
    """The ids a flagship step's two table gathers take: every level of the
    (user, pos, neg) trees, users and items apart, in the model's order."""
    ids = {"user": [], "item": []}
    for seeds, side in ((batch.user, "user"), (batch.pos, "item"), (batch.neg, "item")):
        tree = model.sample_seed_tree(graph, seeds, side, gen)
        for s, lvl in zip(model._sides(side), [seeds] + [t.ids for t in tree]):
            ids[s].append(lvl.reshape(-1))
    return torch.cat(ids["user"]), torch.cat(ids["item"])


def implied_global_adds(plan, ids, n, d) -> dict:
    """The global adds (and the longest chain of them into one address) that
    ``plan`` makes for these ids: one a column for each distinct id of a tile
    in tile mode, one an element in row mode. Counted on the card."""
    ids = ids.long().clamp(0, n - 1)
    r = ids.shape[0]
    if plan.mode == "row" or r == 0:
        return {"adds": r * d, "share": 1.0 if r else 0.0,
                "longest_chain": int(torch.bincount(ids, minlength=n).max()) if r else 0}
    tile_of = torch.arange(r, device=ids.device) // plan.tile
    distinct = torch.unique(tile_of * n + ids)
    return {"adds": int(distinct.numel()) * d, "share": distinct.numel() / r,
            "longest_chain": int(torch.bincount(distinct % n, minlength=n).max())}


def scatter_numbers_at(cases, dev, d, rows_seed) -> list:
    """scatter_add_rows at each (N, ids) with Gaussian rows of width d: the
    plan, the call against its row mode forced and index_add_ in ten
    alternating rounds (they are close and host-bound), the device profiles
    of all three, the plain version, the bound and the global adds that the
    plan implies for these ids."""
    rows_gen = torch.Generator(device=dev).manual_seed(rows_seed)
    sms = sc.sm_count(_cuda.device_index(dev))
    out = []
    for n, ids in cases:
        r = ids.shape[0]
        rows = torch.randn((r, d), generator=rows_gen, device=dev)
        ids_long = ids.long()
        plan = sc.plan_scatter(n, r, d, sms)
        row_plan = sc.plan_scatter(n, r, d, sms, "row")
        t_bytes = 4 * r * (d + 1) / HBM_BYTES_PER_S + 4 * n * d / HBM_BYTES_PER_S
        t_flops = r * d / F32_FLOP_PER_S

        def library(n=n, ids_long=ids_long, rows=rows):
            return torch.zeros((n, d), device=dev).index_add_(0, ids_long, rows)

        fns = {"kernel": lambda n=n, ids=ids, rows=rows: sc.scatter_add_rows(ids, rows, n),
               "row_mode": lambda n=n, ids=ids, rows=rows, p=row_plan: sc._launch(ids, rows, n, p),
               "library": library}
        alt = alternating_ms(fns)
        # a profile that recorded no device activity is taken once more
        profiles = {name: device_profile(fn) or device_profile(fn) for name, fn in fns.items()}
        adds = implied_global_adds(plan, ids, n, d)
        row_adds = implied_global_adds(row_plan, ids, n, d)
        dev_ms = {name: (p or {}).get("device_ms") for name, p in profiles.items()}
        log(f"scatter (N={n}, R={r}, D={d}): {plan.mode} mode (T {plan.tile}, {plan.blocks} blocks, "
            f"{plan.smem_bytes} B shared); device ms: kernel {dev_ms['kernel']}, row mode "
            f"{dev_ms['row_mode']}, index_add_ {dev_ms['library']}; bound "
            f"{1e3 * max(t_bytes, t_flops):.5f}; global adds {adds['adds']} "
            f"({adds['share']:.3f} of R x D), longest chain {adds['longest_chain']} "
            f"(row mode {row_adds['longest_chain']})")
        out.append({
            "N": n, "R": r, "D": d,
            "plan": plan._asdict(),
            "ms": alt["kernel"]["ms"],
            "row_mode_ms": alt["row_mode"]["ms"],
            "plain_ms": event_ms(lambda: sc.scatter_add_rows_reference(ids, rows, n)),
            "library_ms": alt["library"]["ms"],
            "device_ms": dev_ms["kernel"],
            "row_mode_device_ms": dev_ms["row_mode"],
            "library_device_ms": dev_ms["library"],
            "alternating": alt,
            "bound_ms": 1e3 * max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "global_adds": adds,
            "row_mode_global_adds": row_adds,
            "distinct_ids": int(torch.unique(ids).numel()),
            "largest_id_share": float(torch.bincount(ids_long, minlength=n).max()) / r,
            "kernel_profile": profiles["kernel"],
            "row_mode_profile": profiles["row_mode"],
            "library_profile": profiles["library"],
        })
    return out


def train_textsage(ds, fs, dev) -> tuple:
    """Phase 10: the flagship's training path; returns (trainer, facts)."""
    cfg = textsage_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, ds, _textsage_model(ds, fs, SEED + 1), logger=MetricLogger(quiet=True),
                      ddp_recipe=True, device=dev)
    trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_tiles = int(trainer.eval_data.users.shape[0])
    bs = cfg.bpr_batch_size
    warm = sample_bpr(trainer.generator, trainer.graph, TS_WARMUP * bs, cfg.neg_candidates,
                      edge_alias=trainer.edge_alias, neg_alias=trainer.neg_alias)

    sc.launches = st.launches = 0
    t0 = time.perf_counter()
    before = trainer.test()
    first_eval_s = time.perf_counter() - t0
    for i in range(TS_WARMUP):
        trainer.train_step(warm.slice(i * bs, (i + 1) * bs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_loss = trainer.train_one_epoch()  # ends in the epoch's one host sync
    epoch_s = time.perf_counter() - t0
    losses = trainer.epoch_losses.cpu().numpy()
    t0 = time.perf_counter()
    after = trainer.test()
    eval_s = time.perf_counter() - t0
    launches = {"scatter_add_rows": sc.launches, "masked_topk": st.launches}

    steps = TS_WARMUP + trainer.num_batches
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    assert launches["scatter_add_rows"] == 2 * steps, f"scatter launched {launches} in {steps} steps"
    assert launches["masked_topk"] == 2 * n_tiles, f"masked_topk launched {launches} for {n_tiles} tiles"
    for res in (before, after):
        assert all(np.isfinite(v) for v in res.values()), res
    assert np.isfinite(losses).all() and last < first, f"loss did not fall: {first} -> {last}"
    log(f"train-textsage: {trainer.num_batches} steps of {bs} triplets in {epoch_s:.2f} s "
        f"({trainer.samples_per_epoch / epoch_s:.0f} samples/s), loss {first:.5f} -> {last:.5f} "
        f"(first and last tenth), recall@20 {before['recall@20']:.5f} -> {after['recall@20']:.5f}; "
        f"scatter launches {launches['scatter_add_rows']} ({launches['scatter_add_rows'] / steps:g} per "
        f"step), masked_topk launches {launches['masked_topk']} ({n_tiles} tiles per evaluation)")

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    su, si = trainer.model.propagate_sampled(trainer.graph, gen)
    torch.cuda.synchronize()
    sample_inference_s = time.perf_counter() - t0
    assert su.shape == (ds.n_users, TS_D) and si.shape == (ds.m_items, TS_D)
    assert bool(torch.isfinite(su).all()) and bool(torch.isfinite(si).all())
    log(f"train-textsage: --inference sample over {ds.n_users + ds.m_items} entities in "
        f"{sample_inference_s:.2f} s")
    return trainer, {
        "steps_per_epoch": trainer.num_batches,
        "samples_per_epoch": trainer.samples_per_epoch,
        "epoch_s": epoch_s,
        "samples_per_s": trainer.samples_per_epoch / epoch_s,
        "step_ms": 1e3 * epoch_s / trainer.num_batches,
        "loss_mean": mean_loss,
        "loss_first_last_tenth": [first, last],
        "recall@20": [before["recall@20"], after["recall@20"]],
        "ndcg@20": [before["ndcg@20"], after["ndcg@20"]],
        "eval_s": eval_s,
        "first_eval_s": first_eval_s,
        "setup_s": setup_s,
        "eval_tiles": n_tiles,
        "launches": launches,
        "scatter_launches_per_step": launches["scatter_add_rows"] / steps,
        "sample_inference_s": sample_inference_s,
    }


def card_vs_cpu_textsage(ds, fs, trainer) -> dict:
    """Phase 10's card-against-CPU step (dropout 0)."""
    cfg = trainer.config
    params = params_to_numpy(trainer.model)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 9)
    batch = sample_bpr(gen, trainer.graph, cfg.bpr_batch_size, cfg.neg_candidates,
                       edge_alias=trainer.edge_alias, neg_alias=trainer.neg_alias)
    trees = [trainer.model.sample_seed_tree(trainer.graph, s, side, gen)
             for s, side in ((batch.user, "user"), (batch.pos, "item"), (batch.neg, "item"))]
    out = {}
    rate, sage.DROPOUT_RATE = sage.DROPOUT_RATE, 0.0
    try:
        for name, dev, graph in (("card", trainer.device, trainer.graph),
                                 ("cpu", torch.device("cpu"), ds.graph)):
            model = build_model("textsage", cfg, ds.graph, features=fs)
            params_from_jax(params, model)
            model.to(dev)
            opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
            loss, _ = model.loss(graph, batch.to(dev), trees=[[lvl.to(dev) for lvl in t] for t in trees])
            loss.backward()
            opt.step()
            out[name] = (flatten_params(params_to_numpy(model)), float(loss.detach()))
    finally:
        sage.DROPOUT_RATE = rate
    (pc, lc), (pp, lp) = out["card"], out["cpu"]
    np.testing.assert_allclose(lc, lp, rtol=1e-4)
    worst, off, total = 0.0, 0, 0
    for k in pp:
        diff = np.abs(pc[k] - pp[k])
        assert (diff <= 2 * cfg.lr).all(), f"{k}: {diff.max()}"
        off += int((diff > 1e-6 + 1e-5 * np.abs(pp[k])).sum())
        total += diff.size
        worst = max(worst, float(diff.max()))
    assert off <= 1e-3 * total, f"{off} of {total} parameters differ"
    log(f"textsage card vs CPU: loss {lc} / {lp}; parameters within 1e-6 + 1e-5 |p| but "
        f"{off} of {total} (max abs diff {worst:.3g})")
    return {"loss_card": lc, "loss_cpu": lp, "params_off": off, "params_total": total,
            "max_abs_diff": worst}

def anchor20k_data():
    """Phase 12's data: the anchor20k graph and its informative features."""
    t0 = time.perf_counter()
    ds = synthetic_structured_dataset(A20_USERS, A20_ITEMS, avg_degree=8, seed=0, rank=16, signal=3.0,
                                      popularity_alpha=0.8)
    assert ds.train_size == A20_EDGES, f"{ds.train_size} train edges, the TPU records have {A20_EDGES}"
    _ = ds.graph
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = informative_synthetic_features(ds, a20_config(), dataset_seed=0, rank=16, seed=0)
    features_s = time.perf_counter() - t0
    log(f"train-textsage-20k data: {ds.n_users} users, {ds.m_items} items, {ds.train_size} train edges "
        f"({data_s:.1f} s); informative features ({features_s:.1f} s)")
    return ds, fs, {"data_s": data_s, "features_s": features_s}


def a20_config(**over) -> Config:
    return ddp_flagship_config().replace(eval_user_batch=A20_EVAL_TILE, topks=(10, 20), seed=SEED, **over)


def _no_numeric(fs):
    return dataclasses.replace(fs, user=dataclasses.replace(fs.user, numeric=None),
                               item=dataclasses.replace(fs.item, numeric=None))


def cadence_trainer(ds, fs, dev, name="textsage", ooc=None, **over) -> Trainer:
    cfg = a20_config(model=name, **over)
    model = build_model(name, cfg, ds.graph, features=_no_numeric(fs) if ooc else fs,
                        generator=torch.Generator().manual_seed(SEED), ooc_numeric=ooc)
    trainer = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=True, device=dev)
    trainer.init_state()
    return trainer


def _timed_epoch(trainer) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean = trainer.train_one_epoch()  # ends in the epoch's one host sync
    return time.perf_counter() - t0, mean, trainer.epoch_losses.cpu().numpy()


def _falls(losses) -> tuple:
    tenth = max(1, len(losses) // 10)
    return float(losses[:tenth].mean()), float(losses[-tenth:].mean())


def _params(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def train_textsage_20k(ds, fs, dev, tmp) -> dict:
    """Phase 12: the SAGE cadences on the anchor20k shape; returns facts (the
    R = 8 trainer under "trainer")."""
    n_eval = 0
    facts = {}
    sc.launches = st.launches = 0
    steps = 0

    # R = 8: six epochs, evaluated at 3 and 6
    tr8 = cadence_trainer(ds, fs, dev, relin_every=CADENCE_BLOCK)
    n_tiles = int(tr8.eval_data.users.shape[0])
    epochs, recall = [], {}
    for ep in range(1, A20_EPOCHS + 1):
        dt, mean, _ = _timed_epoch(tr8)
        epochs.append((dt, mean))
        steps += tr8.num_batches
        if ep % 3 == 0:
            recall[ep] = tr8.test()["recall@10"]
            n_eval += 1
    assert np.isfinite([m for _, m in epochs]).all() and epochs[-1][1] < epochs[0][1], epochs
    assert recall[A20_EPOCHS] >= A20_RECALL10_FLOOR, f"recall@10 {recall} below {A20_RECALL10_FLOOR}"
    log(f"train-textsage-20k R=8: {A20_EPOCHS} epochs of {tr8.num_batches} steps, loss {epochs[0][1]:.4f} -> "
        f"{epochs[-1][1]:.4f}, recall@10 {recall[3]:.4f} at epoch 3 and {recall[6]:.4f} at epoch 6 (TPU records, "
        f"R=1: {A20_RECORDS_EPOCH6[0]}-{A20_RECORDS_EPOCH6[1]} at epoch 6; floor {A20_RECALL10_FLOOR})")
    facts["R8"] = {"epoch_s": [e for e, _ in epochs], "loss": [m for _, m in epochs], "recall@10": recall,
                   "steps_per_epoch": tr8.num_batches, "samples_per_epoch": tr8.samples_per_epoch}

    # R = 0: one epoch (the epoch-start linearization only has to stay finite)
    tr0 = cadence_trainer(ds, fs, dev, relin_every=0)
    dt, mean, losses = _timed_epoch(tr0)
    steps += tr0.num_batches
    r0 = tr0.test()
    n_eval += 1
    assert np.isfinite(losses).all() and all(np.isfinite(v) for v in r0.values()), (mean, r0)
    facts["R0"] = {"epoch_s": dt, "loss_first_last_tenth": _falls(losses), "recall@10": r0["recall@10"],
                   "steps_per_epoch": tr0.num_batches}
    log(f"train-textsage-20k R=0: loss {facts['R0']['loss_first_last_tenth']} (first and last tenth), "
        f"recall@10 {r0['recall@10']:.4f}")
    del tr0

    # T = 8: the feature parameters held inside each super-step, moved at its end
    tr_t = cadence_trainer(ds, fs, dev, feature_update_every=CADENCE_BLOCK)
    feat = [dict(tr_t.model.named_parameters())[k] for k in tr_t.feature_names]
    held = {"last": [p.detach().clone() for p in feat], "inner": 0, "super": 0, "bad": []}

    def pre_feat(opt, args, kwargs):
        if not all(torch.equal(p.detach(), q) for p, q in zip(feat, held["last"])):
            held["bad"].append(f"a feature parameter moved inside super-step {held['super']}")
        if held["inner"] != CADENCE_BLOCK:
            held["bad"].append(f"{held['inner']} inner steps in super-step {held['super']}")

    def post_feat(opt, args, kwargs):
        now = [p.detach().clone() for p in feat]
        if all(torch.equal(a, b) for a, b in zip(now, held["last"])):
            held["bad"].append(f"the feature parameters did not move at super-step {held['super']}")
        held.update(last=now, inner=0, super=held["super"] + 1)

    def post_dense(opt, args, kwargs):
        held["inner"] += 1

    hooks = [tr_t.opt_feat.register_step_pre_hook(pre_feat), tr_t.opt_feat.register_step_post_hook(post_feat),
             tr_t.optimizer.register_step_post_hook(post_dense)]
    dt, mean, losses = _timed_epoch(tr_t)
    for h in hooks:
        h.remove()
    steps += tr_t.num_batches
    rt = tr_t.test()
    n_eval += 1
    first, last = _falls(losses)
    assert not held["bad"], held["bad"][:5]
    assert held["super"] == tr_t.num_batches // CADENCE_BLOCK, held["super"]
    assert np.isfinite(losses).all() and last < first, (first, last)
    facts["T8"] = {"epoch_s": dt, "loss_first_last_tenth": [first, last], "recall@10": rt["recall@10"],
                   "super_steps": held["super"], "steps_per_epoch": tr_t.num_batches}
    log(f"train-textsage-20k T=8: {held['super']} super-steps, the feature parameters bit-identical inside "
        f"each and moved at its end; loss {first:.4f} -> {last:.4f}, recall@10 {rt['recall@10']:.4f}")

    # dask: the numeric columns on disk, read through MemmapNumeric
    mms = {}
    for side in ("user", "item"):
        path = os.path.join(tmp, f"{side}_numeric.npy")
        mms[side] = MemmapNumeric.write(path, getattr(fs, side).numeric.numpy())
    trd = cadence_trainer(ds, fs, dev, name="dask", ooc=mms)
    numeric = {k: p for k, p in trd.model.named_parameters() if "_numeric_" in k}
    start = {k: p.detach().clone() for k, p in numeric.items()}
    moved_inside = []

    def post_dask(opt, args, kwargs):
        moved_inside.extend(k for k, p in numeric.items() if not torch.equal(p.detach(), start[k]))

    h = trd.optimizer.register_step_post_hook(post_dask)
    dt, mean, losses = _timed_epoch(trd)
    h.remove()
    steps += trd.num_batches
    rd = trd.test()
    n_eval += 1
    first, last = _falls(losses)
    assert not moved_inside, f"numeric linears moved inside the epoch: {sorted(set(moved_inside))}"
    assert all(not torch.equal(p.detach(), start[k]) for k, p in numeric.items()), "no numeric linear moved"
    assert np.isfinite(losses).all() and last < first, (first, last)
    proj_err, grad_rel = 0.0, 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    for side, mm in mms.items():
        w, b = numeric[f"{side}_numeric_w"].detach(), numeric[f"{side}_numeric_b"].detach()
        x = getattr(fs, side).numeric.to(dev)
        in_core = x @ w + b
        # one chunk (the default), and OOC_CHUNK rows a chunk: several in
        # flight on the side stream
        for chunk in (None, OOC_CHUNK):
            streamed = stream_project(mm, w, b) if chunk is None else stream_project(mm, w, b, chunk=chunk)
            torch.testing.assert_close(streamed, in_core, rtol=1e-5, atol=1e-6 * float(in_core.abs().max()))
            proj_err = max(proj_err, float((streamed - in_core).abs().max()))
        # X^T G against the in-core product: each element within 1e-5 of the
        # sum of the magnitudes added into it (only the order of the float32
        # sums differs)
        g = torch.randn(in_core.shape, generator=gen, device=dev)
        gw, gb = stream_project_grad(mm, g, chunk=OOC_CHUNK)
        want_w, mag_w = x.T @ g, x.abs().T @ g.abs()
        assert (gw - want_w).abs().le(1e-5 * mag_w).all(), f"{side}: stream_project_grad off X^T G"
        torch.testing.assert_close(gb, g.sum(0), rtol=1e-5, atol=1e-5 * float(g.abs().sum(0).max()))
        grad_rel = max(grad_rel, float(((gw - want_w).abs() / mag_w.clamp_min(1e-30)).max()))
    n_chunks = -(-A20_USERS // OOC_CHUNK)
    facts["dask"] = {"epoch_s": dt, "loss_first_last_tenth": [first, last], "recall@10": rd["recall@10"],
                     "stream_project_max_abs_err": proj_err, "stream_project_grad_max_err_over_magnitude": grad_rel,
                     "check_chunk": OOC_CHUNK, "steps_per_epoch": trd.num_batches}
    log(f"train-textsage-20k dask: numeric linears held inside the epoch and moved after it; stream_project "
        f"in one chunk and in chunks of {OOC_CHUNK} rows ({n_chunks} on the user side) equal to the in-core "
        f"projection (max abs err {proj_err:.3g}); stream_project_grad equal to X^T G (max err / magnitude "
        f"{grad_rel:.3g}); loss {first:.4f} -> {last:.4f}, recall@10 {rd['recall@10']:.4f}")

    launches = {"scatter_add_rows": sc.launches, "masked_topk": st.launches}
    assert launches["scatter_add_rows"] == 2 * steps, f"scatter launched {launches} in {steps} steps"
    assert launches["masked_topk"] == n_eval * n_tiles, f"masked_topk {launches} for {n_eval} x {n_tiles} tiles"
    log(f"train-textsage-20k: scatter launches {launches['scatter_add_rows']} (2 per step over {steps} steps), "
        f"masked_topk launches {launches['masked_topk']} ({n_tiles} tiles per evaluation)")
    facts.update(launches=launches, steps=steps, evaluations=n_eval, eval_tiles=n_tiles)
    facts["trainers"] = {"R8": tr8, "T8": tr_t, "dask": trd}
    return facts


def _draws(model, graph, batch, gen) -> dict:
    """A step's presampled draws for ``Trainer.train_epoch(draws=)``, as the
    loss's keyword arguments: the (user, pos, neg) fanout trees, and asage's
    attribute trees beside them; none for a loss that samples no trees
    (sasrec)."""
    params = inspect.signature(model.loss).parameters
    seeds = ((batch.user, "user"), (batch.pos, "item"), (batch.neg, "item"))
    out = {}
    if "trees" in params:
        out["trees"] = [model.sample_seed_tree(graph, s, side, gen) for s, side in seeds]
    if "attr_trees" in params:
        out["attr_trees"] = [model.sample_attr_tree(s, side, gen) for s, side in seeds]
    return out


def _draws_to(draws: dict, dev) -> dict:
    """``_draws``' output on ``dev``."""
    return {k: [[lvl.to(dev) for lvl in tree] for tree in trees] for k, trees in draws.items()}


def _block(trainer, gen, n):
    """n batches (and their draws) drawn on the card with the trainer's
    alias tables."""
    cfg = trainer.config
    bs = cfg.bpr_batch_size
    allb = sample_bpr(gen, trainer.graph, n * bs, cfg.neg_candidates,
                      edge_alias=trainer.edge_alias, neg_alias=trainer.neg_alias)
    batches = [allb.slice(i * bs, (i + 1) * bs) for i in range(n)]
    return batches, [_draws(trainer.model, trainer.graph, b, gen) for b in batches]


def _optimizers(trainer) -> list:
    """The trainer's Adams: the one over every step's parameters, and under
    T > 1 the feature parameters' own."""
    return [o for o in (trainer.optimizer, trainer.opt_feat) if o is not None]


_RELU = torch.relu
GATE_TOL = 1e-5  # a ReLU gate may differ where |x| <= this x its tensor's largest magnitude


class _ReluGates:
    """``torch.relu`` recorded on one run and replayed on another. The CPU's
    run keeps each call's gate (x > 0) in order; the card's run then takes,
    call by call, the CPU's gate (``torch.where(gate, x, 0)``, whose gradient
    is that gate) and counts where its own differs: there x must lie within
    ``GATE_TOL`` of its tensor's largest magnitude from 0, where float32
    rounding puts it on either side of the kink."""

    def __init__(self):
        self.gates, self.next, self.flips, self.worst = [], 0, 0, 0.0

    def record(self, x):
        self.gates.append((x > 0).cpu())
        return _RELU(x)

    def replay(self, x):
        gate, self.gates[self.next] = self.gates[self.next].to(x.device), None
        self.next += 1
        if x.numel() == 0:
            return _RELU(x)
        mag = x.detach().abs()
        flip = (x > 0) != gate
        self.flips = self.flips + flip.sum()
        self.worst = torch.maximum(torch.as_tensor(self.worst, device=x.device),
                                   (mag * flip).max() / mag.max().clamp_min(1e-30))
        return torch.where(gate, x, 0.0)


def held_steps(ds, fs, cfg, params, batches, draws, dev, align_gates=True) -> tuple:
    """``Trainer.train_epoch`` over the same batches and draws on the CPU and
    on the card from the same parameters, dropout 0, each optimizer step of
    the card's run begun from the CPU's state: the CPU's run records its
    parameters and Adam moments after every step, and after each step of the
    card's, once the two are compared, the card takes the CPU's. With
    ``align_gates`` the card's ReLUs take the CPU's gates (``_ReluGates``).
    Returns the card's and the CPU's losses, for each optimizer step {name:
    |card - CPU|} of every parameter and the CPU's parameters, and the gates
    (flips, and the largest |x| / max |x| at a flip) or None."""
    got, per_step = {}, []
    gates = _ReluGates() if align_gates else None
    rates = (sage.DROPOUT_RATE, asage.DROPOUT_RATE, sasrec.DROPOUT)
    sage.DROPOUT_RATE = asage.DROPOUT_RATE = sasrec.DROPOUT = 0.0
    try:
        for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
            model = build_model(cfg.model, cfg, ds.graph, **model_inputs_20k(cfg.model, ds, fs))
            params_from_jax(params, model)
            tr = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=ddp_recipe(cfg.model),
                         device=d)
            named, opts = dict(tr.model.named_parameters()), _optimizers(tr)

            def record(*_):
                got.setdefault("states", []).append(
                    ({k: p.detach().clone() for k, p in named.items()},
                     [copy.deepcopy(o.state_dict()) for o in opts]))

            def force(*_):
                ref, moments = got["states"][len(per_step)]
                per_step.append({k: (p.detach().cpu() - ref[k]).abs().numpy() for k, p in named.items()})
                with torch.no_grad():
                    for k, p in named.items():
                        p.copy_(ref[k])
                for o, m in zip(opts, moments):
                    o.load_state_dict(m)

            hooks = [o.register_step_post_hook(record if name == "cpu" else force) for o in opts]
            if gates is not None:
                torch.relu = gates.record if name == "cpu" else gates.replay
            try:
                losses = tr.train_epoch([b.to(d) for b in batches], draws=[_draws_to(t, d) for t in draws])
            finally:
                torch.relu = _RELU
            for h in hooks:
                h.remove()
            got[name] = losses.cpu().numpy()
    finally:
        sage.DROPOUT_RATE, asage.DROPOUT_RATE, sasrec.DROPOUT = rates
    assert len(per_step) == len(got["states"]) > 0, (len(per_step), len(got["states"]))
    if gates is not None:
        assert gates.next == len(gates.gates), (gates.next, len(gates.gates))
        gates = (int(gates.flips), float(gates.worst))
    return got["card"], got["cpu"], per_step, [ref for ref, _ in got["states"]], gates


def params_off(diff: dict, ref: dict) -> dict:
    """{name: the elements outside 1e-6 + 1e-5 |p|} of one optimizer step,
    the names with none left out."""
    off = {k: int((d > 1e-6 + 1e-5 * np.abs(ref[k].numpy())).sum()) for k, d in diff.items()}
    return {k: n for k, n in off.items() if n}


def card_vs_cpu_epoch(ds, fs, cfg, params, batches, draws, dev, label) -> dict:
    """``held_steps`` under phase 10's rule at every optimizer step: every
    parameter within 2 x lr, all but 1e-3 of them within 1e-6 + 1e-5 |p|;
    the losses within rtol 1e-4; the card's ReLU gates equal to the CPU's
    but where |x| <= ``GATE_TOL`` x max |x|. Both alignments are needed
    (``tools/card_vs_cpu_spread.py``): held only at the end of the run,
    Adam's +-lr step on a gradient within rounding of 0 gives the next steps
    different inputs, and their steps part over thousands of parameters in
    some 1 run of 10; held step by step, a gate at a rounding-level x of an
    entity that many rows share (a popular item) moves that side's feature
    gradients by about 1e-3 and thousands of parameters past the rule in
    some 1 step of 60."""
    lc, lp, per_step, refs, (flips, worst_gate) = held_steps(ds, fs, cfg, params, batches, draws, dev)
    np.testing.assert_allclose(lc, lp, rtol=1e-4)
    assert worst_gate <= GATE_TOL, f"{label}: a ReLU gate differs at |x| = {worst_gate:.3g} x max |x|"
    total = sum(d.size for d in per_step[0].values())
    off, worst = [], 0.0
    for i, (diff, ref) in enumerate(zip(per_step, refs)):
        for k, d in diff.items():
            assert (d <= 2 * cfg.lr).all(), f"{label} step {i + 1} {k}: {d.max()}"
            worst = max(worst, float(d.max()))
        by_name = params_off(diff, ref)
        off.append(sum(by_name.values()))
        assert off[-1] <= 1e-3 * total, f"{label} step {i + 1}: {off[-1]} of {total} parameters differ: {by_name}"
    log(f"{label} ({len(batches)} steps, {len(per_step)} optimizer steps each held from the CPU's state; "
        f"{flips} ReLU gates taken from the CPU's, at |x| <= {worst_gate:.3g} x max |x|): losses within rtol "
        f"1e-4 (max rel {float(np.max(np.abs(lc - lp) / np.abs(lp))):.3g}); parameters within 1e-6 + 1e-5 |p| "
        f"but {off} of {total} (max abs diff {worst:.3g})")
    return {"losses_card": lc.tolist(), "losses_cpu": lp.tolist(), "params_off": off,
            "params_total": total, "max_abs_diff": worst, "relu_gates_taken": flips,
            "relu_gate_max_rel_x": worst_gate}


def card_vs_cpu_cadences(ds, fs, trainer8, dev) -> dict:
    """Phase 12's card-against-CPU check: one R = 8 block and one T = 8
    super-step, dropout 0, from the same parameters, batches and trees."""
    params = params_to_numpy(trainer8.model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    batches, draws = _block(trainer8, gen, CADENCE_BLOCK)
    return {cadence: card_vs_cpu_epoch(ds, fs, a20_config(**over), params, batches, draws, dev,
                                       f"train-textsage-20k card vs CPU, {cadence}")
            for cadence, over in (("R8", {"relin_every": CADENCE_BLOCK}),
                                  ("T8", {"feature_update_every": CADENCE_BLOCK}))}


def cadence_numbers(trainer, label, profile_steps=2 * CADENCE_BLOCK, epoch_s=None) -> dict:
    """Samples/s and host ms a step from a timed epoch (``epoch_s``: the
    seconds of one the caller timed, else one timed here); device ms and
    operations a step from ``profile_steps`` profiled steps run through
    ``train_epoch`` (whole blocks of the cadence; the dask epoch's streamed
    passes count only when the whole epoch is profiled); and the idle share of
    an unprofiled step (1 - device / host)."""
    if epoch_s is None:
        epoch_s, _, _ = _timed_epoch(trainer)
    steps = trainer.num_batches
    bs = trainer.config.bpr_batch_size
    batches = trainer.sample_epoch()
    blocks = [batches.slice(i * bs, (i + 1) * bs) for i in range(min(profile_steps, steps))]
    torch.cuda.synchronize()
    prof = split_profile(lambda: trainer.train_epoch(blocks), n=1)
    out = {"epoch_s": epoch_s, "samples_per_s": trainer.samples_per_epoch / epoch_s,
           "host_ms_per_step": 1e3 * epoch_s / steps, "steps_per_epoch": steps, "profiled_steps": len(blocks)}
    if prof is not None:
        k = len(blocks)
        out.update(device_ms_per_step=prof["device_ms"] / k,
                   device_ops_per_step=prof["device_ops_per_call"] / k,
                   split_ms_per_step={name: v / k for name, v in prof["split_ms"].items()})
        out["idle_share_unprofiled"] = 1.0 - out["device_ms_per_step"] / out["host_ms_per_step"]
        log(f"{label}: {out['samples_per_s']:.0f} samples/s; a step {out['host_ms_per_step']:.2f} ms on the "
            f"host, {out['device_ms_per_step']:.3f} ms on the device in {out['device_ops_per_step']:.0f} "
            f"operations; idle {out['idle_share_unprofiled']:.3f}")
    return out



def scatter_per_step(name: str) -> int:
    """The scatter launches a training step of key ``name`` makes."""
    return SCATTER_PER_STEP.get(name, 2)


def key_label(name, over) -> str:
    """A registry key and the config field that picks its conv."""
    if "conv" in over:
        return f"{name} --conv {over['conv']}"
    if "multi_relational" in over:
        return f"{name} {over['multi_relational']}"
    return name


def sasrec_config(**over) -> Config:
    """The anchor recipe of the JAX package's sasrec record."""
    return Config(latent_dim=SEQ_D, bpr_batch_size=SEQ_B, lr=1e-3, decay=1e-6, user_feature="nwt",
                  item_feature="nwt", eval_user_batch=A20_EVAL_TILE, topks=(10, 20), seed=SEED, **over)


def key_config(name, **over) -> Config:
    """A key's config on the anchor20k graph: sasrec's the anchor recipe, mf's
    and the LightGCN keys' phase 19's lgn recipe (d 64), the others' the
    flagship recipe."""
    if name == "sasrec":
        return sasrec_config(model=name, **over)
    if name not in SAGE_KEYS:
        return a20_config(model=name, latent_dim=REG_LGN_D, **over)
    return a20_config(model=name, **over)


def ddp_recipe(name) -> bool:
    """sasrec, mf and the LightGCN keys train with the uniform sampler, the
    others with the ddp recipe."""
    return name in SAGE_KEYS and name != "sasrec"


def model_inputs_20k(name, ds, fs) -> dict:
    """A key's inputs beside the graph: the features (not mf's or the
    LightGCN keys'), sasrec's item sequences."""
    out = {"features": fs} if name in SAGE_KEYS else {}
    if name == "sasrec":
        out["sequences"] = build_sequences(ds)
    return out


def model_20k(ds, fs, name, seed, **over):
    cfg = key_config(name, **over)
    return cfg, build_model(name, cfg, ds.graph, generator=torch.Generator().manual_seed(seed),
                            **model_inputs_20k(name, ds, fs))


def propagation_vs_cpu(got, cfg, ds, fs, params) -> tuple:
    """The card's propagation (user and item rows stacked) against the CPU's
    of the same parameters. The SAGE family under phase 9's rule: both round
    the text-bag SpMM operands of the all-entity tables to bfloat16, the
    convs run in float32. sasrec assembles its items per id and runs in
    float32 throughout on both, so it is held at rtol 1e-4, atol 1e-5 of the
    largest magnitude (a TF32 or bfloat16 product would break that). mf and
    the LightGCN keys under phase 4's rule, against a float64 propagation
    on the same rounded inputs (radj's float32 operands are not rounded; mf
    propagates nothing). Returns (max abs err, largest magnitude, the
    rule)."""
    if cfg.model not in SAGE_KEYS:
        asym = cfg.model == "radj"
        want = reference_propagate(ds.graph, params, 0 if cfg.model == "mf" else cfg.n_layers,
                                   torch.float32 if asym else getattr(torch, cfg.compute_dtype),
                                   r=cfg.r if asym else None)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)
        return float(np.abs(got - want).max()), float(np.abs(want).max()), "rtol 0.002, atol 1e-05 (float64)"
    cpu_model = build_model(cfg.model, cfg, ds.graph, **model_inputs_20k(cfg.model, ds, fs))
    params_from_jax(params, cpu_model)
    with torch.no_grad():
        cu, ci = cpu_model.propagate(ds.graph)
    want = torch.cat([cu, ci]).numpy()
    assert got.shape == want.shape == (ds.n_users + ds.m_items, cpu_model.node_dim) and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    rtol, atol = (1e-4, 1e-5) if cfg.model == "sasrec" else (2e-2, 2e-3)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)
    return float(np.abs(got - want).max()), scale, f"rtol {rtol:g}, atol {atol:g} x max |x|"


def serve_20k(ds, fs, dev, name, label, wide_k=None, **over) -> tuple:
    """The Recommender of a seeded model on the anchor20k graph (ds.graph:
    for rsage its relational graph); requests of 1 / 8 / 64 / 512 users at
    k = 20 and, with ``wide_k``, of 512 at wide_k (the radix select, one
    launch); two more over HTTP, the second at wide_k when given; each answer
    against the plain version; the refresh against a CPU propagation.
    Returns (facts, recommender)."""
    cfg, model = model_20k(ds, fs, name, SEED, **over)
    params = params_to_numpy(model)
    users = {b: np.random.default_rng(SEED + 30 + b).choice(ds.n_users, size=b, replace=False)
             for b in TS_TILES}
    t0 = time.perf_counter()
    rec = Recommender(model, ds, cfg, None, device="cuda")
    torch.cuda.synchronize()
    first_refresh_s = time.perf_counter() - t0
    # (users, k) of each direct request; the last two are the HTTP ones' users
    http = ((np.array([17]), TS_K), (np.array([3, ds.n_users - 1]), wide_k or TS_K))
    requests = [(users[b], TS_K) for b in TS_TILES] + ([(users[512], wide_k)] if wide_k else []) + list(http)
    answers = []
    for u, k in requests:
        before = (st.launches, st.wide_launches)
        answers.append(rec.recommend(u, k=k))
        assert (st.launches, st.wide_launches) == (before[0] + 1, before[1] + (k > st.MAX_K)), (
            f"B={len(u)} k={k}: {st.launches - before[0]} launches, {st.wide_launches - before[1]} wide")
    srv = make_server(rec, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        before = (st.launches, st.wide_launches)
        one = json.load(urllib.request.urlopen(f"{base}/recommend?user=17&k={http[0][1]}", timeout=60))
        req = urllib.request.Request(
            f"{base}/recommend", data=json.dumps({"users": http[1][0].tolist(), "k": http[1][1]}).encode(),
            method="POST",
        )
        batch = json.load(urllib.request.urlopen(req, timeout=60))
        wide = sum(k > st.MAX_K for _, k in http)
        assert (st.launches, st.wide_launches) == (before[0] + 2, before[1] + wide), (
            "the HTTP requests did not launch the kernel once each")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    assert not th.is_alive()
    n_requests = len(answers) + 2

    U, I = rec._user_emb, rec._item_emb
    mask = (rec._mask.indptr, rec._mask.indices)
    pos = ds.all_pos()
    max_err = 0.0
    for (u, k), (ids, scores) in zip(requests, answers):
        assert ids.shape == (len(u), k) and np.isfinite(scores).all()
        rv, ri = st.masked_topk_reference(U, I, torch.from_numpy(u).to(dev), k, *mask,
                                          sigmoid=model.score_sigmoid)
        max_err = max(max_err, compare(torch.from_numpy(scores), torch.from_numpy(ids), rv, ri, exact=False))
        for uid, row in zip(u, ids):
            assert not set(row.tolist()) & set(pos[uid].tolist()), "a train positive was served"
    assert one["items"] == answers[-2][0][0].tolist()
    assert [r["items"] for r in batch] == answers[-1][0].tolist()
    prop_err, scale, rule = propagation_vs_cpu(torch.cat([U, I]).cpu().numpy(), cfg, ds, fs, params)
    wide = ""
    if wide_k:
        n_wide = sum(k == wide_k for _, k in requests + [http[1]])  # the POST's too
        wide = f" ({n_wide} at k = {wide_k}: one radix-select launch each)"
    log(f"{label}: {n_requests} requests{wide}, answers equal to the plain version (max abs err {max_err:.3g}); "
        f"refresh equal to the CPU's propagation within {rule} (max abs err {prop_err:.3g} of {scale:.3g}); "
        f"first refresh {first_refresh_s:.2f} s")
    return {"requests": n_requests, "max_abs_err": max_err, "propagate_vs_cpu_max_abs_err": prop_err,
            "first_refresh_s": first_refresh_s, "users_512": users[512]}, rec


def train_keys_20k(keys, inputs, dev, phase, first_epochs, long=1) -> dict:
    """The first ``long`` keys for ``first_epochs`` epochs each between two
    evaluations (the last epoch's loss below the first's, recall@10 above its
    start but for RECALL_FLAT's keys), then one epoch and one evaluation of
    each other key (the loss falling from the epoch's first tenth to its
    last). ``inputs(name)``: the (dataset, features) of a key. Returns facts,
    the trainers under "trainers" and the scatter launches the steps must
    make under "scatter_expected" (``scatter_per_step`` a step). sasrec, mf
    and the LightGCN keys train with the uniform sampler, the others with
    the ddp recipe."""
    steps, n_eval, expected, facts, trainers = 0, 0, 0, {}, {}
    for i, (name, over) in enumerate(keys):
        label = key_label(name, over)
        ds, fs = inputs(name)
        cfg, model = model_20k(ds, fs, name, SEED + 1, **over)
        tr = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=ddp_recipe(name), device=dev)
        tr.init_state()
        n_tiles = int(tr.eval_data.users.shape[0])
        epochs = first_epochs if i < long else 1
        before = tr.test() if i < long else None
        runs = []
        for _ in range(epochs):
            runs.append(_timed_epoch(tr))
            steps += tr.num_batches
            expected += scatter_per_step(name) * tr.num_batches
        after = tr.test()
        n_eval += 1 + (before is not None)
        assert all(np.isfinite(v) for v in after.values()), after
        if before is None:  # one epoch: the loss falls from its first tenth to its last
            first, last = _falls(runs[0][2])
        else:  # the mean loss of the last epoch below the first's; recall above its start
            first, last = runs[0][1], runs[-1][1]
            if name not in RECALL_FLAT:
                assert after["recall@10"] > before["recall@10"], (before["recall@10"], after["recall@10"])
        assert np.isfinite([r[1] for r in runs]).all() and last < first, f"{label}: loss {first} -> {last}"
        facts[label] = {"epochs": epochs, "epoch_s": [r[0] for r in runs], "loss": [r[1] for r in runs],
                        "loss_first_last": [first, last], "steps_per_epoch": tr.num_batches,
                        "recall@10": ([before["recall@10"]] if before else []) + [after["recall@10"]],
                        "recall@20": after["recall@20"]}
        log(f"{phase} {label}: {epochs} epoch(s) of {tr.num_batches} steps, loss {first:.4f} -> "
            f"{last:.4f}"
            f"{' (first and last tenth)' if before is None else ''}, recall@10 "
            + (f"{before['recall@10']:.4f} -> " if before else "") + f"{after['recall@10']:.4f}")
        trainers[label] = tr
    facts.update(steps=steps, evaluations=n_eval, eval_tiles=n_tiles, trainers=trainers,
                 scatter_expected=expected)
    return facts


def attention_20k(ds, fs, dev, textsage_r1) -> dict:
    """Phase 13: the attention SAGE models on the anchor20k graph, served
    and trained (the path, with the launch counts set to 0 before it and
    read after), then their checks against the plain top-k and the CPU, and
    their numbers."""
    st.launches = st.wide_launches = sc.launches = 0
    serve, rec = serve_20k(ds, fs, dev, "tgrec", "serve-tgrec-20k", wide_k=ATT_K)
    serve_topk = st.launches
    assert sc.launches == 0, "the serve path launched the scatter kernel"
    assert st.wide_launches == 3, f"{st.wide_launches} radix-select launches for the 3 requests at k = {ATT_K}"
    train = train_keys_20k(ATT_KEYS, lambda name: (ds, fs), dev, "train-attention-20k", ATT_EPOCHS)
    train.pop("scatter_expected")
    launches = {"masked_topk": st.launches, "masked_topk_wide": st.wide_launches,
                "scatter_add_rows": sc.launches}
    assert launches["masked_topk_wide"] == 3, launches
    n_tiles = train["eval_tiles"]
    assert launches["scatter_add_rows"] == 2 * train["steps"], f"scatter {launches} in {train['steps']} steps"
    assert launches["masked_topk"] == serve_topk + train["evaluations"] * n_tiles, launches
    log(f"attention-20k: scatter launches {launches['scatter_add_rows']} (2 per step over {train['steps']} "
        f"steps), masked_topk launches {launches['masked_topk']} ({serve_topk} serving, {n_tiles} tiles per "
        f"evaluation)")
    trainers = train.pop("trainers")

    # checks: every evaluation against the plain top-k, tgrec on the CPU
    for label, tr in trainers.items():
        train[label]["eval_vs_plain"] = eval_kernel_vs_plain(tr)
    tg = trainers["tgrec"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    batches, draws = _block(tg, gen, ATT_STEPS_VS_CPU)
    train["tgrec"]["card_vs_cpu"] = card_vs_cpu_epoch(
        ds, fs, tg.config, params_to_numpy(tg.model), batches, draws, dev, "attention-20k tgrec card vs CPU")

    # numbers: the refresh, masked_topk at B = 512 and k = 200, each key's step
    serve["refresh_ms"] = host_ms(lambda: rec.refresh(None), reps=10)
    serve["refresh_profile"] = device_profile(lambda: rec.refresh(None), n=5)
    u512 = torch.from_numpy(serve.pop("users_512")).to(dev)
    mask = (rec._mask.indptr, rec._mask.indices)
    serve["topk"] = {f"k{k}": topk_numbers(rec._user_emb, rec._item_emb, u512, k, mask, CSR(*mask), dev,
                                           request=lambda k=k: rec.recommend(u512.cpu().numpy(), k=k))
                     for k in (TS_K, ATT_K)}
    k200 = serve["topk"][f"k{ATT_K}"]
    log(f"serve-tgrec-20k: refresh {serve['refresh_ms']:.3f} ms on the host, "
        f"{(serve['refresh_profile'] or {}).get('device_ms')} ms on the device; masked_topk B=512 k={ATT_K}: "
        f"call {k200['ms']:.4f} ms, device {(k200['kernel_profile'] or {}).get('device_ms')} ms, library "
        f"{k200['library_ms']:.4f} ms, plain {k200['plain_ms']:.4f} ms, bound {k200['bound_ms']:.5f} ms")
    numbers = {label: cadence_numbers(tr, f"attention-20k {label}", profile_steps=ATT_PROFILE_STEPS)
               for label, tr in trainers.items()}
    del trainers, tg
    return {"serve": serve, "train": train, "numbers": numbers, "textsage_R1": textsage_r1,
            "launches": launches}


def edge_20k_data(ds, fs, tmp) -> tuple:
    """Phase 14's inputs on phase 12's graph and features: the seeded
    relation sets written as the reference's two CSVs under ``tmp``
    (``write_edge_artifacts``) and read through load_relation_edges into the
    relational graph and its labels (rsage), and the seeded purchase times
    aligned to the user-CSR edge order (tgsrec, sasgnn). Returns ((dataset,
    features) of rsage, of the time keys, facts)."""
    t0 = time.perf_counter()
    write_edge_artifacts(ds, tmp, seed=SEED)
    rel = load_relation_edges(Config(), tmp)
    graph, labels = build_relational_graph(ds, rel)
    rel_ds = dataclasses.replace(ds, _graph=graph, _inference_graph=None)
    rel_fs = dataclasses.replace(fs, edge_label=labels, n_relations=len(rel) + 1)
    time_fs = dataclasses.replace(fs, edge_time=edge_time_in_csr_order(ds, synthetic_edge_times(ds, seed=SEED)))
    host_s = time.perf_counter() - t0
    counts = np.bincount(labels.numpy()).tolist()
    assert counts[0] == ds.train_size and graph.prop_user_pos.nnz == sum(counts)
    log(f"edge-20k data: {graph.prop_user_pos.nnz} message edges (purchases, favourites, reviews: {counts}) "
        f"through the CSVs into the relational graph, purchase times per train edge ({host_s:.1f} s)")
    return (rel_ds, rel_fs), (ds, time_fs), {"data_s": host_s, "message_edges": graph.prop_user_pos.nnz,
                                             "label_counts": counts}


def refresh_vs_cpu(ds, fs, dev, name, **over) -> dict:
    """A seeded model's full-graph propagation on the card against the CPU's
    (phase 9's rule), and its host and device times."""
    cfg, model = model_20k(ds, fs, name, SEED + 2, **over)
    params = params_to_numpy(model)
    model.to(dev)
    graph = ds.graph.to(dev)

    def refresh():
        with torch.no_grad():
            return model.propagate(graph)

    u, i = refresh()
    err, scale, rule = propagation_vs_cpu(torch.cat([u, i]).cpu().numpy(), cfg, ds, fs, params)
    out = {"max_abs_err": err, "scale": scale, "refresh_ms": host_ms(refresh, reps=10),
           "refresh_profile": device_profile(refresh, n=5)}
    log(f"refresh {key_label(name, over)}: equal to the CPU's propagation within {rule} "
        f"(max abs err {err:.3g} of {scale:.3g}); {out['refresh_ms']:.3f} ms on the host, "
        f"{(out['refresh_profile'] or {}).get('device_ms')} ms on the device")
    return out


def recency_first_max_on_card(ds, fs, dev) -> dict:
    """sasgnn's sampled conv on the card and on the CPU over a user level of
    B = 5000 with F = 5 slots whose times tie (slot 3 repeats slot 0's edge,
    rows different as dropout leaves them, and times are tenths): the slot
    picked is the first of the latest time on the card as on the CPU."""
    rng = np.random.default_rng(SEED + 15)
    b, f = 5000, 5
    graph = ds.graph
    pos = rng.integers(0, graph.prop_user_pos.nnz, (b, f)).astype(np.int32)
    pos[:, 3] = pos[:, 0]
    t = (np.round(rng.random(graph.prop_user_pos.nnz) * 10) / 10).astype(np.float32)
    x = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         for k, shape in (("target", (b, TS_D)), ("nbrs", (b, f, TS_D)))}
    lp = {k: torch.from_numpy(v) for k, v in
          (("w", 0.2 * rng.standard_normal((2 * TS_D, TS_D)).astype(np.float32)), ("b", np.zeros(TS_D, np.float32)))}
    conv = get_conv("recency")
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        ctx = {"neighbors": x["nbrs"].to(d), "side": "user", "graph": graph.to(d), "edge_pos": torch.from_numpy(pos).to(d),
               "edge_time": torch.from_numpy(t).to(d)}
        slots = edge_feature(ctx, ctx["edge_time"])
        out[name] = (torch.argmax(slots, dim=-1).cpu().numpy(),
                     conv.sampled({k: v.to(d) for k, v in lp.items()}, x["target"].to(d),
                                  ctx["neighbors"].mean(dim=-2), ctx).cpu().numpy())
    first = np.argmax(t[pos], axis=-1)  # numpy's argmax: the first maximum
    ties = int(((t[pos] == t[pos].max(-1, keepdims=True)).sum(-1) > 1).sum())
    np.testing.assert_array_equal(out["card"][0], first)
    np.testing.assert_array_equal(out["cpu"][0], first)
    np.testing.assert_allclose(out["card"][1], out["cpu"][1], rtol=1e-5, atol=1e-5)
    log(f"recency on the card: the first slot of the latest time in each of {b} rows ({ties} tied at the "
        f"latest), as on the CPU; the conv's output equal to the CPU's")
    return {"rows": b, "rows_tied_at_latest": ties}


def recorded_gathers(fn) -> list:
    """(N, D, ids) of every ``table_gather`` that ``fn()`` makes, in the
    forward's order: the tables' shapes and the clamped ids that the
    backward's scatter launches receive. ``fn`` runs."""
    seen, forward = [], sc._TableGather.forward

    def recording(ctx, table, ids):
        seen.append((table.shape[0], table.shape[1], ids.reshape(-1).clamp(0, table.shape[0] - 1)))
        return forward(ctx, table, ids)

    sc._TableGather.forward = staticmethod(recording)
    try:
        fn()
    finally:
        sc._TableGather.forward = staticmethod(forward)
    return seen


def step_gathers(trainer, batch, draws) -> list:
    """``recorded_gathers`` of one training step of ``trainer`` on ``batch``
    (the step is taken)."""
    return recorded_gathers(lambda: trainer.train_epoch([batch], draws=[draws]))


def edge_20k(ds, fs, dev, textsage_r1, tgrec) -> dict:
    """Phase 14: the edge-feature SAGE models on the anchor20k graph, served
    and trained (the path, with the launch counts set to 0 before it and read
    after), then their checks against the plain top-k and the CPU, and their
    numbers beside phase 12's TextSAGE R = 1 and phase 13's tgrec."""
    with tempfile.TemporaryDirectory() as tmp:
        (rel_ds, rel_fs), (time_ds, time_fs), data = edge_20k_data(ds, fs, tmp)

    def inputs(name):
        return (rel_ds, rel_fs) if name == "rsage" else (time_ds, time_fs)

    st.launches = sc.launches = 0
    serve, rec = serve_20k(rel_ds, rel_fs, dev, "rsage", "serve-rsage-20k", multi_relational="add")
    serve_topk = st.launches
    assert sc.launches == 0, "the serve path launched the scatter kernel"
    train = train_keys_20k(EDGE_KEYS, inputs, dev, "train-edge-20k", EDGE_EPOCHS)
    launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
    n_tiles = train["eval_tiles"]
    expected = train.pop("scatter_expected")
    assert launches["scatter_add_rows"] == expected, f"scatter {launches}, expected {expected}"
    assert launches["masked_topk"] == serve_topk + train["evaluations"] * n_tiles, launches
    log(f"edge-20k: scatter launches {launches['scatter_add_rows']} (4 per rsage step, 2 per tgsrec / sasgnn "
        f"step over {train['steps']} steps), masked_topk launches {launches['masked_topk']} ({serve_topk} "
        f"serving, {n_tiles} tiles per evaluation)")
    trainers = train.pop("trainers")

    # checks: every evaluation against the plain top-k, the other convs'
    # refresh and rsage's steps against the CPU, recency's first maximum
    for label, tr in trainers.items():
        train[label]["eval_vs_plain"] = eval_kernel_vs_plain(tr)
    refresh = {key_label(name, over): refresh_vs_cpu(*inputs(name), dev, name, **over)
               for name, over in EDGE_KEYS[1:]}
    rs = trainers["rsage add"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    batches, draws = _block(rs, gen, EDGE_STEPS_VS_CPU)
    train["rsage add"]["card_vs_cpu"] = card_vs_cpu_epoch(
        rel_ds, rel_fs, rs.config, params_to_numpy(rs.model), batches, draws, dev, "edge-20k rsage card vs CPU")
    train["recency_first_max"] = recency_first_max_on_card(time_ds, time_fs, dev)

    # numbers: the refresh, each key's step, the relation-row scatter
    serve.pop("users_512")
    serve["refresh_ms"] = host_ms(lambda: rec.refresh(None), reps=10)
    serve["refresh_profile"] = device_profile(lambda: rec.refresh(None), n=5)
    log(f"serve-rsage-20k: refresh {serve['refresh_ms']:.3f} ms on the host, "
        f"{(serve['refresh_profile'] or {}).get('device_ms')} ms on the device")
    numbers = {label: cadence_numbers(tr, f"edge-20k {label}", profile_steps=ATT_PROFILE_STEPS)
               for label, tr in trainers.items()}
    rel_ids = [ids for n, _, ids in step_gathers(rs, batches[0], draws[0]) if n == rel_fs.n_relations]
    assert tuple(ids.numel() for ids in rel_ids) == REL_ROWS, [ids.numel() for ids in rel_ids]
    rel_scatter = scatter_numbers_at([(rel_fs.n_relations, ids) for ids in rel_ids], dev, TS_D,
                                     rows_seed=SEED + 17)
    del trainers, rs, rec
    return {"data": data, "serve": serve, "refresh": refresh, "train": train, "numbers": numbers,
            "relation_scatter": rel_scatter, "textsage_R1": textsage_r1, "tgrec": tgrec, "launches": launches}


def sequence_attr_20k_data(ds, fs) -> dict:
    """Phase 15's inputs on phase 12's graph and features: sasrec's item
    sequences (the train items in order, the last 50) and asage's attribute
    graphs (the informative features' categorical columns: 4 user and 5
    item fields over 32 clusters)."""
    t0 = time.perf_counter()
    seqs = model_inputs_20k("sasrec", ds, fs)["sequences"]
    attrs = asage.attributes_from_categorical(fs)
    host_s = time.perf_counter() - t0
    lengths = seqs.lengths.numpy()
    facts = {"data_s": host_s, "mean_length": float(lengths.mean()), "pad_share": float(1 - lengths.mean() / 50),
             "user_attr_pairs": len(attrs["user"][0]), "item_attr_pairs": len(attrs["item"][0]),
             "attrs": [attrs["user"][3], attrs["item"][3]]}
    assert (facts["user_attr_pairs"], facts["item_attr_pairs"]) == (4 * ds.n_users, 5 * ds.m_items)
    log(f"sequence-attr-20k data: sequences of {ds.n_users} users (mean length {facts['mean_length']:.2f} of 50 "
        f"slots, pads {facts['pad_share']:.3f}); attribute graphs of {facts['user_attr_pairs']} user and "
        f"{facts['item_attr_pairs']} item pairs over {facts['attrs']} attributes ({host_s:.1f} s)")
    return facts


def sequence_attr_20k(ds, fs, dev, textsage_r1) -> dict:
    """Phase 15: sasrec (the anchor recipe) and asage (the flagship recipe)
    on the anchor20k graph, served and trained (the path, with the launch
    counts set to 0 before it and read after), then their checks against the
    plain top-k and the CPU, and their numbers beside phase 12's TextSAGE
    R = 1."""
    t0 = time.perf_counter()
    data = sequence_attr_20k_data(ds, fs)

    st.launches = sc.launches = 0
    serve, recs = {}, {}
    for name, _ in SEQ_KEYS:
        serve[name], recs[name] = serve_20k(ds, fs, dev, name, f"serve-{name}-20k")
    serve_topk = st.launches
    assert sc.launches == 0, "the serve path launched the scatter kernel"
    train, trainers = {"steps": 0, "evaluations": 0, "scatter_expected": 0}, {}
    for key in SEQ_KEYS:
        facts = train_keys_20k((key,), lambda name: (ds, fs), dev, "train-sequence-attr-20k", SEQ_EPOCHS)
        trainers.update(facts.pop("trainers"))
        for k in ("steps", "evaluations", "scatter_expected"):
            train[k] += facts.pop(k)
        train.update(facts)
    launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
    n_tiles = train["eval_tiles"]
    expected = train.pop("scatter_expected")
    steps = {label: tr.num_batches * SEQ_EPOCHS for label, tr in trainers.items()}
    assert launches["scatter_add_rows"] == expected == 2 * steps["sasrec"] + 6 * steps["asage"], (launches, expected)
    assert launches["masked_topk"] == serve_topk + train["evaluations"] * n_tiles, launches
    recall = train["sasrec"]["recall@10"][-1]
    assert recall >= SEQ_RECALL10_FLOOR, f"sasrec recall@10 {recall} after {SEQ_EPOCHS} epochs"
    log(f"sequence-attr-20k: scatter launches {launches['scatter_add_rows']} (2 per sasrec step over "
        f"{steps['sasrec']} steps, 6 per asage step over {steps['asage']}), masked_topk launches "
        f"{launches['masked_topk']} ({serve_topk} serving, {n_tiles} tiles per evaluation); sasrec recall@10 "
        f"{recall:.4f} at epoch {SEQ_EPOCHS} (TPU record {SEQ_RECORD_EPOCH3}; floor {SEQ_RECALL10_FLOOR})")

    # checks: every evaluation against the plain top-k, 4 steps of each key
    # against the CPU
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    blocks = {}
    for label, tr in trainers.items():
        train[label]["eval_vs_plain"] = eval_kernel_vs_plain(tr)
        blocks[label] = _block(tr, gen, SEQ_STEPS_VS_CPU)
        train[label]["card_vs_cpu"] = card_vs_cpu_epoch(
            ds, fs, tr.config, params_to_numpy(tr.model), *blocks[label], dev,
            f"sequence-attr-20k {label} card vs CPU")

    # numbers: the refresh, each key's step, the new scatter shapes
    for name, rec in recs.items():
        serve[name].pop("users_512")
        serve[name]["refresh_ms"] = host_ms(lambda: rec.refresh(None), reps=10)
        serve[name]["refresh_profile"] = device_profile(lambda: rec.refresh(None), n=5)
        log(f"serve-{name}-20k: refresh {serve[name]['refresh_ms']:.3f} ms on the host, "
            f"{(serve[name]['refresh_profile'] or {}).get('device_ms')} ms on the device")
    numbers = {label: cadence_numbers(tr, f"sequence-attr-20k {label}", profile_steps=ATT_PROFILE_STEPS)
               for label, tr in trainers.items()}
    # the ids of one real step's gathers: sasrec's all, asage's but its tree
    # gathers (phase 12's shapes)
    gathers = {label: step_gathers(tr, blocks[label][0][0], blocks[label][1][0]) for label, tr in trainers.items()}
    gathers["asage"] = [g for g in gathers["asage"] if g[0] not in (ds.n_users, ds.m_items)]
    rows = {label: tuple(ids.numel() for _, _, ids in g) for label, g in gathers.items()}
    assert rows == {"sasrec": (WORD_ROWS[0], SEQ_ROWS), "asage": WORD_ROWS[1:] + ATTR_ROWS}, rows
    shapes = [shape for i, (n, d, ids) in enumerate(gathers["sasrec"] + gathers["asage"])
              for shape in scatter_numbers_at([(n, ids)], dev, d, rows_seed=SEED + 19 + i)]
    assert all(t["plan"]["mode"] == "tile" for t in shapes), [t["plan"] for t in shapes]
    del trainers, recs
    data["phase_s"] = time.perf_counter() - t0
    log(f"sequence-attr-20k: {data['phase_s']:.0f} s")
    return {"data": data, "serve": serve, "train": train, "numbers": numbers, "scatter_shapes": shapes,
            "textsage_R1": textsage_r1, "launches": launches}


def registry_20k(ds, fs, dev, scatter_held, topk_held) -> dict:
    """Phase 20: the registry keys that no other phase drives (REG_KEYS) on
    the anchor20k graph, served and trained (the path, with the launch counts
    set to 0 before it and read after, every launch's shape recorded and
    held against those phase 3 checked), then their checks against the plain
    top-k and the CPU, and their numbers."""
    t0 = time.perf_counter()
    st.launches = sc.launches = 0
    with record_launch_shapes() as shapes:
        serve, recs = {}, {}
        for name, over in REG_KEYS:
            label = key_label(name, over)
            serve[label], recs[label] = serve_20k(ds, fs, dev, name, f"serve-registry-20k {label}", **over)
        serve_topk = st.launches
        assert sc.launches == 0, "the serve path launched the scatter kernel"
        train, trainers = {"steps": 0, "evaluations": 0, "scatter_expected": 0}, {}
        for family, long in REG_FAMILIES:
            facts = train_keys_20k(family, lambda name: (ds, fs), dev, "train-registry-20k", REG_EPOCHS, long)
            trainers.update(facts.pop("trainers"))
            for k in ("steps", "evaluations", "scatter_expected"):
                train[k] += facts.pop(k)
            train.update(facts)
    launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
    n_tiles = train["eval_tiles"]
    expected = train.pop("scatter_expected")
    per_step = {key_label(name, over): scatter_per_step(name) for name, over in REG_KEYS}
    assert launches["scatter_add_rows"] == expected, f"scatter {launches}, expected {expected}"
    assert serve_topk == sum(r["requests"] for r in serve.values()), serve_topk
    assert launches["masked_topk"] == serve_topk + train["evaluations"] * n_tiles, launches
    launched = {kernel: sorted(part) for kernel, part in shapes.items()}
    assert set(shapes["scatter_add_rows"]) <= scatter_held, set(shapes["scatter_add_rows"]) - scatter_held
    assert set(shapes["masked_topk"]) <= topk_held, set(shapes["masked_topk"]) - topk_held
    log(f"registry-20k: scatter launches {launches['scatter_add_rows']} ({per_step} per step over "
        f"{train['steps']} steps), masked_topk launches {launches['masked_topk']} ({serve_topk} serving, one a "
        f"request; {n_tiles} tiles per evaluation); launch shapes, each checked in phase 3: {launched}")

    # checks: every evaluation against the plain top-k, REG_STEPS_VS_CPU steps
    # of each key against the CPU
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    blocks = {}
    for label, tr in trainers.items():
        train[label]["eval_vs_plain"] = eval_kernel_vs_plain(tr)
        blocks[label] = _block(tr, gen, REG_STEPS_VS_CPU)
        cfg = tr.config.replace(compute_dtype="float32") if tr.config.model in REG_FLOAT32_VS_CPU else tr.config
        train[label]["card_vs_cpu"] = card_vs_cpu_epoch(
            ds, fs, cfg, params_to_numpy(tr.model), *blocks[label], dev,
            f"registry-20k {label} card vs CPU ({cfg.compute_dtype} SpMM operands)")

    # numbers: each key's refresh and step, and the scatter at the
    # id-embedding keys' tree gathers (node width 64)
    for label, rec in recs.items():
        serve[label].pop("users_512")
        serve[label]["refresh_ms"] = host_ms(lambda: rec.refresh(None), reps=10)
        serve[label]["refresh_profile"] = device_profile(lambda: rec.refresh(None), n=5)
        log(f"serve-registry-20k {label}: refresh {serve[label]['refresh_ms']:.3f} ms on the host, "
            f"{(serve[label]['refresh_profile'] or {}).get('device_ms')} ms on the device")
    numbers = {label: cadence_numbers(tr, f"registry-20k {label}", profile_steps=ATT_PROFILE_STEPS,
                                      epoch_s=train[label]["epoch_s"][-1])
               for label, tr in trainers.items()}
    first_id = REG_ID_KEYS[0]
    gathers = step_gathers(trainers[first_id], blocks[first_id][0][0], blocks[first_id][1][0])
    assert [(n, d, ids.numel()) for n, d, ids in gathers] == [(n, d, r) for n, r, d in REG_SCATTER_SHAPES[:2]], \
        [(n, d, ids.numel()) for n, d, ids in gathers]
    shapes_64 = scatter_numbers_at([(n, ids) for n, _, ids in gathers], dev, 2 * TS_D, rows_seed=SEED + 22)
    del trainers, recs
    phase_s = time.perf_counter() - t0
    log(f"registry-20k: {phase_s:.0f} s")
    return {"serve": serve, "train": train, "numbers": numbers, "scatter_per_step": per_step,
            "launch_shapes": launched, "scatter_shapes": shapes_64, "launches": launches, "phase_s": phase_s}


def _tools(argv) -> tuple:
    """``tools.main(argv)`` with its stdout captured (and echoed); (result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = ttools.main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.startswith(("  ", "{", "}")):  # the metrics' JSON is in the numbers line
            log(f"  | {line}")
    return out, text


def masked_values(U, I, users, ids, mask) -> torch.Tensor:
    """The scores of ``ids`` [B, K] as masked_topk scores them: <U[u], I[j]>,
    or -1024 where j is a train positive of u."""
    ids = ids.long()
    s = (U[users.long()][:, None, :] * I[ids]).sum(-1)
    csr = CSR(*mask)
    deg = csr.degrees()[users.long()]
    pos, valid = csr_gather_padded(csr, users, max(1, int(deg.max())))
    hit = ((ids[:, :, None] == pos[:, None, :].long()) & valid[:, None, :]).any(-1)
    return torch.where(hit, torch.full_like(s, float(st.MASK_SENTINEL)), s)


def _csv_rows(path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@contextlib.contextmanager
def record_propagations(part: dict, *classes):
    """Within, each ``propagate`` of the given model classes keeps its
    embeddings (float32) under the name of the part it ran in,
    {part["name"]: (U, I)} (the part's last propagation). Phases 16 and 17
    hold the tools', the dumps' and the evaluations' top-k against the plain
    top-k on the embeddings they scored: a propagation does not repeat
    itself bit for bit on the card (the atomics of the sparse products and
    of index_add_), and under bfloat16 operands a last-bit change can round
    a layer's input to the next bfloat16 value."""
    kept = {}
    originals = {cls: cls.__dict__["propagate"] for cls in classes}
    for cls, fn in originals.items():
        def keep(self, *a, _fn=fn, **k):
            out = _fn(self, *a, **k)
            kept[part["name"]] = tuple(t.detach().float().contiguous() for t in out)
            return out

        cls.propagate = keep
    try:
        yield kept
    finally:
        for cls, fn in originals.items():
            cls.propagate = fn


def _csv_ids(rows) -> np.ndarray:
    return np.asarray([[int(x) for x in r["predict_ids"].split(",")] for r in rows], dtype=np.int64)


def production_20k(ds, fs, dev, ckpt, root, smi) -> dict:
    """Phase 16: the production tier on phase 12's graph and features, from
    the R = 8 trainer's checkpoint (Trainer.save after its 6 epochs): the data
    directory in the reference's layout, then tools evaluate / infer /
    recommend as a user calls them, each with the launch counts set to 0
    just before it and read just after; then their checks and numbers."""
    t_phase = time.perf_counter()
    data_dir = os.path.join(root, "data")
    t0 = time.perf_counter()
    write_text_dataset(ds, data_dir)  # cf/train.txt, test.txt, inference.txt (train + test)
    write_reference_features(fs, data_dir)
    write_s = time.perf_counter() - t0
    cfg = a20_config(data_path=data_dir)
    back = load_text_dataset(cfg)
    for f in ("train_user", "train_item", "test_user", "test_item"):
        assert np.array_equal(getattr(back, f), getattr(ds, f)), f"{f} read back otherwise"
    assert (back.n_users, back.m_items) == (ds.n_users, ds.m_items)
    for f in ("indptr", "indices"):
        assert torch.equal(getattr(back.graph.user_pos, f), getattr(ds.graph.user_pos, f).cpu()), f
    assert back.has_inference_edges and len(back.inference_user) == ds.train_size + ds.test_size
    every = load_reference_features(cfg.replace(user_feature="nctwb", item_feature="nctwsb"), data_dir,
                                    dataset=back)
    for side in ("user", "item"):
        a, b = getattr(every, side), getattr(fs, side)
        for f in ("numeric", "categorical", "word2vec", "bert") + (("sentence",) if side == "item" else ()):
            assert torch.equal(getattr(a, f), getattr(b, f)), f"{side} {f} read back otherwise"
        w = b.text.shape[-1]  # read back as rows of 64 distinct words
        assert torch.equal(a.text[..., :w], b.text) and bool((a.text[..., w:] == -1).all()), f"{side} text"
    assert every.text_vocab == fs.text_vocab
    log(f"production-20k data: {ds.n_users} users, {ds.m_items} items, {ds.train_size} train and "
        f"{len(back.inference_user)} inference edges written and read back equal, features bit-equal "
        f"({write_s:.1f} s to write)")
    out_dir = os.path.join(root, "result")
    common = ["--ckpt", ckpt, "--data_path", data_dir, "--device", dev.type]
    facts = {"data_write_s": write_s, "inference_edges": len(back.inference_user)}

    # the path: evaluate, infer (inside a profiler trace), recommend; the
    # embeddings each call scored are kept for its checks
    eval_csv = os.path.join(root, "evaluate.csv")
    part = {"name": "evaluate"}
    with record_propagations(part, sage.SAGE) as kept:
        st.launches = st.wide_launches = sc.launches = 0
        ev, _ = _tools(["evaluate", *common, "--save_result", eval_csv])
        launches = {"evaluate": st.launches}
        trace_dir = os.path.join(root, "trace")
        infer = {}
        with trace(trace_dir):
            for tag, targets, k in (("k20", "0,9,25", PROD_K), ("k200", "19", ATT_K)):
                part["name"] = f"infer_{tag}"
                st.launches = 0
                res, text = _tools(["infer", *common, "--out_dir", out_dir, "--user_batch", str(PROD_BATCH),
                                    "--target_batches", targets, "--k", str(k)])
                launches[f"infer_{tag}"] = st.launches
                infer[tag] = {"k": k, "targets": targets, "paths": [str(p) for p in res["paths"]],
                              "seconds": res["seconds"], "stdout": text}
        part["name"] = "recommend"
        st.launches = 0
        rec_out, _ = _tools(["recommend", *common, "--users", ",".join(map(str, PROD_USERS)),
                             "--k", str(PROD_REC_K)])
        launches["recommend"] = st.launches
    launches["scatter_add_rows"] = sc.launches
    launches["masked_topk_wide"] = st.wide_launches  # the whole path's: the k = 200 batch's
    assert sc.launches == 0, f"the production tier launched the scatter kernel {sc.launches} times"
    mem = MetricLogger(jsonl_path=os.path.join(root, "memory.jsonl"), quiet=True)
    memory = log_device_memory(mem, prefix="mem/production")
    mem.close()

    # evaluate: against the restored trainer's own evaluation of the same parameters
    tr = cadence_trainer(ds, fs, dev, relin_every=CADENCE_BLOCK)
    tr.restore(ckpt)
    n_tiles = int(tr.eval_data.users.shape[0])
    assert launches["evaluate"] == n_tiles, f"evaluate: {launches['evaluate']} launches for {n_tiles} tiles"
    results_tr, shown_tr = tr.evaluator(tr.eval_data)
    kmax = max(tr.config.topks)
    U, I = kept["evaluate"]
    mask = (tr.graph.user_pos.indptr, tr.graph.user_pos.indices)
    valid = tr.eval_data.valid.reshape(-1)
    users = tr.eval_data.users.reshape(-1)[valid]
    topk = torch.from_numpy(np.asarray(ev["topk"])).to(dev)
    assert topk.shape == (len(users), kmax), topk.shape
    rv, ri = st.masked_topk_reference(U, I, users, kmax, *mask)
    max_err = compare(masked_values(U, I, users, topk, mask), topk, rv, ri, exact=False)
    moved = int((topk.cpu().numpy() != shown_tr).sum())
    if moved == 0:
        assert ev["results"] == results_tr, (ev["results"], results_tr)
    else:  # ids swapped only inside near-ties (checked above)
        for key, v in results_tr.items():
            np.testing.assert_allclose(ev["results"][key], v, rtol=1e-3, err_msg=key)
    rows = _csv_rows(eval_csv)
    k0 = tr.config.topks[0]
    assert len(rows) == len(users) == len(np.unique(ds.test_user))
    assert np.array_equal(_csv_ids(rows), np.asarray(ev["topk"])[:, :k0]), "the CSV's ids are not the evaluation's"
    log(f"production-20k evaluate: {n_tiles} masked_topk launches; metrics "
        + ("equal to" if moved == 0 else f"within 1e-3 of ({moved} ids in near-ties placed otherwise)")
        + f" the restored trainer's evaluation (recall@10 {ev['results']['recall@10']:.4f}); ids equal to the "
        f"plain version's where their neighbours differ (max abs err {max_err:.3g}); {len(rows)} CSV rows")

    # infer: each CSV against the plain top-k over the inference edges' propagation
    rec_inf = Recommender.from_checkpoint(ckpt, data_path=data_dir, use_inference_edges=True, device=dev)
    U_inf, I_inf = rec_inf._user_emb, rec_inf._item_emb
    mask = (rec_inf._mask.indptr, rec_inf._mask.indices)
    rec_tr = Recommender(rec_inf.model, back, rec_inf.config, None, use_inference_edges=False, device=dev)
    pos = ds.all_pos()
    assert launches["infer_k20"] == 2 and launches["infer_k200"] == 1, launches
    assert launches["masked_topk_wide"] == 1, launches
    skip = f"[infer] batch 25 out of range (n_users={ds.n_users}); skipped"
    assert skip in infer["k20"]["stdout"], infer["k20"]["stdout"]
    differs = 0
    for tag, got in infer.items():
        k = got["k"]
        names = [os.path.basename(p) for p in got["paths"]]
        want = [f"textsage_{TS_D}_2_{b}_inference.csv" for b in got["targets"].split(",")
                if int(b) * PROD_BATCH < ds.n_users]
        assert names == want, names
        for p in got["paths"]:
            b = int(os.path.basename(p).split("_")[3])
            bu = torch.arange(b * PROD_BATCH, (b + 1) * PROD_BATCH, device=dev)
            ids = _csv_ids(_csv_rows(p))
            assert ids.shape == (PROD_BATCH, k), ids.shape
            ki = torch.from_numpy(ids).to(dev)
            tU, tI = kept[f"infer_{tag}"]
            rv, ri = st.masked_topk_reference(tU, tI, bu, k, *mask)
            max_err = max(max_err, compare(masked_values(tU, tI, bu, ki, mask), ki, rv, ri, exact=False))
            for u, row in zip(bu.tolist(), ids):
                assert not set(row.tolist()) & set(pos[u].tolist()), f"user {u}: a train positive predicted"
            if tag == "k20" and b == 0:
                train_only, _ = rec_tr.recommend(bu.cpu().numpy(), k=k)
                differs = int((train_only != ids).any(axis=1).sum())
                assert differs > 0, "the inference edges changed no user's top 20"
    text = "".join(open(f).read() for f in glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))
    assert text and any(name in text for name in TOPK_KERNEL_NAMES), "the trace names no top-k kernel"
    assert 0 < memory["mib_in_use"] <= memory["peak_mib_in_use"] <= memory["mib_limit"], memory
    assert memory["mib_limit"] > 70_000, memory
    with open(os.path.join(root, "memory.jsonl")) as f:
        assert set(json.loads(f.readline())) == {"ts", *(f"mem/production/{k}" for k in memory)}
    log(f"production-20k infer: masked_topk launches {launches['infer_k20']} + {launches['infer_k200']} "
        f"(k = {PROD_K}: batches 0 and 9, 25 skipped; k = {ATT_K}: batch 19 in one radix-select launch); every CSV "
        f"equal to the plain top-k over the inference edges' propagation, no train positive predicted; "
        f"{differs} of batch 0's {PROD_BATCH} users' top {PROD_K} differ over the train edges alone; the trace "
        f"names the kernel ({len(text)} bytes); memory {memory['mib_in_use']:.0f} MiB in use, "
        f"{memory['peak_mib_in_use']:.0f} at the peak, {memory['mib_limit']:.0f} on the card")

    # recommend: each answer against the plain top-k for that user
    assert launches["recommend"] == 1, launches
    ru = torch.tensor(PROD_USERS, device=dev)
    rv, ri = st.masked_topk_reference(*kept["recommend"], ru, PROD_REC_K, *mask)
    max_err = max(max_err, compare(torch.from_numpy(rec_out["scores"]), torch.from_numpy(rec_out["ids"]),
                                   rv, ri, exact=False))
    for line, u, row in zip(rec_out["lines"], PROD_USERS, rec_out["ids"]):
        r = json.loads(line)
        assert r["user"] == u and r["items"] == row.tolist(), line
    log(f"production-20k recommend: {len(PROD_USERS)} users in 1 launch, answers equal to the plain version "
        f"(max abs err over the phase {max_err:.3g})")

    # numbers: the masked top-k at the infer calls' batch of 1000 users
    bu = torch.arange(0, PROD_BATCH, device=dev)
    numbers = {f"k{k}": topk_numbers(U_inf, I_inf, bu, k, mask, CSR(*mask), dev) for k in (PROD_K, ATT_K)}
    # a call's device operations: pass 1 and the merge; at k = 200 the radix
    # passes, the sort and the fill that zeroes the select's state
    for k, want in ((PROD_K, 2), (ATT_K, sum(st.wide_kernels(I_inf.shape[0]).values()) + 1)):
        got = numbers[f"k{k}"]["kernel_profile"]["device_ops_per_call"]
        assert got == want, f"the k = {k} profile recorded {got} device operations a call, want {want}"
    for tag, t in numbers.items():
        prof = t["kernel_profile"]
        log(f"masked_topk B={PROD_BATCH} {tag}: {t['ms']:.4f} ms (device {prof['device_ms']:.4f} in "
            f"{prof['device_ops_per_call']:g} operations a call, profile {prof['attempts']} of 3, "
            f"{prof['pad_kept']} of the pad's {PROFILE_PAD + 1} records kept; plain "
            f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound {t['bound_ms']:.5f} by {t['bound_by']})")
    del tr, rec_inf, rec_tr
    facts.update(
        card=smi, launches=launches, max_abs_err=max_err, ids_moved_in_ties=moved,
        evaluate={"seconds": ev["seconds"], "results": ev["results"], "csv_rows": len(rows)},
        infer={tag: {k: v for k, v in got.items() if k != "stdout"} for tag, got in infer.items()},
        infer_top20_differs_over_train_edges=differs,
        recommend={"seconds": rec_out["seconds"], "lines": rec_out["lines"]},
        topk=numbers, memory=memory, trace_bytes=len(text),
    )
    facts["phase_s"] = time.perf_counter() - t_phase
    log(f"production-20k: {facts['phase_s']:.0f} s")
    return facts


def _rank20k_module():
    """``tools/rank20k_torch.py``: the protocol that phase 17 drives."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "rank20k_torch.py")
    spec = importlib.util.spec_from_file_location("rank20k_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_prefix(kv, ki, rv, ri, tie_atol: float = 0.0) -> float:
    """``compare`` of k kernel columns against a plain top (k + 1): the
    plain version's next key is appended to the kernel's columns, so a k-th
    key tied with the (k + 1)-th may be either."""
    k = ki.shape[1]
    return compare(torch.cat([kv, rv[:, k:]], 1), torch.cat([ki, ri[:, k:]], 1), rv, ri, exact=False,
                   tie_atol=tie_atol)


def dump_vs_plain(U, I, mask, cand, batch) -> float:
    """A dump [N, k] against masked_topk_reference (sigmoid off) on the same
    embeddings and mask, batch by batch under rule 3(b) (``compare_prefix``),
    neighbouring values within 2 x its atol counted as ties; every row
    unique and free of train positives. Returns the max abs value error."""
    n, k = cand.shape
    err = 0.0
    for lo in range(0, n, batch):
        users = torch.arange(lo, min(lo + batch, n), device=U.device)
        ids = torch.from_numpy(cand[lo:lo + batch]).to(U.device).long()
        rv, ri = st.masked_topk_reference(U, I, users, k + 1, *mask, sigmoid=False)
        # at k = 50 a weak retriever's dump reaches scores near 0, where two
        # values within the value check's atol are ties too
        err = max(err, compare_prefix(masked_values(U, I, users, ids, mask), ids, rv, ri, tie_atol=2 * ATOL))
    srt = np.sort(cand, axis=1)
    assert (srt[:, 1:] != srt[:, :-1]).all(), "a dump row repeats an item"
    indptr, indices = (x.cpu().numpy() for x in mask)
    m = I.shape[0]
    train_keys = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr)) * m + indices
    assert not np.isin(np.arange(n, dtype=np.int64)[:, None] * m + cand, train_keys).any(), \
        "a train positive in a dump"
    return err


def ranker_card_vs_cpu(ranker, fs, groups, lr, dev) -> dict:
    """RANK_STEPS_VS_CPU Adam steps of ``ranker``'s copies on the card and on
    the CPU on the same batches, each card step from the CPU's parameters and
    moments, under phase 10's rule (losses within rtol 1e-4, every parameter
    within 2 lr, all but 1e-3 of them within 1e-6 + 1e-5 |p|); one scatter
    launch a card step."""
    cpu = NeuralRanker(fs, aux_dim=ranker.aux_dim)
    card = NeuralRanker(fs, aux_dim=ranker.aux_dim).to(dev)
    state = {k: v.detach().cpu() for k, v in ranker.state_dict().items()}
    cpu.load_state_dict(state)
    opt_cpu, opt_card = cpu.optimizer(lr), card.optimizer(lr)
    perm = torch.randperm(len(groups), generator=torch.Generator().manual_seed(SEED + 17))
    batches = epoch_batches(perm, 256)[:RANK_STEPS_VS_CPU]
    groups_cpu, groups_card = groups.to("cpu"), groups.to(dev)
    off = total = 0
    worst = 0.0
    losses = []
    for step, idx in enumerate(batches):
        params_from_jax({k: p.detach() for k, p in cpu.named_parameters()}, card)
        if step:
            adam_state_from_jax(*adam_state_to_numpy(opt_cpu, cpu), opt_card, card)
        before = sc.launches
        lc = float(card.train_step(groups_card, idx.to(dev), opt_card))
        assert sc.launches == before + 1, "a ranker step on the card did not launch the scatter once"
        lp = float(cpu.train_step(groups_cpu, idx, opt_cpu))
        np.testing.assert_allclose(lc, lp, rtol=1e-4, err_msg=f"step {step}")
        losses.append((lc, lp))
        ref = dict(cpu.named_parameters())
        for name, p in card.named_parameters():
            diff = (p.detach().cpu() - ref[name].detach()).abs()
            assert bool((diff <= 2 * lr).all()), f"step {step} {name}: {float(diff.max())}"
            off += int((diff > 1e-6 + 1e-5 * ref[name].detach().abs()).sum())
            total += diff.numel()
            worst = max(worst, float(diff.max()))
    assert off <= 1e-3 * total, f"{off} of {total} parameter values differ"
    log(f"rank-20k ranker card vs CPU ({RANK_STEPS_VS_CPU} steps, each from the CPU's state): losses "
        f"{[round(a, 6) for a, _ in losses]} / {[round(b, 6) for _, b in losses]}; parameters within 1e-6 + "
        f"1e-5 |p| but {off} of {total} (max abs diff {worst:.3g})")
    return {"losses": losses, "params_off": off, "params_total": total, "max_abs_diff": worst}


def rank_tiles_vs_one(ranker, full, dumps) -> dict:
    """rank() over the evaluation's candidate union in tiles of 2048 users
    against one tile of all of them: ids equal, or swapped only inside
    near-ties of the scores (rtol 1e-5)."""
    eval_dict = full.test_dict()
    users = np.asarray(sorted(eval_dict), np.int64)
    cand = np.concatenate([d[users].astype(np.int64) for d in dumps], axis=1)
    kept, (cand_mat,) = _compact_rows(_dedup_rows(cand, np.ones_like(cand, dtype=bool)), cand, width=160)
    u = torch.from_numpy(users.astype(np.int32))
    c = torch.from_numpy(np.where(kept, cand_mat, 0).astype(np.int32))
    mask = torch.from_numpy(np.ascontiguousarray(kept))
    tiled = ranker.rank(u, c, k=10, mask=mask, chunk=2048).cpu().numpy()
    one = ranker.rank(u, c, k=10, mask=mask, chunk=len(users)).cpu().numpy()
    rows = np.nonzero((tiled != one).any(axis=1))[0]
    if len(rows):
        sel = torch.from_numpy(rows)
        with torch.no_grad():
            s = ranker.score(u[sel, None], c[sel]).cpu().numpy()
        for r, row in enumerate(rows):
            col = {int(i): float(v) for i, v in zip(c[row].tolist(), s[r])}
            a = np.asarray([col[int(i)] for i in tiled[row] if i >= 0])
            b = np.asarray([col[int(i)] for i in one[row] if i >= 0])
            np.testing.assert_allclose(np.sort(a), np.sort(b), rtol=1e-5, err_msg=f"user {users[row]}")
    log(f"rank-20k rank(): {len(users)} users in tiles of 2048 and in one tile, ids equal but {len(rows)} "
        f"rows' near-ties")
    return {"users": len(users), "rows_in_near_ties": int(len(rows))}


def rank_dump_numbers(U, I, dev) -> dict:
    """masked_topk at the dump's shape (B 2048, M 10000, d 32, k 50, unmasked,
    sigmoid off) beside the radix select's call, its plain version, matmul +
    torch.topk, torch.topk alone over the same scores, and the bound (2 B M d
    operations)."""
    users = torch.arange(RANK_DUMP_B, device=dev)
    b, m, d, k = RANK_DUMP_B, I.shape[0], I.shape[1], RANK_K
    scores = U[users] @ I.T
    t_bytes = (4 * (m * d + b * d + b) + 12 * b * k) / HBM_BYTES_PER_S
    t_flops = 2 * b * m * d / F32_FLOP_PER_S
    out = {
        "B": b, "M": m, "d": d, "k": k, "masked": False, "sigmoid": False,
        "ms": event_ms(lambda: st.masked_topk(U, I, users, k)),
        "plain_ms": event_ms(lambda: st.masked_topk_reference(U, I, users, k)),
        "library_ms": event_ms(lambda: torch.topk(U[users] @ I.T, k)),
        "topk_only_ms": event_ms(lambda: torch.topk(scores, k)),
        "bound_ms": 1e3 * max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "kernel_profile": device_profile(lambda: st.masked_topk(U, I, users, k),
                                         per_call=dict.fromkeys(("score_segments", "merge_segments"), 1)),
        # the same call through the radix select (masked_topk takes it above
        # k = 128 only): recorded beside csrc/streaming_topk.cu's
        "wide_ms": event_ms(lambda: st.masked_topk_wide(U, I, users, k)),
        "wide_kernel_profile": device_profile(lambda: st.masked_topk_wide(U, I, users, k),
                                              per_call=st.wide_kernels(m)),
    }
    log(f"masked_topk B={b} k={k} (the dump's shape): {out['ms']:.4f} ms (device "
        f"{out['kernel_profile']['device_ms']:.4f}); the radix select {out['wide_ms']:.4f} (device "
        f"{out['wide_kernel_profile']['device_ms']:.4f}); plain {out['plain_ms']:.4f}, matmul + torch.topk "
        f"{out['library_ms']:.4f}, torch.topk alone {out['topk_only_ms']:.4f}, bound {out['bound_ms']:.5f} by "
        f"{out['bound_by']}")
    return out


def rank_20k(ds, fs, dev, root, ckpt, smi) -> dict:
    """Phase 17: the two-stage ranker on phase 12's graph and features, as
    tools/rank20k_torch.py runs it at cut epochs, with phase 16's data
    directory and checkpoint; each part with the launch counts set to 0 just
    before it and read just after; then its checks and numbers."""
    t_phase = time.perf_counter()
    r20 = _rank20k_module()
    data_dir = os.path.join(root, "data")  # phase 16's, in the reference's layout
    launches, part = {}, {"name": None}

    @contextlib.contextmanager
    def counted(name):
        part["name"] = name
        st.launches = sc.launches = 0
        yield
        launches[name] = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}

    # the path: the split, stages A and B, then the tools
    t0 = time.perf_counter()
    reduced, full, held = r20.lgbm_split(data_dir)
    split_s = time.perf_counter() - t0
    assert (reduced.train_size, len(held[0])) == (r20.REDUCED_EDGES, r20.HELD_EDGES), (
        reduced.train_size, len(held[0]))
    assert full.train_size == ds.train_size and (full.n_users, full.m_items) == (ds.n_users, ds.m_items)
    log(f"rank-20k split: {reduced.train_size} reduced and {len(held[0])} held edges, as the JAX record "
        f"({split_s:.1f} s to read)")
    rows = []
    with record_propagations(part, LightGCN, sage.SAGE) as kept:
        out = r20.run(reduced, full, held, fs, RANK_RETRIEVER_EPOCHS, RANK_RANKER_EPOCHS, dev, seed=SEED,
                      emit=lambda **row: rows.append(row), part=counted)
    tool_dir = os.path.join(root, "rank")
    os.makedirs(tool_dir, exist_ok=True)
    cand_path, ranker_path = os.path.join(tool_dir, "candidates_textsage.npy"), os.path.join(tool_dir, "ranker.ckpt")
    common = ["--data_path", data_dir, "--device", dev.type]
    tools = {}
    for name, argv in (("tool_dump", ["dump-candidates", "--ckpt", ckpt, "--out", cand_path]),
                       ("tool_train_ranker", ["train-ranker", "--candidates", cand_path, "--epochs", "1",
                                              "--out", ranker_path]),
                       ("tool_rerank_eval", ["rerank-eval", "--candidates", cand_path, "--ranker", ranker_path])):
        with counted(name):
            tools[name], _ = _tools([*argv, *common])

    # checks: the launches of each part
    n_tiles = -(-full.n_users // RANK_DUMP_B)
    per_step = {"lgn": 4, "textsage": 2}
    for (name, stage), tr in out["trainers"].items():
        want = {"masked_topk": 0, "scatter_add_rows": per_step[name] * tr.num_batches * RANK_RETRIEVER_EPOCHS}
        assert launches[f"train_{name}_{stage}"] == want, (name, stage, launches[f"train_{name}_{stage}"], want)
        assert launches[f"dump_{name}_{stage}"] == {"masked_topk": n_tiles, "scatter_add_rows": 0}, (
            name, stage, launches[f"dump_{name}_{stage}"])
    for name in r20.RETRIEVERS:
        eval_tiles = int(out["trainers"][(name, "B")].eval_data.users.shape[0])
        assert launches[f"evaluate_{name}"] == {"masked_topk": eval_tiles, "scatter_add_rows": 0}
    g_fit = int((out["groups_aux"].users % r20.VAL_EVERY != 0).sum())
    steps = {"ref": RANK_RANKER_EPOCHS * max(len(out["groups"]) // 256, 1),
             "aux": RANK_RANKER_EPOCHS * max(g_fit // 256, 1)}
    for tag, n in steps.items():  # one a joint step; the warm steps take wa's gradient alone
        assert launches[f"fit_{tag}"] == {"masked_topk": 0, "scatter_add_rows": n}, (tag, launches[f"fit_{tag}"], n)
    for name in ("groups", "groups_aux", "rerank", "rerank_aux", "calibrate", "rerank_stack", "tool_rerank_eval"):
        assert launches[name] == {"masked_topk": 0, "scatter_add_rows": 0}, (name, launches[name])
    assert launches["tool_dump"] == {"masked_topk": -(-full.n_users // RANK_TOOL_B), "scatter_add_rows": 0}
    tool_steps = max(tools["tool_train_ranker"]["groups"] // 256, 1)
    assert launches["tool_train_ranker"] == {"masked_topk": 0, "scatter_add_rows": tool_steps}
    log(f"rank-20k: masked_topk launches {n_tiles} a dump (4 dumps), {eval_tiles} an evaluation, "
        f"{launches['tool_dump']['masked_topk']} for tools dump-candidates at its batch of {RANK_TOOL_B}; "
        f"scatter_add_rows once a ranker step: {steps['ref']} (parity), {steps['aux']} (aux, after its warm "
        f"epochs), {tool_steps} (tools train-ranker)")

    # checks: every dump against the plain top-k, first 10 columns against the evaluation
    max_err, moved, repeat = 0.0, {}, {}
    for (name, stage), tr in out["trainers"].items():
        U, I = kept[f"dump_{name}_{stage}"]
        mask = (tr.graph.user_pos.indptr, tr.graph.user_pos.indices)
        cand = out["dumps"][(name, stage)]
        assert cand.shape == (full.n_users, RANK_K) and cand.dtype == np.int32
        max_err = max(max_err, dump_vs_plain(U, I, mask, cand, RANK_DUMP_B))
        if stage == "B":
            results, topk = out["trainer_eval"][name]
            valid = tr.eval_data.valid.reshape(-1)
            users = tr.eval_data.users.reshape(-1)[valid]
            ids = torch.from_numpy(cand[users.cpu().numpy(), :10]).to(dev).long()
            shown = torch.from_numpy(np.asarray(topk)[:, :10]).to(dev).long()
            eU, eI = kept[f"evaluate_{name}"]
            repeat[name] = {"elements_differ": int((eU != U).sum() + (eI != I).sum()),
                            "max_abs_diff": float(max((eU - U).abs().max(), (eI - I).abs().max()))}
            rv, ri = st.masked_topk_reference(eU, eI, users, 11, *mask)
            compare_prefix(masked_values(eU, eI, users, shown, mask), shown, rv, ri)
            moved[name] = int((shown != ids).sum())
            alone = out["alone"][name]["recall@10"]
            if moved[name] == 0:
                assert abs(alone - results["recall@10"]) <= 1e-6, (name, alone, results["recall@10"])
            else:  # ids swapped only inside near-ties (checked above)
                np.testing.assert_allclose(alone, results["recall@10"], rtol=1e-3, err_msg=name)
            if name == "textsage":
                numbers_U, numbers_I = U, I
    rec = Recommender.from_checkpoint(ckpt, data_path=data_dir, use_inference_edges=False, device=dev)
    tool_cand = np.load(cand_path)
    max_err = max(max_err, dump_vs_plain(rec._user_emb, rec._item_emb, (rec._mask.indptr, rec._mask.indices),
                                         tool_cand, RANK_TOOL_B))
    assert np.array_equal(tool_cand, tools["tool_dump"]["candidates"])
    log(f"rank-20k dumps: 5 dumps of {full.n_users} x {RANK_K} equal to the plain top-k under rule 3(b) (max abs "
        f"err {max_err:.3g}), rows unique, no train positive; the first 10 columns equal to the trainer's "
        f"evaluation but {moved} ids in near-ties (recall@10 lgn {out['alone']['lgn']['recall@10']:.5f}, "
        f"textsage {out['alone']['textsage']['recall@10']:.5f}); one model's propagation twice (the dump's, the "
        f"evaluation's): {repeat}")

    # checks: the parity fit lowers the loss; the card against the CPU; tiles
    sub = out["groups"].select(torch.arange(min(2048, len(out["groups"])))).to(dev)
    fresh = NeuralRanker(fs).to(dev)
    fresh.init_parameters(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        loss_init, loss_fit = float(fresh.group_loss(sub)), float(out["ranker_ref"].group_loss(sub))
    assert loss_fit < loss_init, (loss_init, loss_fit)
    losses = out["losses_ref"]
    log(f"rank-20k parity fit: {len(out['groups'])} groups of width {out['groups'].items.shape[1]}, {steps['ref']} "
        f"steps; loss on 2048 groups {loss_init:.5f} at init -> {loss_fit:.5f}; epoch means {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}")
    vs_cpu = ranker_card_vs_cpu(out["ranker_ref"], fs, out["groups"], r20.RANKER["lr"], dev)
    tiles = rank_tiles_vs_one(out["ranker_ref"], full, [out["dumps"][(n, "B")] for n in r20.RETRIEVERS])

    # checks: the re-rank quality
    rr = out["rerank"]
    best = max(out["alone"][n]["recall@10"] for n in r20.RETRIEVERS)
    stack = rr["stack"]["rerank_recall@10"]
    assert stack > rr["ref"]["rerank_recall@10"], (stack, rr["ref"])
    assert stack >= RANK_STACK_OF_BEST * best, (stack, best)
    assert all(0.0 <= v <= 1.0 for v in tools["tool_rerank_eval"]["results"].values())
    beta, gamma, val_r = out["calibration"]
    log(f"rank-20k recall@10: lgn alone {out['alone']['lgn']['recall@10']:.5f}, textsage alone "
        f"{out['alone']['textsage']['recall@10']:.5f}, parity rerank {rr['ref']['rerank_recall@10']:.5f}, aux "
        f"rerank {rr['aux']['rerank_recall@10']:.5f}, stack {stack:.5f} (beta {beta}, gamma {gamma}, val recall "
        f"{val_r:.5f}; at least {RANK_STACK_OF_BEST} x the best alone and above parity); tools rerank-eval "
        f"{tools['tool_rerank_eval']['results']['rerank_recall@10']:.5f} (JAX record, TPU, 30 / 40 epochs: "
        f"0.09768, 0.21118, 0.19903, 0.16702, 0.22985)")

    # numbers: the dump's top-k, a real ranker step's scatter, rank()
    dump_topk = rank_dump_numbers(numbers_U, numbers_I, dev)
    step_ranker = NeuralRanker(fs).to(dev)
    step_ranker.load_state_dict(out["ranker_ref"].state_dict())
    opt = step_ranker.optimizer(r20.RANKER["lr"])
    gidx = torch.arange(256, device=dev)
    groups_dev = out["groups"].to(dev)
    (gather,) = recorded_gathers(lambda: step_ranker.train_step(groups_dev, gidx, opt))
    n, d, ids = gather
    assert (n, d) == (RANK_VOCAB, RANK_EMB) and ids.numel() == 256 * out["groups"].items.shape[1] * 9, gather[:2]
    (scatter,) = scatter_numbers_at([(n, ids)], dev, d, rows_seed=SEED + 18)
    lat_users = torch.arange(RANK_LATENCY_USERS, device=dev, dtype=torch.int32)
    lat_cand = torch.from_numpy(np.concatenate(
        [out["dumps"][(nm, "B")][:RANK_LATENCY_USERS] for nm in r20.RETRIEVERS], axis=1)).to(dev)
    assert lat_cand.shape[1] == RANK_LATENCY_WIDTH
    lat_mask = torch.ones_like(lat_cand, dtype=torch.bool)

    def rank_call():
        return out["ranker_ref"].rank(lat_users, lat_cand, k=10, mask=lat_mask)

    rank_prof = device_profile(rank_call, n=10)
    rank_numbers = {"users": RANK_LATENCY_USERS, "cand_width": RANK_LATENCY_WIDTH, "host_ms": host_ms(rank_call),
                    "device_ms": rank_prof["device_ms"] if rank_prof else None, "profile": rank_prof}
    if rank_prof:
        rank_numbers["users_per_s_device"] = RANK_LATENCY_USERS / (rank_prof["device_ms"] / 1e3)
    rank_numbers["users_per_s_host"] = RANK_LATENCY_USERS / (rank_numbers["host_ms"] / 1e3)
    log(f"rank-20k rank(): {RANK_LATENCY_USERS} users x {RANK_LATENCY_WIDTH} candidates {rank_numbers['host_ms']:.3f} "
        f"ms on the host, device {rank_numbers['device_ms']} ms")
    secs = out["seconds"]
    fits = {tag: {"groups": g, "epochs": RANK_RANKER_EPOCHS, "fit_s": secs[f"fit_{tag}"],
                  "groups_per_s": g * RANK_RANKER_EPOCHS / secs[f"fit_{tag}"],
                  "s_per_epoch": secs[f"fit_{tag}"] / (RANK_RANKER_EPOCHS + (r20.WARM_EPOCHS if tag == "aux" else 0))}
            for tag, g in (("ref", len(out["groups"])), ("aux", g_fit))}
    facts = {
        "card": smi, "retriever_epochs": RANK_RETRIEVER_EPOCHS, "ranker_epochs": RANK_RANKER_EPOCHS,
        "split": {"reduced_edges": reduced.train_size, "held_edges": len(held[0]), "read_s": split_s},
        "groups": {"n": len(out["groups"]), "width": int(out["groups"].items.shape[1]),
                   "n_aux": len(out["groups_aux"]), "n_aux_fit": g_fit},
        "launches": launches, "seconds": secs, "fits": fits, "rows": rows,
        "alone": out["alone"], "trainer_recall@10": {n: out["trainer_eval"][n][0]["recall@10"]
                                                      for n in r20.RETRIEVERS},
        "rerank": rr, "calibration": {"beta": beta, "gamma": gamma, "val_recall": val_r},
        "wa": [float(x) for x in out["ranker_aux"].wa.detach().cpu()],
        "loss_init_fit": [loss_init, loss_fit], "card_vs_cpu": vs_cpu, "tiles": tiles,
        "dump_max_abs_err": max_err, "ids_moved_in_ties": moved, "propagation_twice": repeat,
        "tools": {k: {"seconds": v["seconds"]} for k, v in tools.items()},
        "tool_rerank_eval": tools["tool_rerank_eval"]["results"],
        "dump_topk": dump_topk, "ranker_scatter": scatter, "rank": rank_numbers,
    }
    facts["phase_s"] = time.perf_counter() - t_phase
    log(f"rank-20k: {facts['phase_s']:.0f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    return facts


def _files(root) -> dict:
    """{path under root: bytes} of every file below ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def preprocess_20k(dev, smi, lgn_edges) -> dict:
    """Phase 18: raw tables -> tools preprocess (twice, byte-equal) -> the
    artifact directory read back -> tools convert-recbole -> the flagship
    recipe trained on the directory through both kernels; then the host
    seconds of each stage and of cuckoo_build."""
    t_phase = time.perf_counter()
    facts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        raw = synthetic_raw_tables(seed=SEED)
        paths = raw.write_csv(os.path.join(tmp, "raw"))
        facts["tables_s"] = time.perf_counter() - t0
        facts["rows"] = {name: len(next(iter(cols.values()))) for name, cols in raw.tables.items()}
        assert raw.n_unique_products == PRE_UNIQUE
        runs = []
        for name in ("a", "b"):
            out, _ = _tools(["preprocess", "--products", paths["products"], "--customers", paths["customers"],
                             "--transactions", paths["transactions"], "--product_category", paths["category"],
                             "--partner", paths["partner"], "--reviews", paths["reviews"],
                             "--out", os.path.join(tmp, name), "--incremental_frac", "0.1",
                             "--test_holdout", "1"])
            runs.append(out)
        summary = runs[0]["summary"]
        assert runs[1]["summary"] == {**summary, "out_dir": os.path.join(tmp, "b")}
        files = [_files(os.path.join(tmp, name)) for name in ("a", "b")]
        assert sorted(files[0]) == sorted(files[1]) and all(files[0][k] == files[1][k] for k in files[0]), [
            k for k in files[0] if files[0][k] != files[1].get(k)]
        assert summary["n_product"] == PRE_UNIQUE, (summary["n_product"], PRE_UNIQUE)
        log(f"preprocess-20k: {facts['rows']} rows -> {summary['n_product']} products (the planted count), "
            f"{summary['n_customer']} customers, {summary['n_transaction']} transactions, vocabulary "
            f"{summary['text_vocab']}; two runs byte-equal over {len(files[0])} files "
            f"({sum(len(v) for v in files[0].values()) / 2**20:.1f} MiB)")

        # the directory read back
        data = os.path.join(tmp, "a")
        cfg = a20_config(data_path=data, **PRE_FEATURES)
        t0 = time.perf_counter()
        ds = load_text_dataset(cfg)
        fs = load_reference_features(cfg, data)
        facts["load_s"] = time.perf_counter() - t0
        assert (ds.n_users, ds.m_items) == (summary["n_customer"], summary["n_product"])
        assert list(fs.user.categorical.shape) == summary["user_categorical_shape"]
        assert list(fs.item.categorical.shape) == summary["item_categorical_shape"]
        assert fs.item.text.shape[:2] == (summary["n_product"], 4) and fs.user.text.shape[:2] == (
            summary["n_customer"], 3)
        assert fs.item.sentence.shape == (summary["n_product"], 768)
        assert fs.user.numeric.shape[0] == summary["n_customer"] and fs.item.numeric.shape[0] == summary["n_product"]
        shapes = {f"{side}_{k}": list(getattr(getattr(fs, side), k).shape) for side in ("user", "item")
                  for k in ("numeric", "categorical", "text") + (("sentence",) if side == "item" else ())}
        log(f"preprocess-20k read back: {ds.train_size} train edges; features {shapes} "
            f"({facts['load_s']:.1f} s)")

        # the RecBole export of the raw transactions, 5-core to its fixpoint
        rb = os.path.join(tmp, "recbole")
        out, _ = _tools(["convert-recbole", "--interactions", paths["transactions"], "--user_col", "customer_id",
                         "--item_col", "product_id", "--k_core", str(PRE_RECBOLE_K), "--iterate", "--out", rb])
        inter = read_recbole(os.path.join(rb, "furusato.inter"))
        assert len(inter) == out["rows"] > 0
        least = {}
        for col in ("user_id", "item_id"):
            _, counts = np.unique(inter[col].astype(str), return_counts=True)
            least[col] = int(counts.min())
            assert least[col] >= PRE_RECBOLE_K, (col, least[col])
        facts["recbole"] = {"rows": len(inter), "least_rows": least, "seconds": out["seconds"]}

        # the flagship recipe on the directory
        st.launches = sc.launches = 0
        model = build_model("textsage", cfg, ds.graph, features=fs, generator=torch.Generator().manual_seed(SEED))
        trainer = Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=True, device=dev)
        trainer.init_state()
        n_tiles = int(trainer.eval_data.users.shape[0])
        before = trainer.test()
        runs_ep = [_timed_epoch(trainer) for _ in range(PRE_EPOCHS)]
        after = trainer.test()
        launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
        steps = PRE_EPOCHS * trainer.num_batches
        # a step: one tree gather a side, and a categorical gather a side (features c)
        per_step = 2 + sum("c" in cfg_f for cfg_f in (cfg.user_feature, cfg.item_feature))
        assert launches["scatter_add_rows"] == per_step * steps, (launches, per_step, steps)
        assert launches["masked_topk"] == 2 * n_tiles, (launches, n_tiles)
        losses = [m for _, m, _ in runs_ep]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert after["recall@10"] > before["recall@10"], (before, after)
        log(f"preprocess-20k train: {PRE_EPOCHS} epochs of {trainer.num_batches} steps, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, recall@10 {before['recall@10']:.4f} -> {after['recall@10']:.4f}; scatter "
            f"launches {launches['scatter_add_rows']} ({per_step} per step over {steps} steps), masked_topk "
            f"launches {launches['masked_topk']} ({n_tiles} tiles per evaluation)")
        facts.update(
            launches=launches, scatter_per_step=per_step, steps=steps, eval_tiles=n_tiles,
            epoch_s=[e for e, _, _ in runs_ep], loss=losses,
            recall={"before": before, "after": after}, features=shapes, summary=summary,
        )
        facts["eval_vs_plain"] = eval_kernel_vs_plain(trainer)
        gen = torch.Generator(device=dev).manual_seed(SEED + 18)
        batches, draws = _block(trainer, gen, PRE_STEPS_VS_CPU)
        facts["card_vs_cpu"] = card_vs_cpu_epoch(ds, fs, cfg, params_to_numpy(trainer.model), batches, draws,
                                                 dev, "preprocess-20k card vs CPU")
        del trainer, model

        # cuckoo_build on the host: this phase's train edges and phase 6's
        cuckoo = {}
        for name, (u, v) in (("preprocess_20k", (ds.train_user, ds.train_item)), ("lgn_50k", lgn_edges)):
            t0 = time.perf_counter()
            cs = build_cuckoo_set(u, v)
            cuckoo[name] = {"edges": int(len(u)), "seconds": time.perf_counter() - t0,
                            "table_slots": int(cs.mask + 1)}
        facts["cuckoo_build"] = cuckoo
    facts["seconds"] = {"tables": facts["tables_s"], **{f"run{i + 1}": r["seconds"] for i, r in enumerate(runs)}}
    facts["smi"] = smi
    facts["phase_s"] = time.perf_counter() - t_phase
    stage = ", ".join(f"{k} {runs[0]['seconds'][k]:.2f}" for k in PRE_STAGES)
    log(f"preprocess-20k host s (run 1): {stage}; cuckoo_build "
        + ", ".join(f"{k} {v['edges']} edges {v['seconds']:.3f} s" for k, v in cuckoo.items())
        + f"; phase {facts['phase_s']:.0f} s")
    return facts


# ---- phase 19: mesh-20k ----

def mesh_config(kind: str, data_dir: str, mesh=(1, 1)) -> Config:
    """A config of phase 19 (MESH_CASES) on phase 16's data directory: the
    flagship recipe with the case's fields and float32 SpMM operands
    (bfloat16 rounds each data rank's cotangent apart: see MESH_DTYPE)."""
    return a20_config(data_path=data_dir, compute_dtype=MESH_DTYPE, mesh=MeshConfig(*mesh),
                      **MESH_CASES[kind]["over"])


def mesh_trainer(kind: str, data_dir: str, dev, mesh=(1, 1)) -> Trainer:
    """The Trainer of one of phase 19's configs, as a user builds it from the
    data directory (one process, or one rank of a mesh). asage derives its
    attribute graphs from the categorical columns, read beside its flags."""
    cfg = mesh_config(kind, data_dir, mesh)
    ds = load_text_dataset(cfg)
    kw = dict(MESH_CASES[kind]["model_kw"])
    if cfg.model != "lgn":
        read = cfg
        if cfg.model == "asage":
            read = cfg.replace(user_feature=cfg.user_feature + "c", item_feature=cfg.item_feature + "c")
        kw["features"] = load_reference_features(read, data_dir, dataset=ds)
    model = build_model(cfg.model, cfg, ds.graph, generator=torch.Generator().manual_seed(SEED), **kw)
    return Trainer(cfg, ds, model, logger=MetricLogger(quiet=True), ddp_recipe=True, device=dev)


def mesh_first_steps(trainer: Trainer) -> dict:
    """MESH_FIRST_STEPS steps from fresh parameters on batches drawn from a
    seeded generator (the trees and dropout from the trainer's): the losses,
    the whole gradients the first step took (averaged over the mesh), the
    whole parameters after the last, and the steps' launches (the counts set
    to 0 just before them and read just after)."""
    trainer.init_state()
    cfg = trainer.config
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 20)
    bs = cfg.bpr_batch_size
    allb = sample_bpr(gen, trainer.graph, MESH_FIRST_STEPS * bs, cfg.neg_candidates,
                      edge_alias=trainer.edge_alias, neg_alias=trainer.neg_alias)
    losses, grads = [], None
    st.launches = sc.launches = 0
    for i in range(MESH_FIRST_STEPS):
        losses += trainer.train_epoch([allb.slice(i * bs, (i + 1) * bs)]).cpu().tolist()
        if grads is None:
            grads = {f"grad/{k}": v for k, v in whole_params(trainer, grads=True).items()}
    launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
    return {"losses": losses, "params": {**whole_params(trainer), **grads}, "launches": launches}


def mesh_path(trainer: Trainer, epochs: int, ckpt=None) -> dict:
    """Phase 19's path on one trainer: an evaluation, ``epochs`` epochs, an
    evaluation, and ``save`` when ``ckpt``; the launch counts set to 0 just
    before and read just after."""
    trainer.init_state()
    st.launches = sc.launches = 0
    first = trainer.test()
    losses, seconds = [], []
    for _ in range(epochs):
        dt, mean, _ = _timed_epoch(trainer)
        losses.append(mean)
        seconds.append(dt)
    last = trainer.test()
    if ckpt is not None:
        trainer.save(ckpt)
    launches = {"masked_topk": st.launches, "scatter_add_rows": sc.launches}
    steps = epochs * trainer.num_batches
    return {"first": first, "last": last, "losses": losses, "epoch_s": seconds, "launches": launches,
            "steps": steps, "samples_per_s": trainer.samples_per_epoch / float(np.median(seconds))}


def _mib(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 2**20


def sharded_state_mib(trainer: Trainer) -> dict:
    """MiB of the row-sharded parameters and their Adam moments on this
    rank, and of the same parameters whole."""
    names = trainer.shards.names if trainer.shards is not None else []
    params = dict(trainer.model.named_parameters())
    mine = [params[k] for k in names]
    moments = [trainer.optimizer.state[p][m] for p in mine for m in ("exp_avg", "exp_avg_sq")
               if p in trainer.optimizer.state]
    whole = sum(trainer.shards.rows[k] * params[k][0].numel() * params[k].element_size() for k in names) / 2**20
    return {"names": names, "rank_params_mib": _mib(mine), "rank_moments_mib": _mib(moments),
            "whole_params_mib": whole, "whole_moments_mib": 2 * whole}


def whole_params(trainer: Trainer, grads: bool = False) -> dict:
    """The trainer's parameters (or their gradients), the row-sharded ones
    gathered whole, as numpy arrays."""
    shards = trainer.shards
    out = {}
    for k, p in trainer.model.named_parameters():
        t = p.grad if grads else p.detach()
        out[k] = (shards.gather(t) if shards is not None and k in shards.names else t).cpu().numpy().copy()
    return out


def _grads_rule(got: dict, want: dict) -> float:
    """Each gradient within 1e-6 + MESH_GRAD_RTOL x its tensor's largest
    magnitude; returns the worst share of that bound."""
    worst = 0.0
    for k, w in want.items():
        if k.startswith("grad/"):
            bound = 1e-6 + MESH_GRAD_RTOL * float(np.abs(w).max())
            err = float(np.abs(got[k] - w).max())
            assert err <= bound, f"{k}: off by {err} (bound {bound})"
            worst = max(worst, err / bound)
    return worst


def mesh_ops_on_card(mesh, dev) -> dict:
    """sharded_masked_topk at (M, d) = (10000, 32) and (10000, 64), this data
    rank's share of a tile of MESH_TOPK_B users (the path's), k in
    MESH_TOPK_KS against the plain top-k over the whole catalog (rule 3(b));
    sharded_embedding_lookup's rows (equal) and gradient (within 1e-5 + 1e-5
    x the magnitudes summed into the element) against the plain gather and
    scatter over the whole table. Their launches are not the path's."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    n, m = A20_USERS, A20_ITEMS
    rng = np.random.default_rng(SEED + 19)
    rows = [np.unique(rng.integers(0, m, rng.integers(1, 40))) for _ in range(n)]
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)).to(dev)
    indices = torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(dev)
    users = torch.from_numpy(rng.choice(n, MESH_TOPK_B, replace=False).astype(np.int32)).to(dev)
    per = MESH_TOPK_B // mesh.data
    mine = users[mesh.index(DATA_AXIS) * per : (mesh.index(DATA_AXIS) + 1) * per]
    mask = local_mask(CSR(indptr, indices), m, mesh, m)
    out = {"topk": {}, "shapes": {"M": m, "d": [TS_D, MESH_LGN_D], "M_block": -(-m // mesh.model), "B_rank": per}}
    for d in (TS_D, MESH_LGN_D):
        U = torch.randn((n, d), generator=gen, device=dev)
        I = torch.randn((m, d), generator=gen, device=dev)
        block = item_block(I, mesh)
        for k in MESH_TOPK_KS:
            sv, si = sharded_masked_topk(U, block, mine, k, mask, mesh)
            wv, wi = st.masked_topk_reference(U, I, mine, k, indptr, indices)
            err = compare(sv, si, wv, wi, exact=False)
            out["topk"][f"d{d}_k{k}"] = {"max_abs_err": err, "ids_equal": bool(torch.equal(si, wi.to(si.dtype)))}
    # the lookup: a table of the item catalog's shape, ids of a step's tree level
    table = torch.randn((m, TS_D), generator=gen, device=dev)
    ids = torch.randint(0, m, (MESH_LOOKUP_R,), generator=gen, device=dev, dtype=torch.int32)
    rows_per = m // mesh.model
    lo = mesh.index(MODEL_AXIS) * rows_per
    local = table[lo : lo + rows_per].clone().requires_grad_(True)
    per_ids = MESH_LOOKUP_R // mesh.data
    my_ids = ids[mesh.index(DATA_AXIS) * per_ids : (mesh.index(DATA_AXIS) + 1) * per_ids]
    vals = sharded_embedding_lookup(local, my_ids, mesh)
    torch.sum(vals**2).backward()
    want = table.index_select(0, ids.long())
    assert torch.equal(vals, want[mesh.index(DATA_AXIS) * per_ids : (mesh.index(DATA_AXIS) + 1) * per_ids]), \
        "sharded_embedding_lookup's rows differ from the plain gather's"
    g_want = sc.scatter_add_rows_reference(ids, 2 * want, m)[lo : lo + rows_per]
    mag = sc.scatter_add_rows_reference(ids, 2 * want.abs(), m)[lo : lo + rows_per]
    g_err = (local.grad - g_want).abs()
    assert bool((g_err <= 1e-5 + 1e-5 * mag).all()), f"lookup gradient off by {float(g_err.max())}"
    out["lookup"] = {"V": m, "d": TS_D, "R": MESH_LOOKUP_R, "V_block": rows_per, "R_rank": per_ids,
                     "grad_max_abs_err": float(g_err.max())}
    return out


@contextlib.contextmanager
def record_launch_shapes():
    """Inside, both kernels' launch functions record each launch's shape in
    the dict it yields: {"scatter_add_rows": {(N, R, D)}, "masked_topk": {(B,
    M, d, k)}}; the launches themselves and their counts are unchanged."""
    shapes = {"scatter_add_rows": set(), "masked_topk": set()}
    sc_launch, st_launch = sc._launch, st._launch

    def scatter(ids, rows, num_rows, *a, **kw):
        shapes["scatter_add_rows"].add((num_rows, ids.numel(), rows.shape[1]))
        return sc_launch(ids, rows, num_rows, *a, **kw)

    def topk(user_emb, item_emb, users, k, *a, **kw):
        shapes["masked_topk"].add((users.numel(), item_emb.shape[0], item_emb.shape[1], k))
        return st_launch(user_emb, item_emb, users, k, *a, **kw)

    sc._launch, st._launch = scatter, topk
    try:
        yield shapes
    finally:
        sc._launch, st._launch = sc_launch, st_launch


def whole_moments(trainer: Trainer) -> dict:
    """Every Adam moment under its checkpoint key (as Trainer.save names it),
    the row-sharded ones gathered whole, and the generator's state."""
    shards, named = trainer.shards, dict(trainer.model.named_parameters())
    out = {"generator": trainer.generator.get_state().numpy()}
    for prefix, opt in trainer._optimizers().items():
        for name, p in named.items():
            for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                if p in opt.state:
                    t = opt.state[p][moment]
                    whole = shards.gather(t) if shards is not None and name in shards.names else t
                    out[f"{prefix}_{key}/{name}"] = whole.cpu().numpy()
    return out


def mesh_rank() -> None:
    """One rank of phase 19's mesh, in its own process (argv: rank, then a
    JSON object of the phase's arguments; its device may name the rank, as
    cuda:{rank}); writes its results as JSON."""
    rank, args = int(sys.argv[1]), json.loads(sys.argv[2])
    dev = torch.device(args["device"].format(rank=rank))
    initialize_multihost(world_size=args["world"], rank=rank, init_method=args["init"],
                         backend=args["backend"], device=dev, timeout_s=300)
    try:
        out = {"rank": rank}
        with record_launch_shapes() as shapes:
            for kind, case in MESH_CASES.items():
                t0 = time.perf_counter()
                trainer = mesh_trainer(kind, args["data_dir"], dev, tuple(args["mesh"]))
                setup_s = time.perf_counter() - t0
                for part in shapes.values():
                    part.clear()
                first = mesh_first_steps(trainer)
                np.savez(os.path.join(args["out"], f"{kind}_first_{rank}.npz"), **first.pop("params"))
                ckpt = args["ckpt"].format(rank=rank) if kind == "textsage" else None
                res = mesh_path(trainer, case["epochs"], ckpt) if case["epochs"] else {}
                res["launch_shapes"] = {kernel: sorted(part) for kernel, part in shapes.items()}
                np.savez(os.path.join(args["out"], f"{kind}_moments_{rank}.npz"), **whole_moments(trainer))
                res["first_steps_losses"] = first["losses"]
                res["first_steps_launches"] = first["launches"]
                res.update(setup_s=setup_s, memory=sharded_state_mib(trainer),
                           eval_tiles=int(trainer.eval_data.users.shape[0]))
                np.savez(os.path.join(args["out"], f"{kind}_params_{rank}.npz"), **whole_params(trainer))
                out[kind] = res
                del trainer
        out["ops"] = mesh_ops_on_card(make_mesh(*args["mesh"], device=dev), dev)
        with open(os.path.join(args["out"], f"rank_{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def nccl_one_rank() -> None:
    """Phase 19's NCCL pass: a world of one rank on card 0 runs every
    collective helper once; prints one JSON line."""
    dev = torch.device("cuda", 0)
    initialize_multihost(world_size=1, rank=0, init_method=sys.argv[1], backend="nccl", device=dev, timeout_s=120)
    try:
        mesh = make_mesh(1, 1, device=dev)
        x = torch.arange(6.0, device=dev).reshape(2, 3)
        checks = {
            "all_reduce": torch.equal(mesh.all_reduce(x.clone(), DATA_AXIS), x),
            "all_gather": torch.equal(mesh.all_gather(x, MODEL_AXIS)[0], x),
            "broadcast": torch.equal(mesh.broadcast_from_primary(x.clone()), x),
        }
        g = x.clone()
        mesh.average([g])
        mesh.barrier()
        checks["average"] = torch.equal(g, x)
        ops = mesh_ops_on_card(mesh, dev)  # raises where a result differs
        print(json.dumps({"backend": torch.distributed.get_backend(), "checks": checks, "ops": ops}))
    finally:
        shutdown()


def nccl_pass(boot: str, init: str, here: str) -> dict:
    """``nccl_one_rank`` in its own process; its JSON line, checked."""
    r = subprocess.run([sys.executable, "-c", boot, init], capture_output=True, text=True, timeout=300, cwd=here)
    assert r.returncode == 0, f"the one-rank NCCL pass failed:\n{r.stderr[-4000:]}"
    nccl = json.loads(r.stdout.strip().splitlines()[-1])
    assert nccl["backend"] == "nccl" and all(nccl["checks"].values()), nccl
    return nccl


def _params_rule(got: dict, want: dict, max_abs: float, share: float = 1e-3) -> dict:
    """Phase 7's rule: every parameter within ``max_abs``, all but ``share``
    of them within 1e-6 + 1e-5 |p|."""
    off = total = 0
    worst = 0.0
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        diff = np.abs(got[k] - w)
        off += int((diff > 1e-6 + 1e-5 * np.abs(w)).sum())
        total += diff.size
        worst = max(worst, float(diff.max()))
    assert worst <= max_abs, f"a parameter off by {worst} (> {max_abs})"
    assert off <= share * total, f"{off} of {total} parameters off"
    return {"off": off, "total": total, "max_abs_diff": worst}


def _metrics_off(got: dict, want: dict, atol: float = MESH_METRIC_ATOL) -> float:
    assert set(got) == set(want)
    worst = max(abs(got[k] - want[k]) for k in want)
    assert worst <= atol, f"metrics off by {worst} (> {atol})"
    return float(worst)


def mesh_single(data_dir: str, dev, root: str) -> dict:
    """Phase 19's one-process runs of every case on ``dev``: the first
    steps, then the path where the case has one (textsage saved under
    ``root``)."""
    single = {}
    for kind, case in MESH_CASES.items():
        trainer = mesh_trainer(kind, data_dir, dev)
        first = mesh_first_steps(trainer)
        single[kind] = (mesh_path(trainer, case["epochs"], os.path.join(root, "single.ckpt")
                                  if kind == "textsage" else None) if case["epochs"] else {})
        single[kind]["memory"] = {"params_mib": _mib(trainer.model.parameters())}
        single[kind]["params"] = whole_params(trainer)
        single[kind]["first_steps"] = first
        del trainer
    return single


_HERE = os.path.dirname(os.path.abspath(__file__))
_BOOT = f"import sys; sys.path.insert(0, {_HERE!r}); import chip_smoke; chip_smoke.{{}}()"


def launch_mesh(mesh, data_dir: str, out: str, backend: str, device: str) -> tuple:
    """``mesh_rank`` in data x model processes, joined through a file
    rendezvous under ``out``; ``device`` may name the rank (cuda:{rank}).
    Returns (each rank's results, wall seconds); raises if a rank fails."""
    os.makedirs(out, exist_ok=True)
    args = {"world": mesh[0] * mesh[1], "mesh": list(mesh), "backend": backend, "device": device,
            "init": f"file://{out}/rendezvous", "data_dir": data_dir, "out": out,
            "ckpt": os.path.join(out, "ckpt_{rank}.npz")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _BOOT.format("mesh_rank"), str(r), json.dumps(args)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_HERE)
             for r in range(args["world"])]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=MESH_TIMEOUT_S)
            assert p.returncode == 0, f"mesh rank {r} failed ({p.returncode}):\n{err[-6000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    return [json.load(open(os.path.join(out, f"rank_{r}.json"))) for r in range(args["world"])], wall


def check_mesh(single: dict, ranks: list, out: str, data_dir: str, label: str) -> dict:
    """Every rank's runs against the one-process runs (module docstring,
    phase 19); logs a line a rank and case; {kind: facts}."""
    facts = {}
    for kind, case in MESH_CASES.items():
        want = single[kind]
        path = case["epochs"] > 0
        per_rank = []
        # the replicas: every rank holds rank 0's losses, metrics, gradients
        # and whole parameters bit for bit (world-averaged gradients)
        head = ranks[0][kind]
        for rank in ranks[1:]:
            for key in ("first_steps_losses",) + (("losses", "first", "last") if path else ()):
                assert rank[kind][key] == head[key], f"{kind} rank {rank['rank']}: {key} differs from rank 0's"
            for part in ("first", "moments") + (("params",) if path else ()):
                a, b = (dict(np.load(os.path.join(out, f"{kind}_{part}_{r}.npz"))) for r in (0, rank["rank"]))
                assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a), \
                    f"{kind} rank {rank['rank']}: {part} differ from rank 0's"
        lr = mesh_config(kind, data_dir).lr
        per_step = case["scatter_per_step"]
        for rank in ranks:
            got = rank[kind]
            # the first steps from the same state: phase 7's rule
            np.testing.assert_allclose(got["first_steps_losses"][0], want["first_steps"]["losses"][0], rtol=1e-5)
            np.testing.assert_allclose(got["first_steps_losses"], want["first_steps"]["losses"], rtol=1e-4)
            got_first = dict(np.load(os.path.join(out, f"{kind}_first_{rank['rank']}.npz")))
            grads = _grads_rule(got_first, want["first_steps"]["params"])
            first = _params_rule({k: v for k, v in got_first.items() if not k.startswith("grad/")},
                                 {k: v for k, v in want["first_steps"]["params"].items()
                                  if not k.startswith("grad/")}, max_abs=4 * lr)
            first["grads_worst_share_of_bound"] = grads
            assert got["first_steps_launches"] == {"masked_topk": 0, "scatter_add_rows": per_step * MESH_FIRST_STEPS}, \
                (kind, got["first_steps_launches"])
            row = {"rank": rank["rank"], "first_steps": {"losses": got["first_steps_losses"], "params": first,
                                                          "launches": got["first_steps_launches"]},
                   "setup_s": got["setup_s"], "memory": got["memory"]}
            line = (f"{label} {kind} rank {rank['rank']}: {MESH_FIRST_STEPS} steps from the same state, the first "
                    f"step's gradients within {grads:.3g} of their bound, parameters within 1e-6 + 1e-5 |p| but "
                    f"{first['off']} of {first['total']} (max abs diff {first['max_abs_diff']:.3g}), launches "
                    f"{got['first_steps_launches']}")
            if path:
                np.testing.assert_allclose(got["losses"], want["losses"], rtol=MESH_LOSS_RTOL)
                off = {"first": _metrics_off(got["first"], want["first"]),
                       "last": _metrics_off(got["last"], want["last"])}
                params = dict(np.load(os.path.join(out, f"{kind}_params_{rank['rank']}.npz")))
                rule = _params_rule(params, want["params"], max_abs=MESH_PARAM_LRS * lr, share=1.0)
                tiles, steps = got["eval_tiles"], got["steps"]
                assert got["launches"]["scatter_add_rows"] == per_step * steps, (kind, got["launches"], steps)
                assert got["launches"]["masked_topk"] == 2 * tiles, (kind, got["launches"], tiles)
                row.update(launches=got["launches"], metrics_max_abs_diff=off, params=rule,
                           samples_per_s=got["samples_per_s"], epoch_s=got["epoch_s"],
                           loss_max_rel_diff=float(np.max(np.abs(np.asarray(got["losses"]) - want["losses"])
                                                          / np.abs(want["losses"]))))
                line += (f"; losses {got['losses']} (one process {want['losses']}); recall@10 "
                         f"{got['first']['recall@10']:.4f} -> {got['last']['recall@10']:.4f}, metrics off by at most "
                         f"{max(off.values()):.3g}; after them parameters within 1e-6 + 1e-5 |p| but {rule['off']} "
                         f"of {rule['total']} (max abs diff {rule['max_abs_diff']:.3g}); launches {got['launches']} "
                         f"over {steps} steps and 2 x {tiles} tiles")
            else:
                row["launches"] = got["first_steps_launches"]
            per_rank.append(row)
            log(line + f"; row-sharded {got['memory']['names']}: {got['memory']['rank_params_mib']:.2f} MiB of "
                f"parameters and {got['memory']['rank_moments_mib']:.2f} MiB of moments on this rank, "
                f"{got['memory']['whole_params_mib']:.2f} + {got['memory']['whole_moments_mib']:.2f} MiB whole")
        facts[kind] = {"single": {k: want[k] for k in ("losses", "first", "last", "launches", "steps",
                                                        "samples_per_s", "epoch_s", "memory") if k in want},
                       "ranks": per_rank}
    return facts


def mesh_20k(data_dir: str, dev, root: str, smi: str) -> dict:
    """Phase 19: the mesh on one card (module docstring)."""
    t_phase = time.perf_counter()
    facts = {"mesh": list(MESH), "world": MESH[0] * MESH[1], "backend": "gloo", "device": "cuda:0",
             "compute_dtype": MESH_DTYPE, "epochs": MESH_EPOCHS, "card": smi}
    single = mesh_single(data_dir, dev, root)
    # one process twice: the card's own spread over the same 168 steps
    again = mesh_trainer("textsage", data_dir, dev)
    twice = mesh_path(again, MESH_EPOCHS)
    spread = {"loss_max_rel_diff": float(np.max(np.abs(np.asarray(twice["losses"]) - single["textsage"]["losses"])
                                                / np.abs(single["textsage"]["losses"]))),
              "metrics_max_abs_diff": float(max(abs(twice["last"][k] - single["textsage"]["last"][k])
                                                for k in twice["last"])),
              "params_max_abs_diff": float(max(np.abs(v - single["textsage"]["params"][k]).max()
                                               for k, v in whole_params(again).items()))}
    del again
    facts["textsage_one_process_twice"] = spread
    log(f"mesh-20k textsage, one process twice: losses within {spread['loss_max_rel_diff']:.3g} relative, "
        f"metrics within {spread['metrics_max_abs_diff']:.3g}, parameters within {spread['params_max_abs_diff']:.3g}")
    out = os.path.join(root, "mesh")
    ranks, facts["mesh_wall_s"] = launch_mesh(MESH, data_dir, out, "gloo",
                                              "cuda:0" if dev.type == "cuda" else "cpu")
    nccl = nccl_pass(_BOOT.format("nccl_one_rank"), f"file://{out}/nccl", _HERE)
    facts["nccl_one_rank"] = nccl
    facts.update(check_mesh(single, ranks, out, data_dir, "mesh-20k"))
    for kind, case in MESH_CASES.items():
        if case["epochs"]:
            log(f"mesh-20k {kind}: {facts[kind]['ranks'][0]['samples_per_s']:.0f} samples/s on each of 4 "
                f"processes sharing one card through host-memory collectives (one process alone: "
                f"{single[kind]['samples_per_s']:.0f}); no scaling claim")

    # the kernels launched at the case's shapes, which phase 3 held against
    # their plain versions
    for rank in ranks:
        for kind, case in MESH_CASES.items():
            shapes = rank[kind]["launch_shapes"]
            assert {tuple(x) for x in shapes["scatter_add_rows"]} <= set(case["scatter_shapes"]), (kind, shapes)
            assert {tuple(x) for x in shapes["masked_topk"]} <= set(case["topk_shapes"]), (kind, shapes)
    facts["launch_shapes"] = {kind: ranks[0][kind]["launch_shapes"] for kind in MESH_CASES}
    log(f"mesh-20k launch shapes, each checked in phase 3: {facts['launch_shapes']}")

    # the primary's checkpoint: the ranks' whole tables and moments and one
    # process's generator state; restored into one process, it evaluates as
    # the mesh did
    assert sorted(f for f in os.listdir(out) if f.startswith("ckpt_")) == ["ckpt_0.npz"], os.listdir(out)
    ref = load_checkpoint(os.path.join(root, "single.ckpt"))
    got = load_checkpoint(os.path.join(out, "ckpt_0.npz"))
    for part in ("params", "state"):
        assert sorted(got[part]) == sorted(ref[part]), part
        for key, v in ref[part].items():
            assert np.shape(got[part][key]) == np.shape(v), key
    moments = dict(np.load(os.path.join(out, "textsage_moments_0.npz")))
    generator = got["state"].pop("generator")
    assert np.array_equal(generator, moments.pop("generator")), "the checkpoint's generator is not the ranks'"
    assert np.array_equal(generator, ref["state"]["generator"]), "the mesh drew otherwise than one process"
    for key, v in moments.items():
        assert np.array_equal(got["state"][key], v), f"the checkpoint's {key} differs from the ranks'"
    for key, v in dict(np.load(os.path.join(out, "textsage_params_0.npz"))).items():
        assert np.array_equal(got["params"][key], v), f"the checkpoint's {key} differs from the ranks'"
    back = mesh_trainer("textsage", data_dir, dev)
    back.restore(os.path.join(out, "ckpt_0.npz"))
    restored_off = _metrics_off(back.test(), ranks[0]["textsage"]["last"], MESH_RESTORE_ATOL)
    log(f"mesh-20k checkpoint: written by rank 0 alone; its tables and {len(moments)} moments bit-equal to the "
        f"ranks', its generator state one process's; restored into one process, its evaluation within "
        f"{restored_off:.3g} of the mesh's (bound {MESH_RESTORE_ATOL})")
    facts["restore"] = {"metrics_max_abs_diff": restored_off}
    facts["ops"] = ranks[0]["ops"]
    for rank in ranks:
        for k, t in rank["ops"]["topk"].items():
            log(f"mesh-20k rank {rank['rank']} sharded_masked_topk {k}: equal to the plain top-k over the whole "
                f"catalog (max abs err {t['max_abs_err']:.3g}, ids equal: {t['ids_equal']}); lookup gradient "
                f"within {rank['ops']['lookup']['grad_max_abs_err']:.3g}")
    log(f"mesh-20k NCCL, one rank: {nccl['checks']}")
    facts["launches"] = {kernel: sum(row["launches"][kernel] for kind in MESH_CASES for row in facts[kind]["ranks"])
                         for kernel in ("masked_topk", "scatter_add_rows")}
    facts["seconds"] = time.perf_counter() - t_phase
    log(f"mesh-20k: {facts['seconds']:.0f} s (the mesh's 4 processes {facts['mesh_wall_s']:.0f} s)")
    return facts

def main() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    report = _cuda.build()
    log(f"build: {len(report)} sources in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    native.library()  # the host C++ (g++); a failed build raises
    log(f"build: the host library in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")
    occupancy = {f"k{k}_d{d}": st._blocks_per_sm(0, k, d) for k in (20, 64, 128) for d in (64, 100)}
    log(f"masked_topk pass 1, blocks per SM (occupancy API): {occupancy}")

    # 3. kernels against their plain versions
    max_err, topk_held, wide_max_err = kernel_cases(dev)
    max_err = max(max_err, mesh_topk_cases(dev))
    sc_max_err, sc_held = scatter_cases(dev)

    # 4. the serve path at full width
    t0 = time.perf_counter()
    ds = synthetic_dataset(n_users=50_000, m_items=20_000, avg_degree=30, seed=SEED)
    graph = ds.graph
    log(f"data: {ds.n_users} users, {ds.m_items} items, {ds.train_size} train edges "
        f"({time.perf_counter() - t0:.1f} s)")
    cfg = Config(model="lgn", latent_dim=D, n_layers=2, compute_dtype="bfloat16", seed=SEED)
    rng = np.random.default_rng(SEED)
    params = {
        "user_emb": (0.1 * rng.standard_normal((ds.n_users, D))).astype(np.float32),
        "item_emb": (0.1 * rng.standard_normal((ds.m_items, D))).astype(np.float32),
    }
    model = build_model("lgn", cfg, graph)
    request_users = {
        b: np.random.default_rng(SEED + b).choice(ds.n_users, size=b, replace=False)
        for b in TILES + (EVAL_TILE,)
    }

    st.launches = sc.launches = 0
    t0 = time.perf_counter()
    rec = Recommender(model, ds, cfg, params, device="cuda")
    torch.cuda.synchronize()
    first_refresh_s = time.perf_counter() - t0
    answers = {}
    for b in TILES:
        for k in (10, 20):
            before = st.launches
            answers[(b, k)] = rec.recommend(request_users[b], k=k)
            assert st.launches >= before + 1, "a request did not launch the kernel"
    srv = make_server(rec, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        before = st.launches
        one = json.load(urllib.request.urlopen(f"{base}/recommend?user=17&k=10", timeout=60))
        req = urllib.request.Request(
            f"{base}/recommend", data=json.dumps({"users": [3, 40000], "k": 10}).encode(),
            method="POST",
        )
        batch = json.load(urllib.request.urlopen(req, timeout=60))
        assert st.launches >= before + 2, "an HTTP request did not launch the kernel"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    serve_launches = st.launches
    assert sc.launches == 0, "the serve path launched the scatter kernel"
    assert not th.is_alive()
    n_requests = len(answers) + 2
    log(f"serve: {n_requests} requests, {serve_launches} kernel launches")

    # the answers against the plain version on the same embeddings
    U, I = rec._user_emb, rec._item_emb
    mask = (rec._mask.indptr, rec._mask.indices)
    pos = ds.all_pos()
    for (b, k), (ids, scores) in answers.items():
        assert ids.shape == (b, k) and np.isfinite(scores).all()
        users = torch.from_numpy(request_users[b]).to(dev)
        rv, ri = st.masked_topk_reference(U, I, users, k, *mask)
        max_err = max(max_err, compare(
            torch.from_numpy(scores), torch.from_numpy(ids), rv, ri, exact=False))
        for u, row in zip(request_users[b], ids):
            assert not set(row.tolist()) & set(pos[u].tolist()), "a train positive was served"
    want_ids, _ = rec.recommend([17], k=10)
    assert one["user"] == 17 and one["items"] == want_ids[0].tolist()
    want_ids, _ = rec.recommend([3, 40000], k=10)
    assert [r["items"] for r in batch] == want_ids.tolist()
    ref = reference_propagate(graph, params, cfg.n_layers, torch.bfloat16)
    got = torch.cat([U, I]).cpu().numpy()
    assert got.shape == (ds.n_users + ds.m_items, D) and np.isfinite(got).all()
    # a layer's float32 sum may round to bfloat16 on the other side of a
    # rounding boundary than the float64 sum does: rtol 2e-3, atol 1e-5
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-5)
    log(f"propagate: equal to the float64 CPU propagation (max abs err "
        f"{np.abs(got - ref).max():.3g}); first refresh {first_refresh_s:.2f} s")

    # 5. numbers
    propagate_ms = host_ms(lambda: rec.refresh(None), reps=10)
    propagate_profile = device_profile(lambda: rec.refresh(None), n=5)
    tiles = []
    pos_csr = CSR(*mask)
    for b, k in [(b, k) for b in TILES for k in (10, 20)] + [(EVAL_TILE, 20)]:
        users = torch.from_numpy(request_users[b]).to(dev)
        tiles.append(topk_numbers(U, I, users, k, mask, pos_csr, dev,
                                  request=lambda b=b, k=k: rec.recommend(request_users[b], k=k)))
    head = next(t for t in tiles if t["B"] == 512 and t["k"] == 20)
    eval_tile = next(t for t in tiles if t["B"] == EVAL_TILE)

    # 6. the training path at full width
    trainer, train = train_path(ds, dev)

    # 7. the card against the CPU, and the evaluation against the plain top-k
    train["card_vs_cpu"] = card_vs_cpu(ds, trainer)
    train["eval_vs_plain"] = eval_kernel_vs_plain(trainer)

    # 8. numbers
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    batch = sample_bpr(gen, trainer.graph, TRAIN_B, trainer.config.neg_candidates)
    train["host_syncs_per_step"] = host_syncs(lambda: trainer.train_step(batch))
    train["host_syncs_sampler"] = host_syncs(
        lambda: sample_bpr(gen, trainer.graph, trainer.samples_per_epoch,
                           trainer.config.neg_candidates))
    trainer.train_step(batch)
    torch.cuda.synchronize()
    train["step_profile"] = split_profile(lambda: trainer.train_step(batch), n=20)
    train["sampler_profile"] = split_profile(
        lambda: sample_bpr(gen, trainer.graph, trainer.samples_per_epoch,
                           trainer.config.neg_candidates), n=1)
    train["eval_profile"] = split_profile(trainer.test, n=1)
    if train["step_profile"] is not None:
        # the device's idle share of an unprofiled step: its device time
        # against the step's wall time in the timed epochs
        train["idle_share_unprofiled"] = 1.0 - train["step_profile"]["device_ms"] / train["step_ms"]
    sc_shapes = scatter_numbers(trainer, dev)
    sc_head = sc_shapes[0]
    del trainer, rec

    # 9. serve-textsage-100k
    ts_ds, ts_fs, ts_host = textsage_data()
    ts_serve = serve_textsage(ts_ds, ts_fs, dev, ts_host)

    # 10. train-textsage-100k
    ts_trainer, ts_train = train_textsage(ts_ds, ts_fs, dev)
    ts_train["eval_vs_plain"] = eval_kernel_vs_plain(ts_trainer)
    ts_train["card_vs_cpu"] = card_vs_cpu_textsage(ts_ds, ts_fs, ts_trainer)

    # 11. numbers
    cfg_ts = ts_trainer.config
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ts_batch = sample_bpr(gen, ts_trainer.graph, cfg_ts.bpr_batch_size, cfg_ts.neg_candidates,
                          edge_alias=ts_trainer.edge_alias, neg_alias=ts_trainer.neg_alias)
    ts_train["host_syncs_per_step"] = host_syncs(lambda: ts_trainer.train_step(ts_batch))
    ts_train["host_syncs_sampler"] = host_syncs(ts_trainer.sample_epoch)
    torch.cuda.synchronize()
    ts_train["step_profile"] = split_profile(lambda: ts_trainer.train_step(ts_batch), n=20)
    ts_train["sampler_profile"] = split_profile(ts_trainer.sample_epoch, n=1)
    ts_train["eval_profile"] = split_profile(ts_trainer.test, n=1)
    if ts_train["step_profile"] is not None:
        ts_train["idle_share_unprofiled"] = (
            1.0 - ts_train["step_profile"]["device_ms"] / ts_train["step_ms"])
        split = ", ".join(f"{k} {v:.3f}" for k, v in ts_train["step_profile"]["split_ms"].items())
        log(f"train-textsage: {ts_train['samples_per_s']:.0f} samples/s; a step {ts_train['step_ms']:.2f} ms "
            f"on the host, {ts_train['step_profile']['device_ms']:.3f} ms on the device ({split}); "
            f"idle {ts_train['idle_share_unprofiled']:.3f}")
    user_ids, item_ids = tree_gather_ids(ts_trainer.model, ts_trainer.graph, ts_batch, gen)
    assert (user_ids.numel(), item_ids.numel()) == tuple(r for _, r in TS_SCATTER[:2])
    cat_ids = torch.randint(0, TS_SCATTER[2][0], (TS_SCATTER[2][1],), generator=gen, device=dev,
                            dtype=torch.int32)
    ts_sc_shapes = scatter_numbers_at(
        [(TS_USERS, user_ids), (TS_ITEMS, item_ids), (TS_SCATTER[2][0], cat_ids)], dev, TS_D,
        rows_seed=SEED + 7)
    ts_head = next(t for t in ts_serve["tiles"] if t["B"] == 512)

    # 12. train-textsage-20k: the cadences on the anchor20k shape, and their
    # numbers beside R = 1, and the 100k flagship at R = 8 beside phase 10's R = 1
    with tempfile.TemporaryDirectory() as tmp:
        a20_ds, a20_fs, a20_host = anchor20k_data()
        a20 = train_textsage_20k(a20_ds, a20_fs, dev, tmp)
        a20.update(a20_host)
        a20_trainers = a20.pop("trainers")
        a20["eval_vs_plain"] = eval_kernel_vs_plain(a20_trainers["R8"])
        a20["card_vs_cpu"] = card_vs_cpu_cadences(a20_ds, a20_fs, a20_trainers["R8"], dev)
        # phase 16 serves this checkpoint: the R = 8 trainer after its 6 epochs,
        # before its numbers below train it on
        prod_dir = tempfile.TemporaryDirectory()
        prod_ckpt = os.path.join(prod_dir.name, "textsage_r8.ckpt")
        a20_trainers["R8"].save(prod_ckpt)
        cadences_20k = {"R1": cadence_numbers(cadence_trainer(a20_ds, a20_fs, dev), "train-textsage-20k R=1")}
        for key, trainer_c in a20_trainers.items():
            cadences_20k[key] = cadence_numbers(
                trainer_c, f"train-textsage-20k {key}",
                profile_steps=trainer_c.num_batches if key == "dask" else 2 * CADENCE_BLOCK)
        del a20_trainers, trainer_c
    tr100 = Trainer(cfg_ts.replace(relin_every=CADENCE_BLOCK), ts_ds, _textsage_model(ts_ds, ts_fs, SEED + 1),
                    logger=MetricLogger(quiet=True), ddp_recipe=True, device=dev)
    tr100.init_state()
    cadences_100k = {
        "R1": {"samples_per_s": ts_train["samples_per_s"], "host_ms_per_step": ts_train["step_ms"],
               "steps_per_epoch": ts_train["steps_per_epoch"],
               **({"device_ms_per_step": ts_train["step_profile"]["device_ms"],
                   "device_ops_per_step": ts_train["step_profile"]["device_ops_per_call"],
                   "idle_share_unprofiled": ts_train["idle_share_unprofiled"]}
                  if ts_train["step_profile"] is not None else {})},
        "R8": cadence_numbers(tr100, "train-textsage-100k R=8", profile_steps=3 * CADENCE_BLOCK),
    }
    del tr100

    # 13. attention-20k: tgrec, tgrec2, gnn --conv gat / transformer on the
    # anchor20k graph, served and trained
    att = attention_20k(a20_ds, a20_fs, dev, cadences_20k["R1"])
    att_k200 = att["serve"]["topk"][f"k{ATT_K}"]

    # 14. edge-20k: rsage (add, sum, prod), tgsrec and sasgnn on the anchor20k
    # graph (rsage over its relational message graph), served and trained
    edge = edge_20k(a20_ds, a20_fs, dev, cadences_20k["R1"], att["numbers"]["tgrec"])

    # 15. sequence-attr-20k: sasrec and asage on the anchor20k graph, served
    # and trained
    seq = sequence_attr_20k(a20_ds, a20_fs, dev, cadences_20k["R1"])

    # 20. registry-20k: the registry keys that no other phase drives, served
    # and trained on the anchor20k graph, each launch at a shape phase 3 held
    reg = registry_20k(a20_ds, a20_fs, dev, sc_held, topk_held)

    # 16. production-20k: phase 12's checkpoint through tools evaluate / infer
    # / recommend, production inference over the inference edge set
    prod = production_20k(a20_ds, a20_fs, dev, prod_ckpt, prod_dir.name, smi)

    # 17. rank-20k: the two-stage ranker on the anchor20k graph from phase
    # 16's data directory; the tools from phase 12's checkpoint
    rank = rank_20k(a20_ds, a20_fs, dev, prod_dir.name, prod_ckpt, smi)
    rank_launches = {kernel: sum(part[kernel] for part in rank["launches"].values())
                     for kernel in ("masked_topk", "scatter_add_rows")}
    prod_launches = prod["launches"]["evaluate"] + prod["launches"]["infer_k20"] + prod["launches"][
        "infer_k200"] + prod["launches"]["recommend"]

    # 18. preprocess-20k: raw tables -> tools preprocess -> the flagship
    # trained and evaluated on the artifact directory
    pre = preprocess_20k(dev, smi, (ds.train_user, ds.train_item))

    # 19. mesh-20k: the DDP flagship and lgn on a (2, 2) mesh of 4 processes on
    # the card, from phase 16's data directory, against one process
    with tempfile.TemporaryDirectory() as mesh_root:
        mesh = mesh_20k(os.path.join(prod_dir.name, "data"), dev, mesh_root, smi)
    prod_dir.cleanup()

    ts_serve_launches = ts_serve["launches"]["masked_topk"]
    ts_train_launches = ts_train["launches"]
    # masked_topk calls on the main paths; those above k = 128 took the radix
    # select (attention-20k's three requests at k = 200, production-20k's
    # k = 200 batch), every other one csrc/streaming_topk.cu
    wide_by_path = {"attention_20k": att["launches"]["masked_topk_wide"],
                    "production_20k": prod["launches"]["masked_topk_wide"]}
    calls = (serve_launches + train["launches"]["masked_topk"] + ts_serve_launches
             + ts_train_launches["masked_topk"] + a20["launches"]["masked_topk"]
             + att["launches"]["masked_topk"] + edge["launches"]["masked_topk"]
             + seq["launches"]["masked_topk"] + prod_launches + rank_launches["masked_topk"]
             + pre["launches"]["masked_topk"] + mesh["launches"]["masked_topk"]
             + reg["launches"]["masked_topk"])
    att_k200_wide = att_k200["kernel_profile"] or {}
    kernels = [{
        "name": "masked_topk",
        "route": "cuda",
        "source": "furusato_recommend_tpu_torch/csrc/streaming_topk.cu",
        "replaces": "furusato_recommend_tpu/ops/pallas_topk.py:152",
        "launches": calls - sum(wide_by_path.values()),
        "calls_by_path": {"serve": serve_launches, "train": train["launches"]["masked_topk"],
                             "serve_textsage": ts_serve_launches,
                             "train_textsage": ts_train_launches["masked_topk"],
                             "train_textsage_20k": a20["launches"]["masked_topk"],
                             "attention_20k": att["launches"]["masked_topk"],
                             "edge_20k": edge["launches"]["masked_topk"],
                             "sequence_attr_20k": seq["launches"]["masked_topk"],
                             "production_20k": prod_launches,
                             "rank_20k": rank_launches["masked_topk"],
                             "preprocess_20k": pre["launches"]["masked_topk"],
                             "mesh_20k": mesh["launches"]["masked_topk"],
                             "registry_20k": reg["launches"]["masked_topk"]},
        "launches_per_call": f"1 (k <= {st.MAX_K}; above it the radix select, masked_topk_wide)",
        "mesh_shapes": {"evaluation": [dict(zip(("B_rank", "M_block", "d", "k"), x)) for x in MESH_TOPK_SHAPES],
                        "launched": {kind: mesh["launch_shapes"][kind]["masked_topk"] for kind in MESH_CASES},
                        "sharded_masked_topk": mesh["ops"]["shapes"]},
        "rank_dump": {key: rank["dump_topk"][key] for key in (
            "B", "k", "M", "d", "ms", "plain_ms", "library_ms", "topk_only_ms", "bound_ms", "bound_by",
            "kernel_profile")},
        "textsage": {"at": {"B": 512, "k": TS_K, "M": ts_ds.m_items, "d": TS_D},
                     **{key: ts_head[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                      "bound_by")},
                     "tiles": ts_serve["tiles"]},
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": {"B": 512, "k": 20, "M": ds.m_items, "d": D},
        "pass1_blocks_per_sm": occupancy,
        "eval_tile": {key: eval_tile[key] for key in (
            "B", "k", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_profile")},
        "tiles": tiles,
    }, {
        "name": "masked_topk_wide",
        "route": "cuda",
        "source": "furusato_recommend_tpu_torch/csrc/streaming_topk_wide.cu",
        "replaces": "furusato_recommend_tpu/ops/pallas_topk.py:152",
        "launches": sum(wide_by_path.values()),
        "launches_by_path": wide_by_path,
        "launches_per_call": 1,
        "kernels_per_call": st.wide_kernels(a20_ds.m_items),
        "max_abs_err": wide_max_err,
        # serve-tgrec-20k's requests at k = 200: B = 512 over the anchor20k catalog
        "at": {"B": 512, "k": ATT_K, "M": a20_ds.m_items, "d": TS_D},
        **{key: att_k200[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "device_ms": att_k200_wide.get("device_ms"),
        "k200": {"at": {"B": 512, "k": ATT_K, "M": a20_ds.m_items, "d": TS_D}, "launches_per_call": 1,
                 **{key: att_k200[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                                   "kernel_profile", "request_ms")}},
        "k200_b1000": {key: prod["topk"][f"k{ATT_K}"][key] for key in (
            "B", "k", "M", "d", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_profile")},
        # the ranker dump's shape (k = 50 < 128: masked_topk takes csrc/streaming_topk.cu there; recorded only)
        "dump_shape": {"B": rank["dump_topk"]["B"], "k": rank["dump_topk"]["k"], "M": rank["dump_topk"]["M"],
                       "d": rank["dump_topk"]["d"], "ms": rank["dump_topk"]["wide_ms"],
                       "kernel_profile": rank["dump_topk"]["wide_kernel_profile"],
                       "streaming_topk_ms": rank["dump_topk"]["ms"],
                       "streaming_topk_device_ms": rank["dump_topk"]["kernel_profile"]["device_ms"]},
    }, {
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "furusato_recommend_tpu_torch/csrc/scatter_add_rows.cu",
        "replaces": "furusato_recommend_tpu/ops/pallas_scatter.py:97",
        "launches": (train["launches"]["scatter_add_rows"] + ts_train_launches["scatter_add_rows"]
                     + a20["launches"]["scatter_add_rows"] + att["launches"]["scatter_add_rows"]
                     + edge["launches"]["scatter_add_rows"] + seq["launches"]["scatter_add_rows"]
                     + rank_launches["scatter_add_rows"] + pre["launches"]["scatter_add_rows"]
                     + mesh["launches"]["scatter_add_rows"] + reg["launches"]["scatter_add_rows"]),
        "launches_by_path": {"serve": 0, "train": train["launches"]["scatter_add_rows"],
                             "serve_textsage": ts_serve["launches"]["scatter_add_rows"],
                             "train_textsage": ts_train_launches["scatter_add_rows"],
                             "train_textsage_20k": a20["launches"]["scatter_add_rows"],
                             "attention_20k": att["launches"]["scatter_add_rows"],
                             "edge_20k": edge["launches"]["scatter_add_rows"],
                             "sequence_attr_20k": seq["launches"]["scatter_add_rows"],
                             "production_20k": prod["launches"]["scatter_add_rows"],
                             "rank_20k": rank_launches["scatter_add_rows"],
                             "preprocess_20k": pre["launches"]["scatter_add_rows"],
                             "mesh_20k": mesh["launches"]["scatter_add_rows"],
                             "registry_20k": reg["launches"]["scatter_add_rows"]},
        "launches_per_step": train["scatter_launches_per_step"],
        "launches_per_step_textsage": ts_train["scatter_launches_per_step"],
        "mesh_shapes": {"steps": [dict(zip(("N", "R_rank", "D"), x)) for x in MESH_SCATTER_SHAPES],
                        "launched": {kind: mesh["launch_shapes"][kind]["scatter_add_rows"]
                                     for kind in MESH_CASES},
                        "sharded_embedding_lookup": mesh["ops"]["lookup"]},
        "textsage_shapes": ts_sc_shapes,
        "relation_shapes": [{key: t[key] for key in ("N", "R", "D", "plan", "ms", "row_mode_ms", "plain_ms",
                                                     "library_ms", "device_ms", "row_mode_device_ms",
                                                     "library_device_ms", "bound_ms", "bound_by")}
                            for t in edge["relation_scatter"]],
        "sequence_attr_shapes": [{key: t[key] for key in ("N", "R", "D", "plan", "ms", "row_mode_ms", "plain_ms",
                                                          "library_ms", "device_ms", "row_mode_device_ms",
                                                          "library_device_ms", "bound_ms", "bound_by",
                                                          "global_adds", "largest_id_share")}
                                 for t in seq["scatter_shapes"]],
        "registry_shapes": [{key: t[key] for key in ("N", "R", "D", "plan", "ms", "row_mode_ms", "plain_ms",
                                                     "library_ms", "device_ms", "row_mode_device_ms",
                                                     "library_device_ms", "bound_ms", "bound_by", "global_adds",
                                                     "largest_id_share")}
                            for t in reg["scatter_shapes"]],
        "rank_shape": {key: rank["ranker_scatter"][key] for key in (
            "N", "R", "D", "plan", "ms", "row_mode_ms", "plain_ms", "library_ms", "device_ms",
            "row_mode_device_ms", "library_device_ms", "bound_ms", "bound_by", "global_adds",
            "largest_id_share")},
        "max_abs_err": sc_max_err,
        "ms": sc_head["ms"],
        "row_mode_ms": sc_head["row_mode_ms"],
        "plain_ms": sc_head["plain_ms"],
        "bound_ms": sc_head["bound_ms"],
        "bound_by": sc_head["bound_by"],
        "library_ms": sc_head["library_ms"],
        "at": {"N": sc_head["N"], "R": sc_head["R"], "D": D},
        "shapes": sc_shapes,
    }]
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.0f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "serve": {"propagate_ms": propagate_ms, "first_refresh_s": first_refresh_s,
                  "propagate_profile": propagate_profile,
                  "request_ms": {f"B{t['B']}_k{t['k']}": t["request_ms"] for t in tiles}}
    }))
    log(json.dumps({"train": {
        "model": "lgn", "d": D, "layers": 2, "B": TRAIN_B, "lr": TRAIN_LR,
        "compute_dtype": "bfloat16", "users": ds.n_users, "items": ds.m_items,
        "train_edges": ds.train_size, **train}}))
    ts_shape = {"model": "textsage", "d": TS_D, "layers": cfg_ts.n_layers, "fanout": cfg_ts.num_neighbors,
                "compute_dtype": cfg_ts.compute_dtype, "users": ts_ds.n_users, "items": ts_ds.m_items,
                "train_edges": ts_ds.train_size}
    log(json.dumps({"serve_textsage": {**ts_shape, **ts_serve}}))
    log(json.dumps({"train_textsage": {**ts_shape, "B": cfg_ts.bpr_batch_size, "lr": cfg_ts.lr,
                                       **ts_train}}))
    log(json.dumps({"train_cadences": {
        "train_textsage_20k": {"model": "textsage", "d": TS_D, "users": A20_USERS, "items": A20_ITEMS,
                               "train_edges": A20_EDGES, "features": "informative", **a20,
                               "numbers": cadences_20k},
        "train_textsage_100k": cadences_100k}}))
    log(json.dumps({"train_attention": {
        "d": TS_D, "heads": N_HEADS, "users": A20_USERS, "items": A20_ITEMS, "train_edges": A20_EDGES,
        "features": "informative", **att}}))
    log(json.dumps({"train_edge": {
        "d": TS_D, "users": A20_USERS, "items": A20_ITEMS, "train_edges": A20_EDGES, "features": "informative",
        **edge}}))
    log(json.dumps({"train_sequence": {
        "d": {"sasrec": SEQ_D, "asage": TS_D}, "users": A20_USERS, "items": A20_ITEMS, "train_edges": A20_EDGES,
        "features": "informative", **seq}}))
    log(json.dumps({"production": {
        "model": "textsage", "d": TS_D, "relin_every": CADENCE_BLOCK, "users": A20_USERS, "items": A20_ITEMS,
        "train_edges": A20_EDGES, "features": "informative", **prod}}))
    log(json.dumps({"rank": {
        "retrievers": {"lgn": {"d": 32, "B": 2048, "lr": 0.01}, "textsage": {"d": TS_D, "recipe": "ddp_flagship"}},
        "k_cand": RANK_K, "users": A20_USERS, "items": A20_ITEMS, "train_edges": A20_EDGES,
        "features": "informative", **rank}}))
    log(json.dumps({"preprocess": {
        "model": "textsage", "d": TS_D, **PRE_FEATURES, "epochs": PRE_EPOCHS, **pre}}))
    log(json.dumps({"mesh": {
        "users": A20_USERS, "items": A20_ITEMS, "train_edges": A20_EDGES, "features": "informative",
        "d": {kind: case["over"].get("latent_dim", TS_D) for kind, case in MESH_CASES.items()},
        "cases": {kind: {**case["over"], **case["model_kw"], "epochs": case["epochs"]}
                  for kind, case in MESH_CASES.items()}, **mesh}}))
    log(json.dumps({"registry": {
        "card": smi, "users": A20_USERS, "items": A20_ITEMS, "train_edges": A20_EDGES, "features": "informative",
        "d": {key_label(name, over): key_config(name, **over).latent_dim * (2 if name in REG_ID_KEYS else 1)
              for name, over in REG_KEYS}, **reg}}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
