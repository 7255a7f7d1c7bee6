#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (graph_learn_tpu_torch).

Run from the repository root on a machine with one NVIDIA card (H100):

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from graph_learn_tpu_torch/csrc with nvcc, one
   process per source, all at once, and print the build time and the
   ptxas register report;
3. hold each kernel against its plain PyTorch version on the card, over
   dtypes, widths, ragged sizes and degrees (the GAT block: forward and
   every gradient, at small sizes on both routes of its products, at the
   training path's full first-layer size and at a deep reduction; the
   segment SpMM kernel also on ids and degrees out of range, which it
   clips itself, and with a raw max/min, on which a group max keeps inf,
   -inf and NaN as the JAX package does; the gather kernel bit for bit on
   both its routes, even and odd tables and a view; the sweep kernel with
   its prep's invariants; then each kernel called as its torch.library
   operator, torch.ops.glt.*, as an exported program calls it, Kernel 3's
   backward operator against the plain backward), and time kernel, plain
   version and, where one
   PyTorch call computes the same function, that call, at the main paths'
   shapes (the gather kernel at 1 024, 15 360 and 153 600 rows, the row
   counts the paths launch, with one kernel a call; the segment SpMM
   kernel's mean and, for EgoGIN, its sum), checking on a CUDA graph that
   captures one call that the gather and segment SpMM wrappers put one
   kernel on the card (the sweep wrapper: one kernel and one memset, each
   timed from torch.profiler's events); the GAT block also part by part
   (attention passes, each product on the tensor cores and on the f32 FMA
   route, the forward's also on mma.sync beside wgmma, the tail), and at
   EgoTGAT's three call shapes (depths 20 and 40, not multiples of the
   wgmma tile): forward and every gradient against its plain version, each
   product on every route against float64, forward and backward timed
   against the plain version and the bound;
4. run the serving path at the benchmark's width: the 200k-node / 3.2M-edge
   synthetic graph with bf16 features, the 2-hop EgoSAGE query installed on
   QueryService(micro_batch=1024), several client threads sending raw-id
   requests, and EgoGraphSAGE([128, 256, 32], agg "gcn") on every answer:
   the rows of the source and first hop gathered by the gather kernel, the
   deepest hop reduced by the segment SpMM kernel.  Sampled ids, features
   and logits are checked, and both kernels' launch counters must have
   moved during this phase;
5. show where one caller's request goes: the host wall of the request and
   of the forward, and the device time by kernel (torch.profiler);
6. run the training path on the same graph through LocalTrainer.train
   (shuffle source, batch 1024, Adam 1e-3): EgoGraphSAGE([128, 256, 32],
   "gcn") with the deepest hop pre-aggregated outside the gradient,
   EgoGIN([128, 256, 32]) with its deepest hop pre-summed (the segment
   SpMM kernel's sum), then
   EgoGAT([128, 256, 32], num_heads=[8, 1]) with every neighbour block on
   the GAT kernel, forward and backward, its products on the tensor cores
   and the first layer's forward products on wgmma (checked).  For each:
   one step's loss and gradients against the same step on the plain
   versions, every loss finite, parameters moved, launch counters as
   expected, edges/s and the device-busy share of a step;
7. answer a "full" sampling query (cap 32) on the same graph through
   QueryService and reduce its SparseNodes with the segment SpMM kernel on
   ragged degrees; check an edge_weight and a topk query for true
   neighbours (topk: the heaviest edges first);
8. run the sweep-aggregate harness (examples/sweep_aggregate.py) at its
   full shape, 2 457 600 x 128 f32 with 153 600 hits in groups of 10: bar,
   prep, stream, sweep and total, then the sweep and stream kernels, their
   plain versions and the library call on the same shape, the sweep's
   zero fill and kernel apart;
9. run the 62M-edge frontier path (examples/scale_demo.py) at the published
   sizes, 2 450 000 nodes, 62 000 000 edges, 100 bf16 features, batch 1024,
   fanout [15, 10], EgoGraphSAGE([100, 256, 47]), steps cut to 30 after 3
   of warm-up: host build seconds, bytes on the card, one step against the
   plain versions, step wall, edges/s, device-busy share and launches per
   step; the same run with conf.sorted_gather on (the deepest hop on the
   sweep kernel instead of the segment SpMM kernel), its first-step loss
   held to the unsorted run's, the two routes run in the order unsorted,
   sorted, sorted, unsorted because the host clock drifts; and the
   kernels' times at that table, warm (repeated calls on the same ids)
   and cold (the L2 flushed before each call);
10. answer ``.outV("rel").sample(15).by(s).filter("src")`` through
   QueryService on the 200k graph for random, topk, edge_weight and full,
   on every node that links to itself and 1 000 others: every id a true
   neighbour, and no hop-1 id equal to its seed in a row that holds
   another neighbour (without the filter the seeds do come back);
11. run the port bench (graph_learn_tpu_torch/bench.py run_bench) at
   bench.py's CFG on the same 200k graph (120 steps after 2 warm-up
   calls of K = 30) and at CFG_SCALE on the weighted 61.25M-edge graph it
   builds under the "minimal" profile (60 steps after 1 call of K = 20),
   each eager and then with the K steps in one captured CUDA graph: every
   step's loss bit-equal between the two, the same parameters after, two
   replays with other seeds and losses, 2 gather_rows and 1 segment_spmm
   per replayed step from torch.profiler (at CFG also a captured run
   under conf.sorted_gather: 2 gather_rows and 1 sweep_aggregate), step
   wall, edges/s, device-busy share, capture seconds, graph-pool bytes,
   host build seconds and peak bytes on the card;
12. run the bipartite u2i path (examples/family_scale.py's bipartite
   family) at its store's node counts and widths, with FAMILY_DEGREE
   (4) edges a node where CFG_SCALE has 25: 1 225 000 users and items
   with 100 bf16 features, 6 566 000 u-i and 3 234 000 i-i weighted
   edges on the "full" profile (host draw, CSR and candidate-pool build, upload and
   table bytes timed); one step of the two towers (EgoSAGEConv mean, 100 ->
   256, batch 1024, 10 neighbours, 2 negatives) on the kernels against the
   plain versions, with every hop gathered (6 gather_rows) and with the
   towers' hops deferred (3 gather_rows + 3 segment_spmm); the batch's
   random negatives in the u-i pool, and the true neighbours among
   soft_in_degree and in_degree negatives at the count neighbour_mass
   predicts; 10 steps of bipartite_sage through LocalTrainer.train (6
   gather_rows a step); the K-step form (K = 20) eager and captured: losses
   bit-equal, 3 gather_rows + 3 segment_spmm per replayed step, step wall,
   edges/s, device-busy share, capture seconds and graph pool;
13. run the rgcn family (examples/family_scale.py's rgcn family) at its
   store's node count and widths, FAMILY_DEGREE edges a node: 2 450 000
   items with 100 bf16 features and 47 classes, two weighted relations of
   4 900 000 edges each on the "minimal" profile
   (host draw, CSR build, upload and table bytes timed);
   EgoRGCN([100, 256, 47], num_relations=2, num_bases=1), batch 1024,
   fanout [10, 5] per relation: one step on the kernels against the plain
   versions with every hop gathered (7 gather_rows) and with the deepest
   level deferred (3 gather_rows + 4 segment_spmm), and the two routes'
   losses on the same batch; the K-step form (K = 20, 60 steps after one
   call) eager and captured on both routes, in the order deferred,
   gathered, gathered, deferred: losses bit-equal, the kernels per replayed
   step, step wall, edges/s, device-busy share, capture seconds, graph
   pool and peak bytes; 10 steps of the ego_rgcn example's loss through
   LocalTrainer.train (7 gather_rows a step); Kernel 1 at 10 240 and 51 200
   rows and Kernel 2 at [10 240, 5] means of the store's table, cold;
14. run the temporal family (examples/family_scale.py's temporal family)
   at its store's node count and widths, FAMILY_DEGREE edges a node:
   2 450 000 items with 100 bf16 features and 47 classes, 9 800 000
   weighted, timestamped edges on the "full" profile
   (host draw, CSR build, upload and table bytes timed);
   EgoGraphSAGE([100, 256, 47], "gcn") on E("rel").batch(1024) event
   seeds with two edge_weight hops [15, 10] strictly before the propagated
   time: the before-t bound of one batch checked on the card (every edge
   earlier than its bound, zero-admissible seeds filled with the default
   id and -1); one step on the kernels against the plain versions; the
   K-step form (K = 20) eager and captured: losses bit-equal, 2
   gather_rows + 1 segment_spmm per replayed step from the profiler, step
   wall, edges/s, device-busy share and the top device operations;
15. run the EgoTGAT link-prediction path (examples/ego_tgat.py) at its
   defaults: one step of the three towers on the kernels against the plain
   versions (15 gather_rows, 9 gat_block forwards and 9 backwards, every
   product on the tensor cores, the forwards on wgmma), LocalTrainer.train
   for 3 epochs with those launches per step, every loss finite, step wall,
   device-busy share and the test link-prediction accuracy;
16. (run inside phase 11, on its weighted 61.25M-edge "minimal" store,
   before that store is freed) run the walks family
   (examples/family_scale.py run_walks): deepwalk and node2vec (p 0.5,
   q 2), 1 024 walks of 20 a batch, K = 20 batches a call, eager and in
   one CUDA graph from the same generator seed: the walks bit-equal,
   transitions/s, ms a batch, device-busy share and kernels per replayed
   batch; one batch held on the host to the edge table's own arrays (every
   step an edge, column 0 the seeds, -1 only at a dead end and after it)
   and node2vec's return / neighbour-of-previous / other steps within a
   chi-square bound of their expectation; then a random_walk query's
   feature rows materialised once through its DeferredRows (one
   gather_rows launch, bit-equal to the plain version) and Kernel 1 timed
   cold at those 20 480 rows;
17. run the node2vec, UltraGCN and TGN examples at their defaults, each
   from the TSV files it writes (its store bit-equal to its in-memory twin
   of the same draws read back from their text; node2vec walks on the
   example's undirected store held to its edges and to their step shares
   first): the label coherence above 1/7, Recall@20 above that
   of random scores, the pairwise AUC above 0.5, and TGN's item features
   on Kernel 1, two launches a step;
18. (run inside phase 12, on its store, before that store is freed)
   categorical items and conditional negatives: the item table swapped for
   one with the same ids and 100 bf16 features plus a category (1 000
   values drawn with probability 1 / (rank + 1)), a brand string and 0-8
   tag strings hashed into 10 000 buckets (core/ingest.py _parse_attrs),
   each embedded 16 wide by the towers' item encoders (user tower in
   (100, 148), item tower (148, 148)); the bipartite query's two negatives
   drawn .where("dst", {"int_cols": [0], "int_props": [0.5]}), one by the
   positive's category and one free.  One batch: every conditioned
   negative in its positive's category, and the rows holding a true
   neighbour or the positive counted; the relaxation rule on 65 536 seed
   edges whose draws are aimed at their positives (each part's first
   acceptable candidate, the forced rows exactly those holding a rejected
   negative); the draws in the heaviest category against its in-run CDF
   (chi-square); one step on the kernels against the plain versions (6
   gather_rows, 0 segment_spmm; the embedding tables' gradients too); 10
   steps through LocalTrainer.train (every embedding table moves); the
   K-step form (K = 20) eager and in one CUDA graph, losses bit-equal, 6
   gather_rows per replayed step; Kernel 1 at each of the step's item-row
   counts (1 024, 2 048, 10 240 and 20 480 rows of the item table), cold,
   exact and against its bound, plain version and index_select;
19. SubGraph induction (ops/subgraph.py), in three parts.  (a) After
   phase 17, examples/seal.py at ogbl-collab's counts and widths: the
   planted-community link set drawn at 235 868 nodes with 128 f32
   features and 1 179 052 undirected train pairs, batch 64, 6 neighbours
   a side, BFS to depth 2, GCN([132, 32]) and LinkPredictor(32), one random
   negative a pair: one batch of 64 induced subgraphs held exactly to a
   numpy induction from the edge arrays (host_adjacency, induce_host:
   node sets, edges, edge ids, BFS distances); one step on Kernel 1
   against the same step on the plain version, loss and every gradient
   bit-equal; the K-step form (K = 20) eager and in one CUDA graph from the
   same state, losses bit-equal, with ms a step, subgraphs/s (2 x 64 a
   step), device busy, kernels a step and 2 gather_rows a step from the
   profiler; Kernel 1 cold at the step's 896 rows of the [235 868, 128]
   table against its bound, plain version and index_select; then the
   planted 400-node set of tests/test_real_datasets.py written as
   ogbl-collab tables, 150 steps through --collab_dir (the store
   bit-equal to its in-memory twin), hits@50 at least 0.6.  (b) Inside
   phase 11, on its weighted 61.25M-edge "minimal" store:
   V("item").batch(1024).SubGraph("rel", need_dist=True) with the
   default cap of 100, one answer held exactly to the host
   induction (the rows cut at the cap counted), its node rows materialised
   by one gather_rows launch bit-equal to the plain version, and the ms a
   query.  (c) examples/sage_unsupervised.py at its defaults (cora_like 800
   nodes from its TSV files, the store bit-equal to its in-memory twin;
   batch 128, 16 full neighbours, 32 wide, 2 epochs x 30 steps
   through LocalTrainer): every loss finite, 2 gather_rows a step (one per
   edge-star BatchGraph), link accuracy above 0.5;
20. file ingest, the pre-GSL sampler API and k-NN, after phase 19.  (a)
   The port bench's CFG store (200 000 items with 128 features at five
   decimals and labels, 3 200 000 weighted edges at nine significant
   digits, a train split of the first tenth of the ids) written as TSV,
   vectorised, into a temporary directory and loaded through
   Graph(device="cuda").node(...).node(..., mask=TRAIN).edge(...).init()
   on the native loader (csrc/ingest.cpp, built into
   graph_learn_tpu_torch/_build/; the phase fails on the Python parser's
   route): ids, labels, weights and both CSRs bit-equal to
   synthetic_graph's of the same seed, features within 5e-6 plus one
   float32 ulp, the first 10 000 lines of each file bit-equal on both
   parse routes; text bytes, write and per-table parse seconds, init and
   CSR seconds; then 10 LocalTrainer steps of the 2-hop EgoGraphSAGE query
   on V("item", mask=TRAIN): 2 gather_rows + 1 segment_spmm a step, step
   wall and device busy.  (b) On that store the sampler objects (batch
   1 024): node_sampler shuffle; neighbor_sampler [15, 10] for random,
   topk, edge_weight, in_degree and random_without_replacement, full with
   cap 16; edge_sampler; negative_sampler in_degree on the edge type and
   on the node type; subgraph_sampler (cap 100); random_walk_sampler (20,
   p 0.5, q 2): every draw held to the host's edge arrays (in_degree
   negatives: pick_negatives of their replayed candidate rounds, a true
   neighbour only where every round was one; the subgraph equal to the
   host induction; walks along edges), every answer's rows materialised by
   one gather_rows launch a hop, bit-equal to the plain version, and the
   ms a get().  (c) Graph.search at SIFT1M's counts and widths (1 000 000
   x 128 f32 drawn about 1 000 Gaussian centres, 10 000 queries that are
   base vectors plus 1% noise, k 100): flat L2 and inner product, ivfflat
   and ivfpq (nlist 4 096, nprobe 16; ivfpq m 4, ksub 64): flat L2 finds
   each query's own vector first for at least 99%; the first 256 queries
   of each index against one unchunked computation (ids where the k-th
   and (k+1)-th scores are more than 1e-3 apart, distances within 1e-4 of
   the row's largest); a search's peak device memory under 8 GB; train,
   add and search times, queries/s, device busy, and the IVF indexes'
   recall@10 / @100 against flat L2;
21. snapshots, the host tier, the BFS reorder, the TSV examples,
   checkpoints and the torch bridge.  (a) Inside phase 11, on its weighted
   61.25M-edge "minimal" store: Graph.save into a temporary directory and
   Graph.load memory-mapped; raw ids, labels, the f32 host features and
   the edges' src, dst and weights bit-equal; the restored store's CPU
   CSR and bf16 table bit-equal to the original's card views; bytes, save,
   load and CSR seconds beside the bench's build.  (b) On the restored
   store's CPU views, examples/host_tier_bench.py's shapes through
   LocalTrainer.train(..., tier="host"): EgoGraphSAGE [100, 256, 47]
   "gcn", batch 1 024, fanout [15, 10], Adam 1e-3, 20 steps of ``host``
   with a window of 1 and the default window and of ``host+agg`` (the
   deepest hop reduced on the CPU): losses finite, parameters moved,
   gather_rows and segment_spmm launched 0 times; ms a step, edges/s,
   device busy, bytes shipped a batch, H2D GB/s of one pinned batch, the
   share of a step the producer thread hides; a topk batch of the host
   tier bit-equal to the device tier's on the original store, a random
   one's hops true neighbours of the edge arrays and its rows the
   table's.  (c) After phase 19, core/reorder.py on the
   ogbl-collab-sized planted store: the raw-id adjacency, the features
   and a masked set unchanged, the mean neighbour index distance before
   and after, Kernel 1 cold over one 2-hop batch's 169 984 rows on each
   store against its bound, plain version and index_select.  (d) The TSV
   examples at their defaults, each from its files through
   Graph.node/edge/init: ego_sage_supervised (2 gather_rows + 1
   segment_spmm a step), ego_gat_supervised (3 gather_rows and 3
   gat_block each way), ego_rgcn_supervised (7 gather_rows; its store
   bit-equal to its in-memory twin), their test accuracies; ego_tgat's
   store from its files bit-equal to the in-memory one, 5 steps (15
   gather_rows, 9 gat_block each way) and its test accuracy.  (e) After
   the bench phase's CFG run, on the 200k graph: EgoGraphSAGE trained 5
   steps, saved with nn/checkpoint.py, restored into a fresh model and
   Adam, one more step from both bit-equal; torch_loader over the bench
   query for a whole epoch on the card and on the host tier (the first
   20 batches' tensors on the card or the CPU, the last cut to its rows);
22. the online tier on the card, after phase 20, at the bench store's
   width.  (a) The CFG store written as TSV again, served by
   online/serve_main.py serve(device="cuda") from those files with a
   2-partition FileTopic and its update pump (polled every 0.2 s); the
   2-hop [15, 10] random query installed over HTTP with the unchanged
   clients/py/gsl_client.py; 8 concurrent HTTP clients x 8 requests of
   1..4 ids (each JSON answer carries every alias's feature rows, about
   0.25 MB of text a seed): p50 / p99 / max ms and seeds/s.  (b) With the
   clients running again, 1 000 new nodes with features and then 2
   batches of 10 000 weighted edges streamed with StreamProducer: each
   ingest's apply_updates, host CSR and upload seconds, the staleness
   from put_edges to the first answer of a topk probe query that reaches
   the batch's heaviest edge, the p99 during the stream against the
   quiet one; the streamed store's flat CSR views bit-equal to an
   in-memory build from the original and the streamed rows in the
   pump's order, and every served hop1 id a true neighbour of the newest
   snapshot live during its request.  (c) The EgoGraphSAGE [128, 256,
   32] "gcn" serving function (sample + lookup + forward, batch 1 024)
   exported on the card with online/export.py: 2 glt::gather_rows and 1
   glt::segment_spmm in the program, installed by bytes through POST
   /admin/model, one /predict launching Kernel 1 twice and Kernel 2 once
   and equal to the forward run in the process on the same seed within
   1e-5, a JAX StableHLO artifact (tests/fixtures/jax_serving.stablehlo)
   refused; bytes, export and load seconds, /predict p50 / p99.  The same
   for an EgoGAT [128, 256, 32] with heads (8, 1) on that query and
   table (3 glt::gather_rows and 3 glt::gat_block: one /predict launches
   Kernel 3's forward 3 times), and for the EgoGraphSAGE exported under
   conf.sorted_gather (2 glt::gather_rows and 1 glt::sweep_aggregate:
   Kernel 4 once, Kernel 2 never).  (d) A
   ServingRouter over that worker and a second in-process worker on a
   replica of its store: a topk answer stitched over both owners equal to
   one worker's, an update fanned out to both and served by both;
23. the examples on the reference's file layouts, after phase 21d, f32.
   (a) The reference Cora configuration (tests/test_real_datasets.py:
   249-275) at full width: cora_like(2 708, 7 classes, 1 433 features)
   files through examples/ego_sage_supervised.py (fanout [25, 10], gcn,
   hidden 128, batch 140, Adam 0.05, dropout 0.5, 40 epochs): test
   accuracy at least 0.88, 2 gather_rows + 1 segment_spmm a step over the
   steps and the evaluated batches, ms a step; then one training batch's
   rows: Kernel 1 at its 140 src and 3 500 hop-1 rows of the [2 708,
   1 433] f32 table (rows of 5 732 bytes: the lane groups' 4-byte route)
   and Kernel 2 at its [3 500, 10] hop-2 means, each against its plain
   version, one kernel a call, cold against its bound, plain version and
   index_select / embedding_bag, with the route the kernel's name says.
   (b) Cora's raw layout: cora.content / cora.cites drawn at Cora's
   counts (2 708 papers with ids that are not contiguous, 5 429
   citations, 1 433 binary words, the 7 class names), through
   examples/data/cora.py prepare_cora and ego_sage_supervised.load_graph:
   ids, row-normalised features, the uniform cum_weights of the zero
   weights and the 140 / 300 / 1 000 splits held to the raw files; 2
   epochs, losses finite, launches as in (a).  (c) SEAL through
   --collab_dir at ogbl-collab's counts: seal.planted_collab(235 868,
   1 179 052, 60 084, 46 329, 100 000) 128 wide, written by
   examples/data/ogbl_collab.py write_collab_tables (bytes, seconds; in a
   child process started with phase 15, while the card runs phases
   15-21d), then
   seal.run for 150 steps of batch 64: the loaded store bit-equal to
   build_graph of the same draws, 2 gather_rows a step and 1 a scored
   batch, init / train / scoring seconds, hits@50 finite and above that
   of random scores on the same pairs.

24. the parallel store and training on torch.distributed, last, on the
   bench CFG store (200 000 nodes, 3.2M weighted edges, 128 bf16
   features; fan-out [15, 10], batch 1 024, EgoGraphSAGE [128, 256, 32]
   "gcn", Adam).  (a) DistTrainer at mesh (1, 1) on NCCL in this process
   (parallel/bootstrap.py init_cluster with a file store): 2 warm and 10
   timed steps, its mean loss LocalTrainer's on the same seeds within
   rtol 1e-5, step wall and edges/s, 2 gather_rows + 1 segment_spmm a
   step.  Then two gloo ranks that share the card (parallel/launch.py
   spawn; NCCL refuses two ranks on one device), each building the store
   itself: (b) mesh (1, 2), each rank placing only its block of the
   range-partitioned store: the ids and feature rows of three topk
   batches bit-equal to the one-rank plan's; DistTrainer partitioned
   (partition_above_bytes=0) in owner and then psum routing: step wall,
   payload bytes over the graph axis per step, gather_rows launches per
   step (> 0: the owners' row gathers), the device bytes each rank holds
   against one rank's whole store.  (c) Mesh (2, 1): DistTrainer
   data-parallel for 10 steps, 2 gather_rows + 1 segment_spmm a step on
   each rank, the parameters of both ranks bit-equal after them.  (d)
   ShardedGCN [256, 32] full-batch over mesh (1, 2): sharded_spmm's mean
   equal to a one-rank mean within rtol 1e-5, 5 steps with the loss
   falling, ms a step and the halo rows a rank receives.  (e)
   examples/routing_bytes.py's rank function on the same two ranks:
   bytes over the graph axis of the 1-hop plan, psum against owner.
   Times of the gloo ranks are of two processes sharing one card over
   gloo, not of NVLink collectives; every line says so.
25. partitioned serving and the sharded k-NN index, after phase 24, on
   two gloo ranks that share the card, each building the bench CFG store
   itself (bf16 features, the "minimal" profile).  (a)
   QueryService(graph_shards=2) at mesh (1, 2), rank 0 leading and rank
   1 following: the random 2-hop [15, 10] query at micro-batch 1 024, a
   fixed sequence of requests (1 to 2 047 ids) from one caller, ids and
   feature rows bit-equal to a one-rank QueryService on the same store
   (both generators seeded with conf.seed), request wall p50 / p99 after
   a warm request, gather_rows launches a round on each rank (> 0: the
   owners' row gathers), the device bytes each rank holds against one
   rank's whole store; then a topk query from ONLINE_CLIENTS concurrent
   callers, each answer the one-rank answer.  (b) Callers on a topk
   query while ONLINE_EDGE_BATCHES batches of ONLINE_EDGE_BATCH streamed
   edges (each with a heavy probe edge, as phase 22's) and a probe-only
   batch are applied and refreshed: every answer equal to the one-rank
   oracle of a snapshot live during it, each probe leading its source's
   topk after its refresh, each refresh's upload summed over the ranks
   against the first full upload (under it for the streamed batches,
   whose growth moves every edge-payload block; at most half of it for
   the probe-only batch).  (c) online/serve_main.py with "graph_shards":
   2 and "backend": "gloo" in a worker process from phase 22's TSV files
   (rank 0 starts rank 1): (a)'s first requests replayed over HTTP, ids
   equal to (a)'s and rows to the store's within the text's five
   decimals; SIGTERM ends both ranks.  (d) The sharded k-NN index at
   phase 20c's counts and widths (1 000 000 x 128 f32, 10 000 queries, k
   100): flat L2, flat inner product, ivfflat and ivfpq (nlist 4 096,
   nprobe 16), each trained once on rank 0 and sharded over the two
   ranks, the check queries' ids equal to the one-rank index and the
   distances within KNN_DIST_RTOL, ms per 10 000 queries.
26. the root measurement scripts (graph_learn_tpu_torch/examples/).  (a)
   Inside phase 11, on its weighted 61.25M-edge "minimal" store, at
   CFG_SCALE: gat_scale, EgoGAT [100, 256, 47] heads [8, 1] at chunk 256
   in its three variants (pre 0: the hop-2 rows gathered in the step; 1:
   gathered first by feature_gather; 2: the loss under
   torch.utils.checkpoint): each variant's first step on one batch from
   the same weights on the kernels against the plain versions and
   against pre 0, with its launches (3 gather_rows + 3 + 3 gat_block, 6 +
   6 + 3 under pre 2); each variant's K = 20 steps eager (two calls) and
   in one CUDA graph from the same state, the 40 losses within
   A4_CAPTURE_RTOL (Kernel 3's backward adds with atomics), the kernels
   a replayed and an eager step from the profiler as derived, ms a step,
   edges/s, device busy, capture seconds and graph pool; scale_matrix's
   float32 and bfloat16 runs on that one store, each record with its
   table's dtype and bytes and 2 gather_rows + 1 segment_spmm a replayed
   step; group_sweep at G 1, 4, 10 and 20, each with 2 K gather_rows and
   K / G segment_spmm a replayed call.  (b) After phase 11:
   gather_micro at its shapes (2 450 000 x 100, 153 600 draws in groups
   of 10), bf16 and f32: every variant's ms an iteration (K = 24 in one
   CUDA graph), max_abs_diff of the Kernel 4 mean within A4_MICRO_TOL,
   one sweep_aggregate (and its memset) in a call of the sorted route and
   one segment_spmm in a call of the unsorted route (a captured graph's
   nodes); segment_softmax_probe at its full shape (15 360 seeds, k2 10,
   D 128, 8 x 256, f32): bar, chunked and fused, fused and chunked within
   3e-3 of bar, and Kernel 3's forward alone on the probe's inputs
   against its plain version and its bound; host_overlap_probe on the
   bench CFG store: t_host, t_dev and t_loop for windows 1, 2 and 4, and
   Kernels 1-2 launched 0 times.

The last two lines of standard output are the card line and the JSON
object {"ok": true, "device": {...}}; the {"kernels": [...]} line comes
just before them (Kernels 1 and 2 carry the bipartite path's
``bipartite_launches_per_step``, per replayed K-step step, and
``bipartite_trainer_launches_per_step``, per LocalTrainer step, and the
rgcn path's ``rgcn_launches_per_step`` and ``rgcn_defer_launches_per_step``
per replayed K-step step on each route and
``rgcn_trainer_launches_per_step``, the temporal path's
``temporal_launches_per_step``; Kernel 1 also the EgoTGAT path's
``tgat_trainer_launches_per_step``, Kernel 3 its
``tgat_launches_per_step`` / ``tgat_bwd_launches_per_step``, the test
accuracy and its times at the EgoTGAT shapes, ``ms_tgat0a`` ... with
their bounds and plain times; Kernel 1 the walk query's ``walks_launches``
with ``cold_ms_62m_20480`` and its bound, plain and library times, and
the examples' ``tgn_launches_per_step``, ``node2vec_coherence``,
``ultra_gcn_recall_at_20`` and ``tgn_pairwise_auc``; Kernels 1 and 2
the categorical path's ``cond_launches_per_step`` and
``cond_trainer_launches_per_step``, and Kernel 1 its cold times at the
item rows, ``cold_ms_cond_1024`` / ``_2048`` / ``_10240`` / ``_20480`` with
``bound_ms_cond_*``, ``plain_cold_ms_cond_*``, ``library_cold_ms_cond_*``
and ``kernel_route_cond_*``; Kernel 1 phase 19's
``seal_launches_per_step`` (per replayed SEAL step), ``seal_hits_at_50``,
``cold_ms_seal_896`` with ``bound_ms_seal_896``,
``plain_cold_ms_seal_896``, ``library_cold_ms_seal_896`` and
``kernel_route_seal_896``, ``subgraph_query_launches`` and
``subgraph_query_ms``, ``sage_unsup_launches_per_step`` and
``sage_unsup_link_accuracy``; Kernels 1 and 2 phase 20's
``file_trainer_launches_per_step``, Kernel 1 also ``file_step_ms``,
``file_parse_s``, ``file_text_bytes``, ``sampler_api_launches`` and
``sampler_api_ms``; phase 21's ``host_tier_launches`` (0) on Kernels 1
and 2, Kernel 1's ``host_tier_ms_step``, ``host_agg_tier_ms_step``,
``host_tier_hidden_share``, ``host_tier_h2d_gb_per_s``, the snapshot's
``snapshot_bytes`` / ``_save_s`` / ``_load_s`` / ``_csr_s``, the
reorder's ``reorder_cold_ms_before`` / ``_after`` with their bounds,
plain and library times and mean neighbour distances, and the TSV
examples' ``tsv_*_launches_per_step`` and ``tsv_*_test_accuracy`` on
Kernels 1-3; phase 23's ``cora_ref_launches_per_step``,
``cora_ref_test_accuracy`` and ``cora_ref_ms_step`` on Kernels 1 and 2,
Kernel 1's ``cold_ms_cora_140`` / ``_3500`` and Kernel 2's
``cold_ms_cora_spmm``, each with its ``bound_ms_cora_*``,
``plain_cold_ms_cora_*``, ``library_cold_ms_cora_*`` and
``kernel_route_cora_*``, and Kernel 1's ``collab_files_hits_at_50`` and
``collab_files_launches_per_step``; phase 24's ``parallel_*`` fields on
Kernels 1-2: launches a step at mesh (1, 1) on NCCL, in each routing of
the partitioned step and data-parallel, the steps' ms (``*_shared_card``
for the two gloo ranks), the bytes over the graph axis a step, and the
launches a ``sharded_spmm`` of the full-graph GCN (0: plain torch);
phase 25's ``pserve_launches_per_round`` on Kernels 1-2 and
``pserve_follower_launches_per_round`` on Kernel 1; phase 26's
``a4_gat_launches_per_step_pre*`` on Kernels 1 and 3 (with
``a4_gat_bwd_launches_per_step_pre*``, ``a4_gat_ms_step_pre*``,
``a4_gat_edges_per_s_pre*`` and ``a4_gat_busy_share_pre*`` on Kernel 3),
``a4_scale_matrix_launches_per_step_{f32,bf16}``,
``a4_group_sweep_launches_per_call_G*`` and
``a4_group_sweep_first_loss_off`` on Kernels 1-2 (with
``a4_group_sweep_max_abs_err``, Kernel 2 at the widths' shapes, on
Kernel 2), ``a4_host_overlap_launches`` (the counters' reading, checked
0) on Kernels 1-2, ``micro_*`` on Kernels 2 and 4
(``micro_launches_per_call_{bf16,f32}``, the launches a captured call of
the unsorted or sorted route put on the card, the routes' ms an
iteration and the wrappers' launches), and the probe's
``probe_bar_ms``, ``probe_chunked_ms``, ``probe_fused_ms``,
``probe_fused_over_bar`` and Kernel 3's forward alone,
``probe_kernel_ms`` with its bound and plain time, on Kernel 3).
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the f32 rate
# outside the tensor cores and the tensor cores' dense TF32 rate, for the
# kernels' least possible time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12

# Benchmark configuration of the serving path (bench.py CFG).
N_NODES, AVG_DEGREE, FEAT_DIM, HIDDEN, CLASSES = 200_000, 16, 128, 256, 32
FANOUT = (15, 10)
MICRO_BATCH = 1024
N_CLIENTS, REQUESTS_PER_CLIENT = 8, 16
# Training: steps per measured run (SAGE: two epochs of 20) and Adam's rate
SAGE_EPOCHS, SAGE_STEPS, GAT_STEPS, LEARNING_RATE = 2, 20, 10, 1e-3
GIN_STEPS = 20
GAT_HEADS = (8, 1)


_T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    """``msg`` with the seconds since the smoke started (phase times are
    the differences)."""
    print("[chip_smoke %.1f s] %s" % (time.perf_counter() - _T0, msg),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5, hold=False) -> float:
    """Mean card time of one call (utils/timing.py time_ms: with ``hold``
    the stream spins while the host queues the calls)."""
    from graph_learn_tpu_torch.utils import timing
    return timing.time_ms(fn, iters=iters, warmup=warmup, hold=hold, log=log)


def time_cold_ms(fn, iters=20) -> float:
    """Median device time of one call after an L2 flush (utils/timing.py)."""
    from graph_learn_tpu_torch.utils import timing
    return timing.time_cold_ms(fn, iters=iters)


def bound(n_bytes: float, n_ops: float, n_tensor_ops: float = 0.0):
    """Least ms for the work: bytes over the memory rate, or the f32
    operations over the CUDA cores' peak plus the matrix-product operations
    (counted once, whatever passes a kernel makes) over the TF32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_ops / PEAK_F32_OPS_PER_S
             + n_tensor_ops / PEAK_TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# seconds a profiled window waits after its work before it closes, when
# it is profiled again: CUPTI hands kernel records over asynchronously,
# and windows of a few short kernels closed at once have lost them
PROFILER_SETTLE_S = 0.2
# seconds a counted window waits before its work and after it: the
# profiler keeps a kernel only where the card's timestamp, moved onto the
# host's clock, falls inside the window, and that move has put kernels
# before their own launch, dropping the first kernels of a short window
PROFILER_EDGE_S = 0.1


def _cu(rc, what):
    check(rc == 0, "%s: CUresult %d" % (what, rc))


def _kernel_node_name(lib, node):
    """The name of a kernel node's function (mangled, as the module holds
    it): CUDA_KERNEL_NODE_PARAMS_v2 holds the CUfunction at byte 0 and,
    where the launch named a CUkernel instead, that at byte 56."""
    import ctypes
    params = (ctypes.c_byte * 128)()
    _cu(lib.cuGraphKernelNodeGetParams_v2(node, params),
        "cuGraphKernelNodeGetParams")
    func = ctypes.c_void_p.from_buffer(params, 0).value
    kern = ctypes.c_void_p.from_buffer(params, 56).value
    name = ctypes.c_char_p()
    if func:
        _cu(lib.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)),
            "cuFuncGetName")
    else:
        _cu(lib.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)),
            "cuKernelGetName")
    return name.value.decode()


def kernel_label(name):
    """The qualified name in a mangled kernel name (``_ZN2at6native6fooE``
    -> ``at::native::foo``; a file's anonymous namespace left out); any
    other name as it is."""
    parts, i = [], 3 if name.startswith("_ZN") else 2
    if not name.startswith("_Z"):
        return name
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        n = int(name[i:j])
        parts.append(name[j:j + n])
        i = j + n
        if not name.startswith("_ZN"):
            break
    parts = [p for p in parts if not p.startswith("_GLOBAL__N")]
    return "::".join(parts) or name


def captured_work(torch, fn):
    """{name: count} of the work one call of ``fn`` puts on the card, read
    from the nodes of a CUDA graph that captures the call: kernels by
    their (mangled) names, memsets as "Memset (Device)", copies as
    "Memcpy".  Exact where torch.profiler's records come and go (a window
    of a few short kernels has lost some or all of them).  The call must
    be capturable: the current stream only, no host read."""
    import ctypes
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        fn()
    lib = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    work = {}
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        _cu(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        name = {0: None, 1: "Memcpy", 2: "Memset (Device)"}.get(
            kind.value, "graph node of type %d" % kind.value)
        name = name or _kernel_node_name(lib, node)
        work[name] = work.get(name, 0) + 1
    g.reset()
    return work


def profiled_work(torch, fn, calls, settle=0.0):
    """[(start, name, us)] of the work on the card (kernels and memsets,
    whoever launches them) in the second of two windows of ``calls`` calls
    of ``fn`` under torch.profiler (the first warms the profiler up), in
    launch order; each window waits ``settle`` seconds after its work
    before it closes, and the counted one ``PROFILER_EDGE_S`` more, and as
    long before its work."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for counted in (False, True):
            if counted:
                time.sleep(PROFILER_EDGE_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            if settle or counted:
                time.sleep(settle + (PROFILER_EDGE_S if counted else 0.0))
            prof.step()
    return sorted((ev.time_range.start, ev.name,
                   ev.time_range.end - ev.time_range.start)
                  for ev in prof.events()
                  if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                      and not getattr(ev, "is_user_annotation", False)
                      and not ev.name.startswith("ProfilerStep")))


def device_work_per_call(torch, fn, calls=10, tries=5):
    """({name: count per call}, {name: mean device ms of one launch}) of the
    work ``fn`` puts on the card (kernels and memsets, whoever launches
    them), under torch.profiler: a first window of ``calls`` calls warms the
    profiler up, a second is counted.  A wrapper launches the same kernels
    at every call, so a counted window whose kernel counts are no whole
    multiples of ``calls``, or that holds no kernel at all, lost records
    (windows have recorded nothing, or one memset and no kernel): it is
    profiled again, up to ``tries`` times, each window then left to
    settle (``PROFILER_SETTLE_S``).  Memsets count as recorded (the
    profiler has dropped one in ten)."""
    for attempt in range(tries):
        counts, us = {}, {}
        for _, name, dur in profiled_work(
                torch, fn, calls, PROFILER_SETTLE_S if attempt else 0.0):
            counts[name] = counts.get(name, 0) + 1
            us[name] = us.get(name, 0.0) + dur
        kernels = {name: n for name, n in counts.items()
                   if not name.startswith("Memset")}
        if kernels and all(n % calls == 0 for n in kernels.values()):
            return ({name: n / calls for name, n in counts.items()},
                    {name: us[name] / n / 1e3 for name, n in counts.items()})
        log("torch.profiler recorded %s over %d calls; profiling again"
            % (counts, calls))
    check(False, "torch.profiler recorded no whole calls in %d windows: %s"
          % (tries, counts))


def device_ms_per_launch(torch, fn, kernel, parts, calls=10, tries=5):
    """{"kernel" or "memset": mean device ms of one launch} of ``kernel``
    and of the memsets among the work of ``calls`` calls of ``fn``, from
    torch.profiler's records (``profiled_work``).  A mean needs no whole
    window: a window that holds no record of one of ``parts`` is profiled
    again, up to ``tries`` times."""
    for attempt in range(tries):
        us = {}
        for _, name, dur in profiled_work(
                torch, fn, calls, PROFILER_SETTLE_S if attempt else 0.0):
            part = ("memset" if name.startswith("Memset") else
                    "kernel" if kernel in name else None)
            if part:
                us.setdefault(part, []).append(dur)
        if set(parts) <= set(us):
            return {part: sum(us[part]) / len(us[part]) / 1e3
                    for part in parts}
        log("torch.profiler recorded %s of %s over %d calls; profiling "
            "again" % ({p: len(d) for p, d in us.items()}, sorted(parts),
                       calls))
    check(False, "torch.profiler recorded no %s in %d windows"
          % (sorted(set(parts) - set(us)), tries))


def check_one_launch(torch, what, fn, kernel, allow_memset=False):
    """One call of ``fn`` puts exactly one ``kernel`` on the card, and at
    most one memset where ``allow_memset``: no clamp, cast or fill kernel
    beside it (``captured_work``).  Returns ({"kernel" or "memset": count
    per call}, {the same: mean device ms of one launch, from
    ``device_ms_per_launch``})."""
    work = captured_work(torch, fn)
    kernels = {n: c for n, c in work.items() if kernel in n}
    others = {n: c for n, c in work.items() if kernel not in n}
    memsets = {n: c for n, c in others.items() if n.startswith("Memset")}
    check(list(kernels.values()) == [1] and (
        others == {} or (allow_memset and others == memsets
                         and sum(memsets.values()) <= 1)),
          "%s: one call put %s on the card; want one %s%s" % (
              what, {kernel_label(n): c for n, c in work.items()}, kernel,
              " and at most one memset" if allow_memset else
              " and nothing else"))

    def part(n):
        return "memset" if n.startswith("Memset") else "kernel"
    work = {part(n): float(c) for n, c in work.items()}
    return work, device_ms_per_launch(torch, fn, kernel, work)


def check_bounds(rows):
    """No time on the kernels line reads under the least time it is held
    to: ``ms`` under ``bound_ms``, the backward, the harness bar, the
    cold call at the 62M table, Kernel 1's cold calls at the row counts
    the paths launch (``ms_1024`` under ``bound_ms_1024``,
    ``cold_ms_62m_15360`` under ``bound_ms_62m_15360``, ...) and Kernel
    2's cold sum (``ms_sum``), rgcn means (``cold_ms_rgcn``) and Cora means
    (``cold_ms_cora_spmm``), and Kernel 1 at the Cora rows
    (``cold_ms_cora_140``, ``cold_ms_cora_3500``).  The bounds
    count device-memory bytes, so the times held to them are those of
    calls whose rows come from device memory: cold where the rows fit the
    L2 (Kernels 1 and 2 at the 200k table), and the warm figures
    (``warm_ms``, ``ms_62m``) are not held.
    Raises SmokeFailure naming each time that reads under its bound."""
    pairs = (("ms", "bound_ms"), ("bwd_ms", "bwd_bound_ms"),
             ("bar_ms", "bar_bound_ms"), ("cold_ms_62m", "bound_ms_62m"),
             ("ms_sum", "bound_ms_sum"), ("cold_ms_rgcn", "bound_ms_rgcn"),
             ("reorder_cold_ms_before", "reorder_bound_ms_before"),
             ("reorder_cold_ms_after", "reorder_bound_ms_after"),
             ("cold_ms_cora_spmm", "bound_ms_cora_spmm"),
             ("probe_kernel_ms", "probe_kernel_bound_ms"))
    pairs += tuple(pair for m in (GATHER_PATH_ROWS + RGCN_GATHER_ROWS
                                  + WALK_GATHER_ROWS + CAT_GATHER_ROWS
                                  + SEAL_GATHER_ROWS)
                   for pair in (("ms_%d" % m, "bound_ms_%d" % m),
                                ("cold_ms_62m_%d" % m,
                                 "bound_ms_62m_%d" % m),
                                ("cold_ms_cond_%d" % m,
                                 "bound_ms_cond_%d" % m),
                                ("cold_ms_seal_%d" % m,
                                 "bound_ms_seal_%d" % m)))
    pairs += tuple(("cold_ms_cora_%d" % m, "bound_ms_cora_%d" % m)
                   for m in CORA_GATHER_ROWS)
    pairs += tuple(pair for label in GAT_TGAT_SHAPES
                   for pair in (("ms_" + label, "bound_ms_" + label),
                                ("bwd_ms_" + label, "bwd_bound_ms_" + label)))
    under = ["%s %s %.4f < %.4f" % (r["name"], t, r[t], r[b])
             for r in rows for t, b in pairs
             if t in r and b in r and r[t] < r[b]]
    check(not under, "times under their bound (a bound that counts too "
          "many bytes, or a time that does not cover the work): %s"
          % "; ".join(under))


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


GATHER_ROWS = (1, 31, 32, 33, 4097, 15_360, 153_600)


def check_gather(torch, gather):
    """Kernel 1 bit for bit against gather_rows_plain on every route it
    takes: D in {128, 100, 64, 7}, bf16 and f32, ragged row counts, ids 0
    and N - 1 and repeated ids, on an even table, an odd one (a 200-byte
    row's 16-byte covering span runs past the last row) and a contiguous
    view ``base[1:]`` whose base lies one row into its storage (only 8-byte
    aligned at D = 100 bf16, 2-byte at D = 7 bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 100, 64, 7):
            base = torch.randn((20_002, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
            tables = (("even", base[:20_000].clone()),
                      ("odd", base[:20_001].clone()),
                      ("view base[1:]", base[1:]))
            for label, table in tables:
                n = table.shape[0]
                for m in GATHER_ROWS:
                    idx = torch.randint(0, n, (m,), generator=gen,
                                        device="cuda", dtype=torch.int32)
                    idx[0] = n - 1
                    idx[m // 2] = 0
                    idx[m // 3:m // 3 + min(m, 40) // 4] = n - 1  # repeats
                    out = gather.gather_rows(table, idx)
                    torch.cuda.synchronize()
                    check(torch.equal(out, gather.gather_rows_plain(table,
                                                                    idx)),
                          "gather_rows != plain (%s, D=%d, M=%d, %s table "
                          "of %d rows)" % (dtype, d, m, label, n))
                    cases += 1
    log("gather_rows: %d cases bit for bit against gather_rows_plain: "
        "bf16/f32, D in {128, 100, 64, 7}, M in %s, ids 0 and N-1 and "
        "repeated, even and odd tables and a view base[1:]"
        % (cases, list(GATHER_ROWS)))


# Kernel 1's row counts on the paths besides the 153 600-row GAT hop 2:
# src (1 024) and hop 1 (15 360) of every serving forward, SAGE step and
# 62M step
GATHER_PATH_ROWS = (1_024, 15_360)


def gather_kernels(torch, calls, where):
    """The kernel that each of ``calls`` (gather_rows calls) puts on the
    card, from a CUDA graph that captures the call (``captured_work``):
    each must put exactly one kernel named gather_rows on the card.  Its
    name says the route, ``bulk`` or the lane groups."""
    names = []
    for call in calls:
        work = captured_work(torch, call)
        check(list(work.values()) == [1] and "gather_rows" in "".join(work),
              "gather_rows %s: a call put %s on the card; want one "
              "gather_rows kernel a call"
              % (where, {kernel_label(n): c for n, c in work.items()}))
        names.extend(work)
    return names


def gather_shapes(torch, gather, table, gen, where, rows=GATHER_PATH_ROWS,
                  warm_rows=(), given=None, yardsticks=(), distinct=False):
    """Kernel 1 at ``rows`` random rows of ``table`` (the ids in ``given``
    [m] where it has them): exact against the plain version, one kernel a
    call (``gather_kernels``; its route, ``bulk`` or ``lanes``), the cold
    time (L2 flushed, stream held) and its bound (each row read once and
    written once, plus the ids); warm (50 calls on the same ids) where
    ``m`` is in ``warm_rows``; the plain version and ``index_select`` cold
    where it is in ``yardsticks``; with ``distinct`` the bound reads each
    distinct row once (a table that the L2 holds serves the repeats).
    Returns {m: fields}, the kernel's (mangled) name under ``kernel``."""
    n, d = table.shape
    ids = {}
    for m in rows:
        ids[m] = (given or {}).get(m)
        if ids[m] is None:
            ids[m] = torch.randint(0, n, (m,), generator=gen, device="cuda",
                                   dtype=torch.int32)
        check(torch.equal(gather.gather_rows(table, ids[m]),
                          gather.gather_rows_plain(table, ids[m])),
              "gather_rows %s, %d rows, differs from table[idx]" % (where, m))
    kernels = gather_kernels(torch, [
        (lambda i=ids[m]: gather.gather_rows(table, i)) for m in rows], where)
    res = {}
    for m, name in zip(rows, kernels):
        def call(i=ids[m]):
            return gather.gather_rows(table, i)
        reads = int(torch.unique(ids[m]).numel()) if distinct else m
        moved = (reads + m) * d * table.element_size() + 4 * m
        f = dict(ms=time_cold_ms(call), bound_ms=bound(moved, 0)[0],
                 route="bulk" if "bulk" in name else "lanes", kernel=name)
        if m in warm_rows:
            f["warm_ms"] = time_ms(call, hold=True)
        if m in yardsticks:
            f["plain_ms"] = time_cold_ms(
                lambda i=ids[m]: gather.gather_rows_plain(table, i))
            f["library_ms"] = time_cold_ms(
                lambda i=ids[m]: torch.index_select(table, 0, i))
        log("gather_rows %s, %d rows (%.3f MB moved): %.4f ms cold%s, bound "
            "%.4f (%.1f%%), one kernel a call on the %s route (%s)%s"
            % (where, m, moved / 1e6, f["ms"], ", %.4f warm" % f["warm_ms"]
               if "warm_ms" in f else "", f["bound_ms"],
               100 * f["bound_ms"] / f["ms"], f["route"], kernel_label(name),
               "; plain %.4f, index_select %.4f, both cold"
               % (f["plain_ms"], f["library_ms"]) if "plain_ms" in f
               else ""))
        res[m] = f
    return res


def check_spmm(torch, spmm):
    """Kernel 2 against segment_spmm_plain over dtypes, widths, aggregations
    and ragged degrees, then on ids and degrees out of range (negative, past
    the table, past cap), which the kernel clips itself, and on int64 ids
    and degrees, which the wrapper clips and casts."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, cap, n = 777, 10, 5_000
    worst = 0.0
    cases = 0
    for in_dtype in (torch.bfloat16, torch.float32):
        for out_dtype in (torch.float32, in_dtype):
            # f32 out: only the order of the f32 sums differs; bf16 out:
            # that difference may flip one bf16 rounding (2^-8 relative)
            rtol, atol = ((1e-5, 1e-5) if out_dtype == torch.float32
                          else (2 ** -7, 1e-5))
            for d in (128, 100):
                feats = torch.randn((n, d), generator=gen, device="cuda",
                                    dtype=torch.float32).to(in_dtype)
                ids = torch.randint(0, n, (b, cap), generator=gen,
                                    device="cuda", dtype=torch.int32)
                deg = torch.randint(0, cap + 1, (b,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                deg[:3] = torch.tensor([0, cap, 1], dtype=torch.int32)
                # out of range: negative ids, ids past the table, degrees
                # under 0 and over cap
                bad_ids = ids.clone()
                bad_ids[::7, 0] = -3
                bad_ids[1::7, cap - 1] = n + 17
                bad_ids[2::11, 3] = -(2 ** 31)
                bad_ids[3::11, 2] = 2 ** 31 - 1
                bad_deg = deg.clone()
                bad_deg[::5] = -4
                bad_deg[1::5] = cap + 6
                inputs = (("in range", ids, deg),
                          ("out of range", bad_ids, bad_deg),
                          ("int64", bad_ids.long(), bad_deg.long()))
                for agg in spmm.AGGS:
                    for label, i, dg in inputs:
                        out = spmm.segment_spmm(feats, i, dg, agg, out_dtype)
                        ref = spmm.segment_spmm_plain(
                            feats, *spmm.clip(i, dg, n), agg, out_dtype)
                        torch.cuda.synchronize()
                        check(out.dtype == out_dtype and out.shape == (b, d),
                              "segment_spmm dtype/shape")
                        ok = torch.allclose(out.float(), ref.float(),
                                            rtol=rtol, atol=atol)
                        err = (out.float() - ref.float()).abs().max().item()
                        check(ok, "segment_spmm %s %s->%s D=%d, ids and "
                              "degrees %s: max err %g"
                              % (agg, in_dtype, out_dtype, d, label, err))
                        worst = max(worst, err)
                        cases += 1
    log("segment_spmm: %d cases, sum/mean/max/min, bf16/f32 in, "
        "f32/in-dtype out, D in {128, 100}, degrees 0..cap, then ids < 0 and "
        ">= N and degrees < 0 and > cap (clipped by the kernel), and int64 "
        "ids and degrees, within tolerance of segment_spmm_plain on the "
        "clipped inputs (f32 out rtol=atol=1e-5; bf16 out rtol=2^-7, "
        "atol=1e-5); max abs err %g" % (cases, worst))


def same_values(torch, a, b):
    """Equal element by element, NaN where the other has NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_group_max(torch, gl, spmm):
    """A group max keeps inf, -inf and NaN (the JAX package's jnp.max and
    segment_max): gather_group_agg(max) on rows holding them against the
    plain ``table[idx].amax(1)``, with conf.sorted_gather off and on (each
    one Kernel 2 launch); then Kernel 2's raw max/min against
    segment_spmm_plain(raw_extrema=True) on ragged degrees, an empty row
    among them (-inf / +inf), and its pinned rule (0) beside it."""
    from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
    gen = torch.Generator(device="cuda").manual_seed(4)
    n, k, groups = 5_000, 10, 1_537
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 100):
            table = torch.randn((n, d), generator=gen, device="cuda",
                                dtype=torch.float32)
            table[::97, ::7] = float("inf")
            table[1::89, 3::5] = float("nan")
            table[2::83, 1::3] = float("-inf")
            table[7] = float("-inf")
            table = table.to(dtype)
            idx = torch.randint(0, n, (groups, k), generator=gen,
                                device="cuda", dtype=torch.int32)
            idx[0] = 7  # a group of -inf rows
            want = table[idx.long()].float().amax(1)
            check(bool(torch.isinf(want).any() and torch.isnan(want).any()),
                  "group max: the inputs hold no non-finite result")
            saved = (gl.conf.sorted_gather, gl.conf.sorted_gather_min_bytes)
            for sorted_on in (False, True):
                gl.conf.sorted_gather = sorted_on
                gl.conf.sorted_gather_min_bytes = 0
                before = spmm.LAUNCHES.count
                try:
                    out = gather_group_agg(table, idx, "max")
                finally:
                    gl.conf.sorted_gather, gl.conf.sorted_gather_min_bytes = \
                        saved
                torch.cuda.synchronize()
                check(spmm.LAUNCHES.count == before + 1
                      and same_values(torch, out, want),
                      "gather_group_agg(max) on non-finite rows, %s D=%d, "
                      "sorted_gather=%s: differs from table[idx].amax(1)"
                      % (dtype, d, sorted_on))
                cases += 1
            deg = torch.randint(0, k + 1, (groups,), generator=gen,
                                device="cuda", dtype=torch.int32)
            deg[:2] = torch.tensor([0, k], dtype=torch.int32)
            for agg in ("max", "min"):
                for raw in (True, False):
                    out = spmm.segment_spmm(table, idx, deg, agg,
                                            torch.float32, raw_extrema=raw)
                    ref = spmm.segment_spmm_plain(table, idx, deg, agg,
                                                  torch.float32, raw)
                    torch.cuda.synchronize()
                    check(same_values(torch, out, ref)
                          and (raw or bool(torch.isfinite(out).all())),
                          "segment_spmm %s raw_extrema=%s on non-finite "
                          "rows, %s D=%d: differs from the plain version"
                          % (agg, raw, dtype, d))
                    cases += 1
    log("group max: %d cases equal (NaN where NaN): gather_group_agg(max) "
        "on rows holding inf, -inf and NaN against table[idx].amax(1), "
        "sorted_gather off and on, one segment_spmm launch a call; "
        "segment_spmm max/min with raw_extrema on and off against the plain "
        "version on ragged degrees" % cases)


def sweep_case(torch, sweep, table, flat, k, R):
    """One Kernel 4 case: sweep_prep's hit list held to its invariants, then
    sweep_aggregate against sweep_aggregate_plain at rtol = atol = 1e-5 (k
    f32 terms a group, added in an order that changes from run to run);
    returns the max abs error."""
    n_rows, d = table.shape
    n = flat.shape[0]
    groups = n // k
    starts, packed = sweep.sweep_prep(flat, k, n_rows, R)
    n_slabs = -(-n_rows // R)
    check(starts.shape == (n_slabs + 1,) and packed.shape == (n,)
          and starts.dtype == packed.dtype == torch.int32,
          "sweep_prep shapes/dtypes")
    check(int(starts[0]) == 0 and int(starts[-1]) == n
          and bool((starts[1:] >= starts[:-1]).all()),
          "sweep_prep: starts do not run from 0 to N")
    rows, grp = sweep.unpack_hits(starts, packed, R)
    check(bool((rows[1:] >= rows[:-1]).all())
          and torch.equal(rows, flat.long().sort().values),
          "sweep_prep: the hits are not the sorted rows")
    check(torch.equal(grp.sort().values, torch.arange(n, device="cuda") // k),
          "sweep_prep: group ids")
    out = sweep.sweep_aggregate(starts, packed, table, groups, R)
    ref = sweep.sweep_aggregate_plain(starts, packed, table, groups, R)
    torch.cuda.synchronize()
    check(out.shape == (groups, d) and out.dtype == torch.float32,
          "sweep_aggregate shape/dtype")
    err = (out - ref).abs().max().item() if n else 0.0
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "sweep_aggregate %s D=%d R=%d N=%d over %d rows: max err %g"
          % (table.dtype, d, R, n, n_rows, err))
    return err


def check_sweep(torch, sweep):
    """Kernel 4 against sweep_aggregate_plain and Kernel 5 against
    stream_sum_plain and a float64 column sum, with sweep_prep's hit list
    held to its invariants."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    n_rows, k = 20_011, 10  # not a multiple of either slab size
    worst4 = worst5 = 0.0
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (128, 100, 7):
            table = torch.randn((n_rows, d), generator=gen, device="cuda",
                                dtype=torch.float32).to(dtype)
            for R in (4096, 1024):
                # all rows; a narrow range (many duplicate rows, most slabs
                # empty); no hit at all
                for n, hi in ((15_360, n_rows), (4_000, 300), (0, n_rows)):
                    flat = torch.randint(0, hi, (n,), generator=gen,
                                         device="cuda", dtype=torch.int32)
                    worst4 = max(worst4, sweep_case(torch, sweep, table,
                                                    flat, k, R))
                    cases += 1
            for rows_ in (n_rows, 1, 0):
                t = table[:rows_].contiguous()
                out = sweep.stream_sum(t)
                ref = sweep.stream_sum_plain(t)
                exact = t.sum(0, dtype=torch.float64)
                limit = 1e-6 * t.abs().sum(0, dtype=torch.float64)
                torch.cuda.synchronize()
                check(out.shape == (1, d) and out.dtype == torch.float32,
                      "stream_sum shape/dtype")
                err = (out[0].double() - exact).abs()
                # n_rows f32 terms in another order than any reference:
                # held to 1e-6 of the column's sum of magnitudes (f64 sum)
                check(bool((err <= limit).all()) and torch.allclose(
                    out, ref, rtol=1e-4, atol=1e-6 * float(
                        t.abs().sum(0).max()) if rows_ else 0.0),
                    "stream_sum %s D=%d rows=%d: max err %g"
                    % (dtype, d, rows_, err.max().item() if d else 0.0))
                worst5 = max(worst5, float(err.max()) if rows_ else 0.0)
    # A tall table in slabs of 16 with few hits: a chunk of 32 hits spans
    # hundreds of slabs, so its window of 32 slab starts moves on many
    # times and the first slab's search takes three steps.  Rows of more
    # than 32 vectors (D = 256 f32, 300 bf16: 64 and 75 vectors): a lane
    # steps over the chunk's (hit, vector) pairs by whole rows' worth of
    # vectors, not by hits.
    tall = 200_003
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 300),
                     (torch.bfloat16, 100), (torch.float32, 7)):
        table = torch.randn((tall, d), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
        for R, n, hi in ((16, 320, tall), (16, 4_000, tall),
                         (4096, 15_360, tall), (1024, 4_000, 300)):
            flat = torch.randint(0, hi, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            worst4 = max(worst4, sweep_case(torch, sweep, table, flat, k, R))
            cases += 1
        del table
    log("sweep_aggregate: %d cases within rtol=atol=1e-5 of "
        "sweep_aggregate_plain over bf16/f32, D in {128, 100, 7} at %d "
        "table rows with R in {4096, 1024}, duplicate rows, empty slabs, "
        "N=0; D in {256, 300, 100, 7} at %d rows with R in {16, 4096, 1024}, "
        "chunks of 32 hits over hundreds of slabs (max abs err %g); "
        "sweep_prep: starts[0]=0, starts[-1]=N, hits are the sorted rows; "
        "stream_sum: within 1e-6 of each column's sum of magnitudes of a "
        "float64 sum, rows in {%d, 1, 0} (max abs err %g)"
        % (cases, n_rows, tall, worst4, n_rows, worst5))


GAT_INPUTS = ("nbr", "wn", "ar", "el", "bn", "ba")
# gat_block against its plain version: both sum f32 products, in other
# orders (the kernel never forms nh, see csrc/gat.cu; its tensor-core
# products split every f32 operand into two TF32 numbers and sum three
# passes in f32), and the backward's sums across blocks use atomics.
# Errors are held relative to the largest reference value of each tensor:
# 2e-4 for f32, and 2^-7 for a bf16 d_nbr (one bf16 rounding of the f32 sum
# on either side).
GAT_TOL = 2e-4
GAT_TOL_BF16 = 2 ** -7


def gat_inputs(torch, gen, b, e, din, h, w, dtype, bias, drop, grad=True):
    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    t = dict(nbr=rand(b, e, din).to(dtype), wn=rand(h, din, w,
                                                    scale=din ** -0.5),
             ar=rand(h, w, scale=w ** -0.5), el=rand(h, b),
             bn=rand(h, w) if bias else None, ba=rand(h) if bias else None)
    if grad:
        for v in t.values():
            if v is not None:
                v.requires_grad_(True)
    t["drop"] = None
    if drop:
        keep = 0.7
        t["drop"] = (torch.rand((h, b, e), generator=gen, device="cuda")
                     < keep).float() / keep
    return t


def gat_compare(torch, gat, t, g):
    """(worst relative error, its name) of gat_block's output and of every
    input gradient against gat_block_plain on the same tensors."""
    args = [t[n] for n in GAT_INPUTS] + [t["drop"]]
    names = [n for n in GAT_INPUTS
             if t[n] is not None and t[n].requires_grad]
    leaves = [t[n] for n in names]
    out = gat.gat_block(*args)
    grads = torch.autograd.grad(out, leaves, g)
    ref = gat.gat_block_plain(*args)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == torch.float32,
          "gat_block shape/dtype")
    worst, abs_err = (0.0, "out"), 0.0
    pairs = [("out", out, ref)] + [("d_" + n, a, r) for n, a, r
                                   in zip(names, grads, ref_grads)]
    for name, got, want in pairs:
        check(got.shape == want.shape and got.dtype == want.dtype,
              "gat_block %s shape/dtype" % name)
        check(bool(torch.isfinite(got).all()), "gat_block %s not finite"
              % name)
        if got.numel() == 0:
            continue
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(1.0, want.float().abs().max().item())
        tol = GAT_TOL_BF16 if got.dtype == torch.bfloat16 else GAT_TOL
        check(rel <= tol, "gat_block %s: max abs err %g, %g of the largest "
              "reference value (limit %g)" % (name, err, rel, tol))
        if rel / tol > worst[0]:
            worst = (rel / tol, name)
        if name == "out":
            abs_err = err
    return worst, abs_err


# the training path's first-layer call at its full size, and a deep
# reduction for d_wn (depth b = 20 011, K' = 37 padded to 40): the split
# TF32 products held where the depth is real; f32 rows, (bias, drop) given
GAT_DEEP_CASES = (((15_360, 10, 128, 8, 256), False, False),
                  ((20_011, 2, 36, 2, 40), True, True))


def check_gat(torch, gat):
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the model's three calls at reduced b, then ragged and odd sizes
    shapes = [(777, 10, 128, 8, 256), (777, 15, 128, 8, 256),
              (777, 15, 256, 1, 32), (1, 1, 4, 3, 5), (777, 1, 100, 3, 5),
              (1, 15, 4, 1, 32), (33, 10, 100, 3, 5), (17, 4, 20, 9, 12),
              (0, 10, 128, 8, 256)]
    cases = [(shape, dtype, bias, drop) for shape in shapes
             for dtype in (torch.float32, torch.bfloat16)
             for bias, drop in ((False, False), (True, True))]
    cases += [(shape, torch.float32, bias, drop)
              for shape, bias, drop in GAT_DEEP_CASES]
    worst = (0.0, "")
    routes = {"tensor": 0, "fma": 0, "no launch": 0}
    wgmma_cases = 0
    for shape, dtype, bias, drop in cases:
        b, e, din, h, w = shape
        t = gat_inputs(torch, gen, b, e, din, h, w, dtype, bias, drop)
        g = torch.randn((h, b, w), generator=gen, device="cuda")
        before = {r: c.count for r, c in gat.ROUTE_LAUNCHES.items()}
        wgmma_before = gat.WGMMA_LAUNCHES.count
        try:
            (rel, name), _ = gat_compare(torch, gat, t, g)
        except SmokeFailure as err:
            raise SmokeFailure("%s at (b, e, Din, H, W)=%s %s bias=%s "
                               "drop=%s" % (err, shape, dtype, bias, drop))
        took = {r: c.count - before[r]
                for r, c in gat.ROUTE_LAUNCHES.items()}
        # forward and backward of one case take the same route, the one
        # the shape rule names; b = 0 launches nothing
        want = gat.product_route(w) if b else "no launch"
        check(took == {r: 2 * (r == want) for r in took},
              "gat_block at %s: route launches %s, the shape rule says %s"
              % (shape, took, want))
        routes[want] += 1
        # the forward's product ran on wgmma exactly where the depth rule
        # says so (K' = Din + 1 with a bias)
        on_wgmma = bool(b) and gat.forward_product_kernel(
            din + (1 if bias else 0), w) == "wgmma"
        check(gat.WGMMA_LAUNCHES.count - wgmma_before == int(on_wgmma),
              "gat_block at %s bias=%s: %d wgmma launches, the depth rule "
              "says %d" % (shape, bias, gat.WGMMA_LAUNCHES.count
                           - wgmma_before, on_wgmma))
        wgmma_cases += on_wgmma
        if rel > worst[0]:
            worst = (rel, "%s at %s %s" % (name, shape, dtype))
    check(routes["tensor"] > 0 and routes["fma"] > 0
          and 0 < wgmma_cases < routes["tensor"],
          "gat_block: a product route or kernel was never taken: %s, %d on "
          "wgmma" % (routes, wgmma_cases))
    log("gat_block: forward and every gradient (nbr, wn, ar, el, bn, ba) "
        "match gat_block_plain in %d cases: f32/bf16 nbr, bias and drop "
        "on/off, (b, e, Din, H, W) in %s, and f32 at %s; limits %g (f32) "
        "and 2^-7 (bf16 d_nbr) of each tensor's largest reference value; "
        "worst case %.3f of its limit (%s); product routes by case: %s; "
        "the forward's product on wgmma in %d of the tensor cases, on "
        "mma.sync in the rest"
        % (len(cases), shapes, [c[0] for c in GAT_DEEP_CASES], GAT_TOL,
           worst[0], worst[1], routes, wgmma_cases))


# Kernel 3 as phase 22's exported EgoGAT calls it: its first layer on the
# seeds and on hop 1, its second layer; and a ragged case with a bias and
# a dropout mask
OP_GAT_CASES = (((1024, 15, 128, 8, 256), False, False),
                ((15_360, 10, 128, 8, 256), False, False),
                ((1024, 15, 256, 1, 32), False, False),
                ((777, 10, 100, 3, 5), True, True))


def check_operators(torch, gather, spmm, gat, sweep):
    """Every kernel called as its torch.library operator
    (``torch.ops.glt.*``), as an exported program calls it, against its
    plain version: Kernel 1 bit for bit, Kernel 2 and 4 within
    rtol = atol = 1e-5, Kernel 5 within 1e-6 of the column's sum of
    magnitudes, Kernel 3's forward and backward operators within
    check_gat's limits."""
    ops = torch.ops.glt
    gen = torch.Generator(device="cuda").manual_seed(21)
    table = torch.randn((20_011, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    idx = torch.randint(0, 20_011, (1024,), generator=gen, device="cuda",
                        dtype=torch.int32)
    check(torch.equal(ops.gather_rows(table, idx),
                      gather.gather_rows_plain(table, idx)),
          "glt::gather_rows differs from gather_rows_plain")
    ids = torch.randint(0, 20_011, (1024, 10), generator=gen, device="cuda",
                        dtype=torch.int32)
    deg = torch.full((1024,), 10, dtype=torch.int32, device="cuda")
    got = ops.segment_spmm(table, ids, deg, "mean", torch.float32, False)
    want = spmm.segment_spmm_plain(table, *spmm.clip(ids, deg, 20_011),
                                   "mean", torch.float32)
    errs = {"segment_spmm": (got - want).abs().max().item()}
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          "glt::segment_spmm: max err %g" % errs["segment_spmm"])
    starts, packed = sweep.sweep_prep(ids.reshape(-1), 10, 20_011)
    got = ops.sweep_aggregate(starts, packed, table, 1024,
                              sweep.MAX_SLAB_ROWS)
    want = sweep.sweep_aggregate_plain(starts, packed, table, 1024,
                                       sweep.MAX_SLAB_ROWS)
    errs["sweep_aggregate"] = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          "glt::sweep_aggregate: max err %g" % errs["sweep_aggregate"])
    got = ops.stream_sum(table)
    err = (got[0].double() - table.sum(0, dtype=torch.float64)).abs()
    errs["stream_sum"] = err.max().item()
    check(bool((err <= 1e-6 * table.abs().sum(0, dtype=torch.float64))
               .all()), "glt::stream_sum: max err %g" % errs["stream_sum"])
    worst = (0.0, "")
    for (b, e, din, h, w), bias, drop in OP_GAT_CASES:
        t = gat_inputs(torch, gen, b, e, din, h, w, torch.float32, bias,
                       drop, grad=False)
        args = [t[n] for n in GAT_INPUTS] + [t["drop"]]
        g = torch.randn((h, b, w), generator=gen, device="cuda")
        out = ops.gat_block(*args)
        d_nbr, d_wn, d_ar, d_el = ops.gat_block_backward(g, *args, True)
        ref = [gat.gat_block_plain(*args)] + list(
            gat.gat_block_backward_plain(g, *args))
        got = [out, d_nbr, d_wn[:, :din], d_ar, d_el,
               d_wn[:, din] if bias else None]
        for name, a, r in zip(("out", "d_nbr", "d_wn", "d_ar", "d_el",
                               "d_bn"), got, ref):
            if r is None:
                continue
            rel = ((a - r).abs().max().item()
                   / max(1.0, r.abs().max().item()))
            check(a.shape == r.shape and rel <= GAT_TOL,
                  "glt::gat_block%s %s at %s: %g of the largest reference "
                  "value (limit %g)" % ("" if name == "out" else "_backward",
                                        name, (b, e, din, h, w), rel,
                                        GAT_TOL))
            if rel > worst[0]:
                worst = (rel, "%s at %s" % (name, (b, e, din, h, w)))
    log("torch.ops.glt: gather_rows bit-equal to its plain version, "
        "segment_spmm / sweep_aggregate / stream_sum max abs err %s, "
        "gat_block and gat_block_backward within %g of each tensor's "
        "largest plain value at %s (worst %g, %s)"
        % ({k: float("%.3g" % v) for k, v in errs.items()}, GAT_TOL,
           [c[0] for c in OP_GAT_CASES], worst[0], worst[1]))


def gat_work(b, e, din, h, w):
    """(bytes of the forward's f32 inputs, its f32 operations, its
    product's operations) at (b, e, Din, H, W): every input read once; the
    operations of the restructured block (csrc/gat.cu): the prep and two
    K-long dots per neighbour row and head (logit, weighted sum) on the
    CUDA cores, the [b, K] x [K, W] product per head on the tensor cores
    (counted once, whatever passes the kernel makes).  The output's
    ``4 * h * b * w`` bytes are the caller's to add."""
    io = 4 * (b * e * din + h * din * w + h * w + h * b)
    return io, 2 * h * din * w + 4 * h * b * e * din, 2 * h * b * din * w


def measure_gat(torch, gat):
    """Time gat_block, forward and backward, and its plain version at the
    training path's largest call: the first layer's deepest hop,
    (b, e, Din, H, W) = (15 360, 10, 128, 8, 256), f32 rows, no bias and no
    dropout, gradients for wn, ar and el (the rows there are features: no
    d_nbr), as the training phase calls it."""
    k1, k2 = FANOUT
    b, e, din, h, w = MICRO_BATCH * k1, k2, FEAT_DIM, GAT_HEADS[0], HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(5)
    t = gat_inputs(torch, gen, b, e, din, h, w, torch.float32, False, False)
    t["nbr"].requires_grad_(False)
    g = torch.randn((h, b, w), generator=gen, device="cuda")
    (rel, name), err = gat_compare(torch, gat, t, g)
    args = [t[n] for n in GAT_INPUTS] + [None]
    leaves = [t["wn"], t["ar"], t["el"]]
    out = gat.gat_block(*args)
    plain = gat.gat_block_plain(*args)

    def backward(o):
        return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)

    with torch.no_grad():
        ms = time_ms(lambda: gat.gat_block(*args), iters=20, hold=True)
        plain_ms = time_ms(lambda: gat.gat_block_plain(*args), iters=10,
                           warmup=2, hold=True)
        x2 = t["nbr"].reshape(b * e, din)
        proj_ms = time_ms(lambda: torch.einsum("nd,hdw->hnw", x2, t["wn"]),
                          iters=10, warmup=2, hold=True)
    bwd_ms = time_ms(backward(out), iters=20, hold=True)
    plain_bwd_ms = time_ms(backward(plain), iters=10, warmup=2, hold=True)
    k = din
    io, dots, product = gat_work(b, e, din, h, w)
    bound_ms, by = bound(io + 4 * h * b * w, dots, product)
    bound_f32_ms, _ = bound(io + 4 * h * b * w, dots + product)
    # backward: the forward's inputs and g read, d_wn, d_ar, d_el written;
    # the forward's attention again with two more dots per row and head
    # (d_q, d_v), and two products (d_a, d_wn)
    bwd_io = io + 4 * (h * b * w + h * din * w + h * w + h * b)
    bwd_dots = dots + 4 * h * b * e * k
    bwd_bound_ms, bwd_by = bound(bwd_io, bwd_dots, 2 * product)
    bwd_bound_f32_ms, _ = bound(bwd_io, bwd_dots + 2 * product)
    check(ms >= bound_ms and bwd_ms >= bwd_bound_ms,
          "gat_block ran under its bound: %g < %g or %g < %g ms"
          % (ms, bound_ms, bwd_ms, bwd_bound_ms))
    literal_ops = 2 * b * e * din * h * w
    row = dict(
        name="gat_block", route="cuda",
        source="graph_learn_tpu_torch/csrc/gat.cu",
        replaces="examples/segment_softmax_probe.py:36",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=by, library_ms=None, bound_f32_ms=bound_f32_ms,
        bwd_ms=bwd_ms, plain_bwd_ms=plain_bwd_ms, bwd_bound_ms=bwd_bound_ms,
        bwd_bound_by=bwd_by, bwd_bound_f32_ms=bwd_bound_f32_ms,
        product_route=gat.product_route(w),
        forward_product_kernel=gat.forward_product_kernel(k, w))
    check(row["product_route"] == "tensor"
          and row["forward_product_kernel"] == "wgmma",
          "gat_block at the training path's first-layer shape: products on "
          "the %s route, the forward's on %s"
          % (row["product_route"], row["forward_product_kernel"]))
    log("gat_block at (b, e, Din, H, W)=%s f32, products on the %s route "
        "(the forward's on wgmma, the backward's on mma.sync): "
        "forward %.4f ms (plain %.4f, bound %.4f by %s, %.1f%% of it; the "
        "all-f32 operations bound of the FMA route %.4f), backward for wn, "
        "ar, el %.4f ms (plain %.4f, bound %.4f by %s, %.1f%% of it; all-f32 "
        "%.4f); max abs err of the output %g, worst tensor %s at %.3f of its "
        "limit (%g of its largest reference value)"
        % ((b, e, din, h, w), row["product_route"], ms, plain_ms, bound_ms,
           by, 100 * bound_ms / ms, bound_f32_ms, bwd_ms, plain_bwd_ms,
           bwd_bound_ms, bwd_by, 100 * bwd_bound_ms / bwd_ms,
           bwd_bound_f32_ms, err, name, rel, GAT_TOL))
    log("gat_block reference points: no single PyTorch call computes it "
        "(library_ms null); the cuBLAS f32 projection einsum nbr . wn alone "
        "takes %.4f ms; the block taken literally is %.4g operations (%.4f "
        "ms at the f32 peak), the kernel's restructured form %.4g forward"
        % (proj_ms, literal_ops, literal_ops / PEAK_F32_OPS_PER_S * 1e3,
           dots + product))
    row["parts"] = gat_parts(torch, gat, t, g)
    return row


# "tensor" is the route the shape takes (product_out on wgmma where the
# depth allows), "mma" the same with every product on mma.sync
GAT_PART_ROUTES = {"product_out": ("tensor", "mma", "fma"),
                   "product_da": ("tensor", "fma"),
                   "product_dwn": ("tensor", "fma")}


def check_gat_products(torch, gat, t, g, where=""):
    """Run every kernel of one gat_block forward and backward on the inputs
    of ``t`` (GatParts), then each of the three products on each route
    against the float64 product of the same operands (the scratch ``a`` of
    the attention pass, g, wn), within GAT_TOL of its largest value.
    Returns (the GatParts, {part/route: error})."""
    k = t["wn"].shape[1]
    parts = gat.GatParts(t["nbr"], t["wn"], t["ar"], t["el"], g)
    for part in parts.PARTS:  # every scratch tensor written once
        parts.run(part)
    torch.cuda.synchronize()
    a64, g64 = parts.t["a"][..., :k].double(), g.double()
    wn64 = t["wn"].detach().double()
    exact = {"product_out": ("out", torch.einsum("hbk,hkw->hbw", a64, wn64)),
             "product_da": ("da", torch.einsum("hbw,hkw->hbk", g64, wn64)),
             "product_dwn": ("d_wn", torch.einsum("hbk,hbw->hkw", a64, g64))}
    errs = {}
    for part, (name, want) in exact.items():
        for route in GAT_PART_ROUTES[part]:
            parts.t[name].zero_()  # product_dwn adds into d_wn
            parts.run(part, route)
            got = parts.t[name][..., :want.shape[-1]].double()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            check(rel <= GAT_TOL, "gat_block %s on the %s route%s: %g of "
                  "the largest value off the float64 product (limit %g)"
                  % (part, route, where, rel, GAT_TOL))
            errs["%s/%s" % (part, route)] = rel
    return parts, errs


def gat_parts(torch, gat, t, g):
    """Time each kernel of one gat_block forward and backward at the shape
    of ``t`` (stream held): the attention passes against the bytes they
    must move, the three products on both routes against their operations
    (each first held to the float64 product of its operands), and the
    small kernels.  Returns {part: ms}."""
    b, e, din = t["nbr"].shape
    h, k, w = t["wn"].shape
    lda = gat.padded_depth(k)
    parts, errs = check_gat_products(torch, gat, t, g)
    for name, rel in errs.items():
        part, route = name.split("/")
        log("gat_block part %s on the %s route: %.3g of the largest "
            "value off the float64 product of the same operands "
            "(limit %g)" % (part, route, rel, GAT_TOL))
    routes = GAT_PART_ROUTES
    nbr_bytes = t["nbr"].numel() * t["nbr"].element_size()
    a_bytes = 4 * h * b * lda
    traffic = {"attn_fwd": nbr_bytes + a_bytes + 4 * h * b,
               "attn_bwd": nbr_bytes + 2 * a_bytes + 8 * h * b,
               "prep": 4 * (h * k * w + h * w + h * k),
               "tail": 4 * (3 * h * k * w + 2 * h * w + h * k)}
    ops = 2 * h * b * k * w
    out = {}
    for part in parts.PARTS:
        if part.startswith("product"):
            for route in routes[part]:
                ms = time_ms(lambda: parts.run(part, route), iters=20,
                             hold=True)
                out["%s_%s" % (part, route)] = ms
                log("gat_block part %s on the %s route: %.4f ms, %.2f "
                    "TFLOP/s of its %.4g operations"
                    % (part, route, ms, ops / ms / 1e9, ops))
        else:
            ms = time_ms(lambda: parts.run(part), iters=20, hold=True)
            out[part] = ms
            least = traffic[part] / PEAK_BYTES_PER_S * 1e3
            log("gat_block part %s: %.4f ms, %.3f TB/s of the %.4g bytes it "
                "must move (%.4f ms at the peak rate, %.1f%%)"
                % (part, ms, traffic[part] / ms / 1e9, traffic[part], least,
                   100 * least / ms))
    return out


# EgoTGAT's gat_block calls at the ego_tgat example's defaults, batch 128
# (b, e, Din, H, W): level 0 over hop 1 and over hop 2 (keys of feat 8 +
# edge feat 4 + time 8), level 1 (hidden 32 + time 8, out 16)
GAT_TGAT_SHAPES = {"tgat0a": (128, 8, 20, 2, 32),
                   "tgat0b": (1024, 4, 20, 2, 32),
                   "tgat1": (128, 8, 40, 2, 16)}


def measure_gat_tgat(torch, gat):
    """gat_block at each EgoTGAT shape (f32, no bias, no dropout, every
    input differentiated, d_nbr too: the keys carry the time encoder's
    gradient): forward and every gradient against gat_block_plain, each
    product on every route against float64, then forward and backward
    timed against the plain version and the bound.  Returns the kernels
    line's fields."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    row = {}
    for label, (b, e, din, h, w) in GAT_TGAT_SHAPES.items():
        t = gat_inputs(torch, gen, b, e, din, h, w, torch.float32, False,
                       False)
        g = torch.randn((h, b, w), generator=gen, device="cuda")
        before = gat.WGMMA_LAUNCHES.count
        (rel, name), err = gat_compare(torch, gat, t, g)
        check(gat.product_route(w) == "tensor"
              and gat.forward_product_kernel(din, w) == "wgmma"
              and gat.WGMMA_LAUNCHES.count - before == 1,
              "gat_block at %s: products not on the tensor cores, or the "
              "forward's not on wgmma" % label)
        _, errs = check_gat_products(torch, gat, t, g, " at %s" % label)
        args = [t[n] for n in GAT_INPUTS] + [None]
        leaves = [t[n] for n in ("nbr", "wn", "ar", "el")]
        out, plain = gat.gat_block(*args), gat.gat_block_plain(*args)

        def backward(o):
            return lambda: torch.autograd.grad(o, leaves, g,
                                               retain_graph=True)

        with torch.no_grad():
            ms = time_ms(lambda: gat.gat_block(*args), iters=50, hold=True)
            plain_ms = time_ms(lambda: gat.gat_block_plain(*args), iters=20,
                               hold=True)
        bwd_ms = time_ms(backward(out), iters=50, hold=True)
        plain_bwd_ms = time_ms(backward(plain), iters=20, hold=True)
        # as measure_gat counts it; the backward also writes d_nbr
        io = 4 * (b * e * din + h * din * w + h * w + h * b)
        dots = 2 * h * din * w + 4 * h * b * e * din
        product = 2 * h * b * din * w
        bound_ms, by = bound(io + 4 * h * b * w, dots, product)
        bwd_io = io + 4 * (h * b * w + h * din * w + h * w + h * b
                           + b * e * din)
        bwd_bound_ms, bwd_by = bound(bwd_io, dots + 4 * h * b * e * din,
                                     2 * product)
        row.update({"ms_" + label: ms, "bound_ms_" + label: bound_ms,
                    "plain_ms_" + label: plain_ms,
                    "bwd_ms_" + label: bwd_ms,
                    "bwd_bound_ms_" + label: bwd_bound_ms,
                    "plain_bwd_ms_" + label: plain_bwd_ms,
                    "max_abs_err_" + label: err})
        log("gat_block at the EgoTGAT shape %s (b, e, Din, H, W)=%s f32: "
            "forward and every gradient (d_nbr too) match gat_block_plain, "
            "worst %s at %.3f of its limit; products on the tensor route "
            "(forward on wgmma), mma.sync and f32 FMA against float64, "
            "worst %.3g (limit %g); forward %.4f ms (plain %.4f, bound %.4f "
            "by %s, %.1f%% of it), backward %.4f ms (plain %.4f, bound %.4f "
            "by %s, %.1f%%)"
            % (label, (b, e, din, h, w), name, rel, max(errs.values()),
               GAT_TOL, ms, plain_ms, bound_ms, by, 100 * bound_ms / ms,
               bwd_ms, plain_bwd_ms, bwd_bound_ms, bwd_by,
               100 * bwd_bound_ms / bwd_ms))
    return row


def spmm_work(torch, spmm, where, table, ids, deg):
    """The work one deepest-hop mean call puts on the card: one kernel,
    nothing else."""
    work, _ = check_one_launch(
        torch, "segment_spmm " + where, lambda: spmm.segment_spmm(
            table, ids, deg, "mean", torch.float32), "segment_spmm_kernel")
    log("segment_spmm %s: one call puts %s on the card" % (where, work))
    return {"work_per_call": work}


def spmm_shape(torch, spmm, table, ids, op, where, distinct=False):
    """Kernel 2 at one shape, ids [G, k] of ``table`` reduced with ``op``
    into f32: against the plain version (rtol = atol = 1e-5: f32 sums in
    other orders), cold (L2 flushed) with its bound (each row read once,
    the ids and degrees, the f32 output written once; with ``distinct``
    each distinct row once, where the L2 holds the table), and the plain
    version and ``embedding_bag`` cold."""
    import torch.nn.functional as F
    g, k = ids.shape
    d = table.shape[1]
    deg = torch.full((g,), k, dtype=torch.int32, device="cuda")
    out = spmm.segment_spmm(table, ids, deg, op, torch.float32)
    ref = spmm.segment_spmm_plain(table, ids, deg, op, torch.float32)
    err = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "segment_spmm %s, [%d, %d] %s: max err %g" % (where, g, k, op, err))
    nnz = g * k
    reads = int(torch.unique(ids).numel()) if distinct else nnz
    b, by = bound(reads * d * table.element_size() + nnz * 4 + g * 4
                  + g * d * 4, nnz * d + (g * d if op == "mean" else 0))
    f = dict(
        ms=time_cold_ms(lambda: spmm.segment_spmm(table, ids, deg, op,
                                                  torch.float32)),
        bound_ms=b, bound_by=by, max_abs_err=err,
        plain_ms=time_cold_ms(lambda: spmm.segment_spmm_plain(
            table, ids, deg, op, torch.float32)),
        library_ms=time_cold_ms(lambda: F.embedding_bag(ids, table,
                                                        mode=op)))
    log("segment_spmm %s, [%d, %d] %s: %.4f ms cold, bound %.4f by %s "
        "(%.1f%%); plain %.4f, embedding_bag %.4f, both cold; max abs err %g"
        % (where, g, k, op, f["ms"], b, by, 100 * b / f["ms"], f["plain_ms"],
           f["library_ms"], err))
    return f


def measure_kernels(torch, gather, spmm):
    """Time each kernel, its plain version and one library call at the
    serving path's deepest-hop shapes.  The 51 MB table lies largely in the
    50 MB L2 across repeated calls on the same ids, and the bound counts
    device-memory bytes: so ``ms``, ``plain_ms`` and ``library_ms`` are
    cold (the L2 flushed before each call, the stream held while the host
    queues it) and
    ``warm_ms`` is the kernel's mean over back-to-back calls."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn((N_NODES, FEAT_DIM), generator=gen, device="cuda",
                        dtype=torch.float32).to(torch.bfloat16)
    k1, k2 = FANOUT
    m = MICRO_BATCH * k1 * k2
    idx = torch.randint(0, N_NODES, (m,), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = gather.gather_rows(table, idx)
    g_err = (out.float() - gather.gather_rows_plain(table, idx).float()
             ).abs().max().item()
    check(g_err == 0, "gather_rows at the serving shape: max err %g" % g_err)
    shapes = gather_shapes(torch, gather, table, gen, "at the 200k table",
                           rows=GATHER_PATH_ROWS + (m,), warm_rows=(m,),
                           given={m: idx}, yardsticks=GATHER_PATH_ROWS)
    rows = {
        "gather_rows": dict(
            name="gather_rows", route="cuda",
            source="graph_learn_tpu_torch/csrc/gather.cu",
            replaces="graph_learn_tpu/ops/pallas/gather.py:64",
            max_abs_err=g_err, ms=shapes[m]["ms"],
            plain_ms=time_cold_ms(lambda: gather.gather_rows_plain(table,
                                                                   idx)),
            bound_ms=shapes[m]["bound_ms"], bound_by="bytes",
            library_ms=time_cold_ms(lambda: torch.index_select(table, 0,
                                                               idx)),
            warm_ms=shapes[m]["warm_ms"], kernel_route=shapes[m]["route"]),
    }
    for rows_m in GATHER_PATH_ROWS:
        f = shapes[rows_m]
        rows["gather_rows"].update({
            "ms_%d" % rows_m: f["ms"], "bound_ms_%d" % rows_m: f["bound_ms"],
            "plain_ms_%d" % rows_m: f["plain_ms"],
            "library_ms_%d" % rows_m: f["library_ms"],
            "kernel_route_%d" % rows_m: f["route"]})
    ids = idx[:MICRO_BATCH * k1 * k2].reshape(MICRO_BATCH * k1, k2)
    deg = torch.full((ids.shape[0],), k2, dtype=torch.int32, device="cuda")
    out = spmm.segment_spmm(table, ids, deg, "mean", torch.float32)
    ref = spmm.segment_spmm_plain(table, ids, deg, "mean", torch.float32)
    s_err = (out - ref).abs().max().item()
    # f32 accumulation on both sides; only the order of the sums differs
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "segment_spmm at the serving shape: max err %g" % s_err)
    nnz = int(deg.sum().item())
    s_bytes = (nnz * FEAT_DIM * table.element_size() + ids.numel() * 4
               + deg.numel() * 4 + ids.shape[0] * FEAT_DIM * 4)
    s_bound, s_by = bound(s_bytes, nnz * FEAT_DIM + ids.shape[0] * FEAT_DIM)
    rows["segment_spmm"] = dict(
        name="segment_spmm", route="cuda",
        source="graph_learn_tpu_torch/csrc/spmm.cu",
        replaces="graph_learn_tpu/ops/pallas/spmm.py:76",
        max_abs_err=s_err,
        ms=time_cold_ms(lambda: spmm.segment_spmm(table, ids, deg, "mean",
                                                  torch.float32)),
        plain_ms=time_cold_ms(lambda: spmm.segment_spmm_plain(
            table, ids, deg, "mean", torch.float32)),
        bound_ms=s_bound, bound_by=s_by,
        library_ms=time_cold_ms(lambda: F.embedding_bag(ids, table,
                                                        mode="mean")),
        warm_ms=time_ms(lambda: spmm.segment_spmm(
            table, ids, deg, "mean", torch.float32), hold=True))
    rows["segment_spmm"].update(spmm_work(
        torch, spmm, "at the serving shape", table, ids, deg))
    # EgoGIN's deepest hop: the same [15 360, 10] ids summed
    f = spmm_shape(torch, spmm, table, ids, "sum", "at the 200k table")
    rows["segment_spmm"].update(
        ms_sum=f["ms"], bound_ms_sum=f["bound_ms"], plain_ms_sum=f["plain_ms"],
        library_ms_sum=f["library_ms"])
    for r in rows.values():
        log("%s at the serving shape: %.4f ms cold L2, %.4f ms warm L2 "
            "(plain %.4f, library %.4f, both cold; bound %.4f by %s, %.1f%% "
            "of the cold call), max abs err %g (held: gather exact, spmm "
            "rtol=atol=1e-5)"
            % (r["name"], r["ms"], r["warm_ms"], r["plain_ms"],
               r["library_ms"], r["bound_ms"], r["bound_by"],
               100 * r["bound_ms"] / r["ms"], r["max_abs_err"]))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the serving path at the benchmark's width
# ---------------------------------------------------------------------------


def two_hop_query(g, shuffle=False):
    k1, k2 = FANOUT
    src = g.V("item").batch(MICRO_BATCH)
    if shuffle:
        src = src.shuffle(traverse=True)
    return (src.alias("src")
            .outV("rel").sample(k1).by("random").alias("hop1")
            .outV("rel").sample(k2).by("random").alias("hop2").values())


def serving_path(torch, card, g, dec, gather, spmm):
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.core.values import DeferredRows
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    k1, k2 = FANOUT
    t0 = time.perf_counter()
    q = two_hop_query(g)
    svc = gl.QueryService(g, device="cuda")
    qid = svc.install(q, micro_batch=MICRO_BATCH)
    table = q.device_tables()["nodes"]["item"].float_attrs
    model = EgoGraphSAGE([FEAT_DIM, HIDDEN, CLASSES], dec, agg_type="gcn",
                         device="cuda")
    log("query installed, tables (%d nodes, %d edges) on the card in %.1f s"
        % (N_NODES, N_NODES * AVG_DEGREE, time.perf_counter() - t0))

    def forward(ans):
        ego = EgoGraph.from_query_result(ans, "src", ["hop1", "hop2"],
                                         defer_last_table=table)
        with torch.no_grad():
            return model(ego)

    forward(svc.run(qid, np.arange(MICRO_BATCH)))  # warm-up, not counted
    torch.cuda.synchronize()

    rng = np.random.default_rng(1)
    requests = [[rng.integers(0, N_NODES, int(rng.integers(1, 2 * MICRO_BATCH)))
                 for _ in range(REQUESTS_PER_CLIENT)]
                for _ in range(N_CLIENTS)]
    answers = [[None] * REQUESTS_PER_CLIENT for _ in range(N_CLIENTS)]
    latency_ms = [[0.0] * REQUESTS_PER_CLIENT for _ in range(N_CLIENTS)]
    errors = []

    def client(c):
        try:
            for r, ids in enumerate(requests[c]):
                t0 = time.perf_counter()
                ans = svc.run(qid, ids)
                latency_ms[c][r] = (time.perf_counter() - t0) * 1e3
                answers[c][r] = (ids, ans, forward(ans))
        except Exception as e:  # reported below; fails the run
            errors.append(e)

    gather.LAUNCHES.reset()
    spmm.LAUNCHES.reset()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather_rows": gather.LAUNCHES.count,
                "segment_spmm": spmm.LAUNCHES.count}
    check(not any(t.is_alive() for t in threads), "client threads hung")
    if errors:
        raise errors[0]
    lat = np.asarray(latency_ms).reshape(-1)
    seeds = sum(ids.size for reqs in requests for ids in reqs)
    log("served %d requests (%d seeds) from %d client threads in %.3f s, "
        "each answered and run through the forward; svc.run latency on the "
        "callers' clock: p50 %.3f ms, p99 %.3f ms, max %.3f ms; %.1f seeds/s "
        "over the clients' wall (card: %s)"
        % (lat.size, seeds, N_CLIENTS, wall, np.percentile(lat, 50),
           np.percentile(lat, 99), lat.max(), seeds / wall, card))
    log("launches during the serving phase: %s" % launches)
    check(launches["gather_rows"] > 0, "gather_rows was never launched")
    check(launches["segment_spmm"] > 0, "segment_spmm was never launched")

    # --- correctness of every answer ----------------------------------
    et = g.store.edge_table("rel")
    keys = np.unique(et.src * N_NODES + et.dst)
    out_deg = et.out_degrees
    default = gl.conf.default_neighbor_id

    def true_neighbours(parents, nbrs):
        p = np.repeat(parents.reshape(-1).astype(np.int64), nbrs.shape[-1])
        n = nbrs.reshape(-1).astype(np.int64)
        pos = np.clip(np.searchsorted(keys, p * N_NODES + n), 0,
                      keys.size - 1)
        hit = keys[pos] == p * N_NODES + n
        empty = out_deg[p] == 0
        return bool(np.all(np.where(empty, n == default, hit)))

    worst = 0.0
    for c in range(N_CLIENTS):
        for ids, ans, logits in answers[c]:
            n = ids.size
            src = ans["src"].ids.cpu().numpy()
            h1 = ans["hop1"].ids.cpu().numpy()
            h2 = ans["hop2"].ids.cpu().numpy()
            check(src.shape == (n,) and h1.shape == (n, k1)
                  and h2.shape == (n, k1, k2), "answer shapes")
            check(np.array_equal(src, ids), "src ids != requested ids")
            check(true_neighbours(src, h1), "hop1 holds a non-neighbour")
            check(true_neighbours(h1, h2), "hop2 holds a non-neighbour")
            plain = []
            for alias in ("src", "hop1", "hop2"):
                nodes = ans[alias]
                rows = table[nodes.ids.long()]
                check(isinstance(nodes.float_attrs, DeferredRows)
                      and torch.equal(nodes.float_attrs.materialize(), rows),
                      "%s features != table[ids]" % alias)
                plain.append(nodes.replace(float_attrs=rows))
            # the same forward on the plain versions: every hop's rows
            # gathered by plain indexing, the deepest reduced by the conv
            with torch.no_grad():
                ref = model(EgoGraph(src=plain[0], hops=plain[1:],
                                     nbr_nums=FANOUT))
            check(logits.shape == (n, CLASSES)
                  and bool(torch.isfinite(logits).all()), "logits")
            err = (logits - ref).abs().max().item()
            # f32 throughout; only the order of the deepest-hop sums differs
            check(torch.allclose(logits, ref, rtol=1e-4, atol=1e-4),
                  "logits differ from the plain forward: %g" % err)
            worst = max(worst, err)
    log("every sampled id is a neighbour, features equal table[ids], logits "
        "match the plain forward within rtol=atol=1e-4 (max abs err %g)"
        % worst)

    # --- forward rate on full micro-batches ---------------------------
    full = svc.run(qid, np.arange(MICRO_BATCH))
    t_fwd = time_ms(lambda: forward(full), iters=20, warmup=3)
    # a forward is a few dozen launches: 10 held calls stay well inside
    # the launch queue
    t_dev = time_ms(lambda: forward(full), iters=10, warmup=3, hold=True)
    edges = MICRO_BATCH * (k1 + k1 * k2)
    log("EgoGraphSAGE forward on a %d-seed answer, back to back: %.4f ms, "
        "%.4g edges/s; on the card alone %.4f ms, %.4g edges/s (card: %s)"
        % (MICRO_BATCH, t_fwd, edges / t_fwd * 1e3, t_dev,
           edges / t_dev * 1e3, card))
    where_the_time_goes(torch, card, svc, qid, forward)
    svc.close()
    return launches


def device_ms_by_kernel(prof):
    """{kernel name: device ms} summed over a torch.profiler run.  Ranges
    that user code annotates (``Optimizer.step#Adam.step``) also appear
    on the device's timeline, where their own time is the idle gaps
    between their kernels: they are left out."""
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if (dev_us > 0 and not getattr(ev, "is_user_annotation", False)
                and str(getattr(ev, "device_type", "")).endswith("CUDA")):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3
    return by_kernel


def where_the_time_goes(torch, card, svc, qid, forward):
    """One caller, full micro-batches: the host wall of a request and of the
    forward, then the device time by kernel from torch.profiler over the
    same work.  The profiler slows the host, so the device's busy share is
    taken against the wall measured without it."""
    from torch.profiler import ProfilerActivity, profile
    ids = np.arange(MICRO_BATCH)
    n_req = 20

    def host_ms(fn):
        """Median host wall of one call, each ended by a synchronize (the
        host clock is noisy on a shared machine)."""
        times, out = [], None
        for _ in range(n_req):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    run_ms, ans = host_ms(lambda: svc.run(qid, ids))
    fwd_ms, _ = host_ms(lambda: forward(ans))
    wall_ms, _ = host_ms(lambda: forward(svc.run(qid, ids)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms, _ = host_ms(lambda: forward(svc.run(qid, ids)))
    by_kernel = device_ms_by_kernel(prof)
    busy = sum(by_kernel.values()) / n_req
    log("one caller, %d requests of %d seeds, median per request on the "
        "host clock: svc.run %.3f ms, forward %.3f ms, both %.3f ms (%.3f ms "
        "under the profiler); device busy %.3f ms (%.1f%% of %.3f ms; card: "
        "%s)"
        % (n_req, MICRO_BATCH, run_ms, fwd_ms, wall_ms, profiled_ms, busy,
           100.0 * busy / wall_ms, wall_ms, card))
    if not by_kernel:
        log("torch.profiler recorded no device time: busy share not measured")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log("  device %.4f ms per request: %s" % (ms / n_req, name[:90]))


# ---------------------------------------------------------------------------
# Phase 6: the training path at the benchmark's width
# ---------------------------------------------------------------------------

HOPS = ["hop1", "hop2"]
# One training step on the kernels against the same step on the plain
# versions (plain indexing for every hop's rows, the conv's own mean or
# gat_block_plain): f32 throughout, sums in other orders, and the GAT
# backward's atomicAdd.  The loss within 1e-4 relative; each gradient
# within 1e-3 of its largest reference value.
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-4, 1e-3


def training_path(torch, card, g, dec, gather, spmm, gat):
    """EgoGraphSAGE, EgoGIN and EgoGAT through LocalTrainer.train; returns
    the launch counts of the SAGE and GIN runs together, then the GAT
    run's."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.nn import data as gdata
    from graph_learn_tpu_torch.nn.layers import ego as ego_layers
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import (EgoGAT, EgoGIN,
                                                         EgoGraphSAGE)
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from torch.profiler import ProfilerActivity, profile

    k1, k2 = FANOUT
    edges_per_step = MICRO_BATCH * (k1 + k1 * k2)
    q = two_hop_query(g, shuffle=True)
    table = q.device_tables()["nodes"]["item"].float_attrs
    dims = [FEAT_DIM, HIDDEN, CLASSES]
    # (depth, width) of the three gat_block calls of an EgoGAT step: layer 1
    # on both hops, layer 2 (no bias; the heads are averaged)
    gat_call_shapes = [(FEAT_DIM, HIDDEN), (FEAT_DIM, HIDDEN),
                       (HIDDEN, CLASSES)]
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "gat_block": gat.LAUNCHES_FWD,
                "gat_block_bwd": gat.LAUNCHES_BWD}

    def pre_aggregate(batch, tables, op="mean"):
        return gdata.pre_aggregate_hop(
            batch, "hop2", tables["nodes"]["item"].float_attrs, op=op)

    def loss_of(model, batch):
        ego = gdata.EgoGraph.from_query_result(batch, "src", HOPS)
        return supervised_softmax_loss(model(ego, training=True),
                                       batch["src"].labels)

    def plain_batch(batch):
        """The same batch with every hop's rows taken by plain indexing."""
        return {a: v.replace(float_attrs=table[v.ids.long()])
                for a, v in batch.items()}

    def loss_and_grads(model, batch):
        loss = loss_of(model, batch)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    def one_step_against_plain(name, model, transform):
        # a batch from the Dataset: queued ahead on its side stream
        ds = gl.Dataset(q, window=2, transform=transform, device="cuda")
        batch = ds.next()
        loss, grads = loss_and_grads(model, batch)
        kernel_block = ego_layers.gat_block
        ego_layers.gat_block = gat.gat_block_plain
        try:
            ref_loss, ref_grads = loss_and_grads(model, plain_batch(batch))
        finally:
            ego_layers.gat_block = kernel_block
        torch.cuda.synchronize()
        lerr = abs(loss.item() - ref_loss.item())
        check(lerr <= STEP_LOSS_RTOL * abs(ref_loss.item()),
              "%s: loss %g on the kernels, %g on the plain versions"
              % (name, loss.item(), ref_loss.item()))
        worst = 0.0
        for (pname, _), got, want in zip(model.named_parameters(), grads,
                                         ref_grads):
            rel = ((got - want).abs().max().item()
                   / max(want.abs().max().item(), 1e-12))
            check(rel <= STEP_GRAD_TOL, "%s: gradient of %s off by %g of its "
                  "largest value" % (name, pname, rel))
            worst = max(worst, rel)
        log("%s: one step on the kernels against the plain versions: loss "
            "%.6f vs %.6f (limit %g relative), worst gradient error %.3g of "
            "the tensor's largest value (limit %g)"
            % (name, loss.item(), ref_loss.item(), STEP_LOSS_RTOL, worst,
               STEP_GRAD_TOL))

    def run(name, model, transform, epochs, steps, expect):
        losses = []

        def loss_fn(model, batch, generator, training):
            loss = loss_of(model, batch)
            losses.append(loss.detach())
            return loss

        one_step_against_plain(name, model, transform)
        opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        tr = LocalTrainer(seed=0, device="cuda")

        def train(n_epochs, n_steps):
            t0 = time.perf_counter()
            _, hist = tr.train(q, model, loss_fn, opt, epochs=n_epochs,
                               steps_per_epoch=n_steps, verbose=False,
                               batch_transform=transform)
            torch.cuda.synchronize()
            return hist, time.perf_counter() - t0

        train(1, 3)  # warm-up, not counted
        before = [p.detach().clone() for p in model.parameters()]
        del losses[:]
        for c in (list(counters.values()) + list(gat.ROUTE_LAUNCHES.values())
                  + [gat.WGMMA_LAUNCHES]):
            c.reset()
        hist, wall = train(epochs, steps)
        launches = {k: c.count for k, c in counters.items()}
        routes = {r: c.count for r, c in gat.ROUTE_LAUNCHES.items()}
        wgmma_launches = gat.WGMMA_LAUNCHES.count
        n = epochs * steps
        check(len(losses) == n and len(hist) == epochs, "%s: %d losses, %d "
              "epochs" % (name, len(losses), len(hist)))
        check(bool(torch.isfinite(torch.stack(losses)).all())
              and all(np.isfinite(hist)), "%s: a loss is not finite" % name)
        check(all(not torch.equal(a, p.detach()) and
                  bool(torch.isfinite(p).all())
                  for a, p in zip(before, model.parameters())),
              "%s: a parameter did not move or is not finite" % name)
        want = {k: v * n for k, v in expect.items()}
        check(launches == want, "%s: launches %s, expected %s"
              % (name, launches, want))
        # every gat_block call of the training path, forward and backward,
        # has its products on the tensor cores
        check(routes == {"tensor": launches["gat_block"]
                         + launches["gat_block_bwd"], "fma": 0},
              "%s: product routes %s for launches %s"
              % (name, routes, launches))
        # and the two first-layer forwards of a GAT step (depth 128) have
        # theirs on wgmma; the second layer's depth (256) takes mma.sync
        want_wgmma = sum(gat.forward_product_kernel(d, w) == "wgmma"
                         for d, w in gat_call_shapes) * n
        check(wgmma_launches == (want_wgmma if launches["gat_block"] else 0),
              "%s: %d forwards on wgmma, expected %d"
              % (name, wgmma_launches, want_wgmma))
        step_ms = wall / n * 1e3
        # the device's share of a step: device time by kernel under the
        # profiler over the wall measured without it
        n_prof = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall = train(1, n_prof)
        by_kernel = device_ms_by_kernel(prof)
        busy = sum(by_kernel.values()) / n_prof
        log("%s: %d steps of batch %d through LocalTrainer.train in %.3f s: "
            "%.3f ms per step on the host clock (%.3f ms under the "
            "profiler), %.4g edges/s; per-epoch mean loss %s; launches %s, "
            "gat_block product routes %s, %d forwards on wgmma; "
            "device busy %.3f ms per step (%.1f%% of the step; card: %s)"
            % (name, n, MICRO_BATCH, wall, step_ms, prof_wall / n_prof * 1e3,
               edges_per_step / step_ms * 1e3,
               ["%.4f" % x for x in hist], launches, routes, wgmma_launches,
               busy, 100.0 * busy / step_ms, card))
        if not by_kernel:
            log("torch.profiler recorded no device time: busy share not "
                "measured")
        for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log("  device %.4f ms per step: %s" % (ms / n_prof, kname[:90]))
        return launches

    sage = EgoGraphSAGE(dims, dec, agg_type="gcn", device="cuda")
    sage_launches = run(
        "EgoGraphSAGE %s gcn, deepest hop pre-aggregated" % dims, sage,
        pre_aggregate, SAGE_EPOCHS, SAGE_STEPS,
        {"gather_rows": 2, "segment_spmm": 1, "gat_block": 0,
         "gat_block_bwd": 0})
    gin = EgoGIN(dims, dec, device="cuda")
    gin_launches = run(
        "EgoGIN %s, deepest hop pre-summed" % dims, gin,
        lambda batch, tables: pre_aggregate(batch, tables, "sum"), 1,
        GIN_STEPS, {"gather_rows": 2, "segment_spmm": 1, "gat_block": 0,
                    "gat_block_bwd": 0})
    gat_model = EgoGAT(dims, dec, num_heads=list(GAT_HEADS), device="cuda")
    gat_launches = run(
        "EgoGAT %s heads %s" % (dims, list(GAT_HEADS)), gat_model, None, 1,
        GAT_STEPS, {"gather_rows": 3, "segment_spmm": 0, "gat_block": 3,
                    "gat_block_bwd": 3})
    return ({k: sage_launches[k] + gin_launches[k] for k in sage_launches},
            gat_launches)


# ---------------------------------------------------------------------------
# Phase 7: the sweep-aggregate harness and Kernels 4-5 at its full shape
# ---------------------------------------------------------------------------


def sweep_split(torch, sweep, starts, packed, table, groups, R, where):
    """Kernel 4's call in parts: the work one call puts on the card (the
    kernel and at most one memset, from a captured call), the zero fill's
    device time (the memset) and the kernel's, from the profiler's events
    of the same calls."""
    work, ms = check_one_launch(
        torch, "sweep_aggregate " + where, lambda: sweep.sweep_aggregate(
            starts, packed, table, groups, R), "sweep_aggregate_kernel",
        allow_memset=True)
    check("memset" in ms, "sweep_aggregate %s: a call put no memset of "
          "the output on the card: %s" % (where, work))
    return {"fill_ms": ms["memset"], "kernel_ms": ms["kernel"],
            "work_per_call": work}


def sweep_rows(torch, card, sweep, spmm):
    """Run the harness at the frontier shape (2 457 600 x 128 f32, 153 600
    hits in groups of 10), then time Kernels 4 and 5, their plain versions
    and the one library call on the same shape; returns the two rows."""
    from graph_learn_tpu_torch.examples import sweep_aggregate as harness

    sweep.LAUNCHES_SWEEP.reset()
    sweep.LAUNCHES_STREAM.reset()
    r = harness.run(small=False, steps=30, slab=4096, device="cuda")
    harness_launches = {"sweep_aggregate": sweep.LAUNCHES_SWEEP.count,
                        "stream_sum": sweep.LAUNCHES_STREAM.count}
    check(all(v > 0 for v in harness_launches.values()),
          "the harness did not launch both kernels: %s" % harness_launches)
    log("sweep harness at %d x %d f32, N=%d, k=%d, R=%d (%s): bar %.4f ms "
        "(plain %.4f), prep %.4f, stream %.4f, sweep %.4f, total prep + "
        "sweep %.4f ms against the bar's %.4f; sweep / k within 1e-5 of the "
        "plain mean (max abs err %g), stream sum within 1e-6 of each "
        "column's sum of magnitudes (max abs err %g); card: %s"
        % (r["n_rows"], harness.D, r["n_hits"], r["k"], r["slab"],
           r["timer"], r["bar_ms"], r["bar_plain_ms"], r["prep_ms"],
           r["stream_ms"], r["sweep_ms"], r["total_ms"], r["bar_ms"],
           r["sweep_max_abs_err"], r["stream_max_abs_err"], card))

    n_rows, n, k, d, R = r["n_rows"], r["n_hits"], r["k"], harness.D, 4096
    groups = n // k
    gen = torch.Generator(device="cuda").manual_seed(7)
    table = torch.randn((n_rows, d), generator=gen, device="cuda")
    flat = torch.randint(0, n_rows, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    starts, packed = sweep.sweep_prep(flat, k, n_rows, R)
    out = sweep.sweep_aggregate(starts, packed, table, groups, R)
    ref = sweep.sweep_aggregate_plain(starts, packed, table, groups, R)
    err4 = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "sweep_aggregate at the harness shape: max err %g" % err4)
    # what these inputs need: each distinct hit row once, the hit list and
    # the slab starts, [G, D] f32 written once; one add per hit element
    distinct = int(torch.unique(flat).numel())
    bytes4 = (distinct * d * 4 + n * 4 + starts.numel() * 4 + groups * d * 4)
    b4, by4 = bound(bytes4, n * d)
    row4 = dict(
        name="sweep_aggregate", route="cuda",
        source="graph_learn_tpu_torch/csrc/sweep.cu",
        replaces="examples/sweep_aggregate.py:39", max_abs_err=err4,
        ms=time_ms(lambda: sweep.sweep_aggregate(starts, packed, table,
                                                 groups, R), hold=True),
        plain_ms=time_ms(lambda: sweep.sweep_aggregate_plain(
            starts, packed, table, groups, R), iters=20, hold=True),
        bound_ms=b4, bound_by=by4,
        # no single PyTorch call sums rows picked by one index into groups
        # picked by another: index_select + index_add_ are two calls, and
        # embedding_bag on the sorted ids gives per-bag sums of consecutive
        # ids, not per-group sums
        library_ms=None, harness_ms=r["sweep_ms"], prep_ms=r["prep_ms"],
        harness_launches=harness_launches["sweep_aggregate"])
    row4.update(sweep_split(torch, sweep, starts, packed, table, groups, R,
                            "at the harness shape"))
    log("sweep_aggregate at the harness shape, the call in parts: zero fill "
        "%.4f ms, kernel %.4f ms, the call %.4f ms; one call puts %s on the "
        "card" % (row4["fill_ms"], row4["kernel_ms"], row4["ms"],
                  row4["work_per_call"]))
    # Kernel 2's bar in the harness against its bound: the hit rows read
    # once, the ids and degrees, [G, D] f32 written once
    bar_bound, _ = bound(n * d * 4 + n * 4 + groups * 4 + groups * d * 4,
                         n * d + groups * d)
    bar = {"bar_ms": r["bar_ms"], "bar_plain_ms": r["bar_plain_ms"],
           "bar_bound_ms": bar_bound}
    bar.update({key + "_bar": v for key, v in spmm_work(
        torch, spmm, "as the harness bar", table, flat.reshape(groups, k),
        torch.full((groups,), k, dtype=torch.int32, device="cuda")).items()})
    log("segment_spmm as the harness bar (%d hits into %d x %d f32): %.4f "
        "ms, bound %.4f by bytes (%.1f%% of it)"
        % (n, n_rows, d, r["bar_ms"], bar_bound, 100 * bar_bound / r["bar_ms"]))

    s_out = sweep.stream_sum(table)
    exact = table.sum(0, dtype=torch.float64)
    s_err = (s_out[0].double() - exact).abs()
    limit = 1e-6 * table.abs().sum(0, dtype=torch.float64)
    check(bool((s_err <= limit).all()), "stream_sum at the harness shape: "
          "max err %g" % s_err.max().item())
    b5, by5 = bound(n_rows * d * 4 + d * 4, n_rows * d)
    row5 = dict(
        name="stream_sum", route="cuda",
        source="graph_learn_tpu_torch/csrc/sweep.cu",
        replaces="examples/sweep_aggregate.py:96",
        max_abs_err=s_err.max().item(),
        ms=time_ms(lambda: sweep.stream_sum(table), iters=20, hold=True),
        plain_ms=time_ms(lambda: sweep.stream_sum_plain(table), iters=20,
                         hold=True),
        bound_ms=b5, bound_by=by5,
        library_ms=time_ms(lambda: table.sum(0), iters=20, hold=True),
        harness_ms=r["stream_ms"], launches=harness_launches["stream_sum"])
    for row in (row4, row5):
        log("%s at the harness shape: %.4f ms (in the harness %.4f; plain "
            "%.4f, library %s, bound %.4f by %s), max abs err %g"
            % (row["name"], row["ms"], row["harness_ms"], row["plain_ms"],
               "none" if row["library_ms"] is None
               else "%.4f" % row["library_ms"], row["bound_ms"],
               row["bound_by"], row["max_abs_err"]))
    return row4, row5, bar


# ---------------------------------------------------------------------------
# Phase 8: the 62M-edge frontier path (examples/scale_demo.py)
# ---------------------------------------------------------------------------

SCALE_STEPS, SCALE_WARMUP = 30, 3
# the first-step loss of the sorted route against the unsorted route's:
# the same ids and weights, only the order of the deepest hop's f32 sums
# differs (and changes from run to run under the sweep kernel's atomics)
SORTED_LOSS_RTOL = 1e-5


def scale_path(torch, card, gl, gather, spmm, sweep):
    """examples.scale_demo.run at the published sizes, unsorted and sorted
    route; returns ({kernel: launches} of each run, extra row fields)."""
    import torch.nn.functional as F
    from graph_learn_tpu_torch.examples import scale_demo
    from graph_learn_tpu_torch.nn.data import PreAggregatedRows
    from torch.profiler import ProfilerActivity, profile

    size = scale_demo.PUBLISHED
    n, d = size["n_nodes"], size["feat_dim"]
    b, (k1, k2) = size["batch"], size["fanout"]
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}
    per_run = 1 + SCALE_WARMUP + SCALE_STEPS  # first batch, warm-up, steps

    def run(sorted_on, graph):
        gl.conf.sorted_gather = sorted_on
        for c in counters.values():
            c.reset()
        try:
            r = scale_demo.run(steps=SCALE_STEPS, warmup=SCALE_WARMUP,
                               device="cuda", graph=graph, **size)
        finally:
            gl.conf.sorted_gather = False
        launches = {k: c.count for k, c in counters.items()}
        deep = "sweep_aggregate" if sorted_on else "segment_spmm"
        want = {"gather_rows": 2 * per_run, "segment_spmm": 0,
                "sweep_aggregate": 0, deep: per_run}
        check(launches == want, "62M path (sorted_gather=%s): launches %s, "
              "expected %s" % (sorted_on, launches, want))
        losses = np.asarray(r["losses"])
        check(losses.shape == (SCALE_WARMUP + SCALE_STEPS,)
              and bool(np.isfinite(losses).all()),
              "62M path: a loss is not finite")
        log("62M path, sorted_gather=%s: %d steps of batch %d, fanout %s on "
            "%d nodes / %d edges / %d bf16 features: %.3f ms per step on the "
            "host clock, %.4g edges/s; loss %.4f -> %.4f; launches per step "
            "%s (card: %s)"
            % (sorted_on, SCALE_STEPS, b, [k1, k2], n, size["n_edges"], d,
               r["step_ms"], r["edges_per_s"], losses[0], losses[-1],
               {k: v // per_run for k, v in launches.items()}, card))
        return r, launches

    # unsorted, sorted, sorted, unsorted: the two routes are compared on the
    # host clock, which drifts, so each is run on both sides of the other
    r1, launches1 = run(False, None)
    log("62M store: host draw %.1f s, CSR build and tables onto the card "
        "%.1f s, %.3f GB of tables on the card, %.3f GB allocated by the "
        "process at the peak of the run (torch.cuda.max_memory_allocated)"
        % (r1["host_build_s"], r1["tables_s"], r1["tables_bytes"] / 1e9,
           r1["device_bytes_peak"] / 1e9))
    r2, launches2 = run(True, r1["graph"])
    r3, _ = run(True, r1["graph"])
    r4, _ = run(False, r1["graph"])
    l1 = r1["losses"][0]
    for r in (r2, r3, r4):
        check(abs(l1 - r["losses"][0]) <= SORTED_LOSS_RTOL * abs(l1),
              "62M path: first-step loss %g, then %g" % (l1, r["losses"][0]))
    step = {False: (r1["step_ms"], r4["step_ms"]),
            True: (r2["step_ms"], r3["step_ms"])}
    q, model = r1["query"], r1["model"]
    tables = q.device_tables("cuda")
    table = tables["nodes"]["item"].float_attrs
    et = tables["edges"]["rel"]
    check(table.shape == (n, d) and table.dtype == torch.bfloat16
          and et.out.num_edges == size["n_edges"] and et.inc is None
          and et.out.cum_in_degrees is None,
          "62M store is not the minimal profile at the published sizes")

    # one step on the kernels against the same step on the plain versions
    gen = torch.Generator(device="cuda").manual_seed(11)
    seeds = torch.randint(0, n, (b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    batch = scale_demo.sample_batch(q, tables, seeds, gen)
    plain = {a: v.replace(float_attrs=table[v.ids.long()])
             for a, v in batch.items()}
    plain["hop2"] = batch["hop2"].replace(float_attrs=PreAggregatedRows(
        table[batch["hop2"].ids.long()].float().reshape(-1, k2, d).mean(1),
        "mean"))
    params = list(model.parameters())
    loss = scale_demo.loss_of(model, batch)
    grads = torch.autograd.grad(loss, params)
    ref_loss = scale_demo.loss_of(model, plain)
    ref_grads = torch.autograd.grad(ref_loss, params)
    torch.cuda.synchronize()
    check(abs(loss.item() - ref_loss.item())
          <= STEP_LOSS_RTOL * abs(ref_loss.item()),
          "62M path: loss %g on the kernels, %g on the plain versions"
          % (loss.item(), ref_loss.item()))
    worst = max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
                for g, w in zip(grads, ref_grads))
    check(worst <= STEP_GRAD_TOL, "62M path: a gradient is off by %g of its "
          "largest value" % worst)
    log("62M path: one step on the kernels against the plain versions: loss "
        "%.6f vs %.6f (limit %g relative), worst gradient error %.3g of the "
        "tensor's largest value (limit %g)"
        % (loss.item(), ref_loss.item(), STEP_LOSS_RTOL, worst,
           STEP_GRAD_TOL))

    # the device's share of a step, both routes
    opt = torch.optim.Adam(model.parameters(), lr=scale_demo.LEARNING_RATE)
    n_prof = 5
    busy = {}
    for sorted_on in (False, True):
        gl.conf.sorted_gather = sorted_on
        try:
            scale_demo.train_steps(q, tables, model, opt, 2, n, gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                scale_demo.train_steps(q, tables, model, opt, n_prof, n, gen)
                torch.cuda.synchronize()
        finally:
            gl.conf.sorted_gather = False
        by_kernel = device_ms_by_kernel(prof)
        busy[sorted_on] = sum(by_kernel.values()) / n_prof
        log("62M path, sorted_gather=%s: device busy %.3f ms per step under "
            "torch.profiler (%d steps)%s"
            % (sorted_on, busy[sorted_on], n_prof,
               "" if by_kernel else ": no device time recorded, not "
               "measured"))
        for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
            log("  device %.4f ms per step: %s" % (ms / n_prof, kname[:90]))

    log("62M path: first-step loss %.7f unsorted, %.7f sorted (limit %g "
        "relative); step on the host clock, runs in the order unsorted, "
        "sorted, sorted, unsorted: %.3f, %.3f, %.3f, %.3f ms; device busy "
        "%.3f ms unsorted (%.1f%% of the mean step), %.3f ms sorted (%.1f%%); "
        "card: %s"
        % (l1, r2["losses"][0], SORTED_LOSS_RTOL, r1["step_ms"],
           r2["step_ms"], r3["step_ms"], r4["step_ms"], busy[False],
           100.0 * busy[False] / np.mean(step[False]), busy[True],
           100.0 * busy[True] / np.mean(step[True]), card))

    # Kernels 1, 2 and 4 at this table: 2.45M rows of 200 bytes, ten times
    # the L2.  Warm: 50 calls on the same ids, whose 153 600 rows (about 39
    # MB counted in 32-byte sectors) the L2 largely keeps from call to
    # call; cold: the L2 flushed before each call (utils/timing.py
    # time_cold_ms), as a training step finds it with new ids every time
    m = b * k1 * k2
    idx = torch.randint(0, n, (m,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids = idx.reshape(b * k1, k2)
    deg = torch.full((ids.shape[0],), k2, dtype=torch.int32, device="cuda")
    es = table.element_size()

    def warm_cold(fn):
        return {"ms_62m": time_ms(fn, hold=True),
                "cold_ms_62m": time_cold_ms(fn)}

    shapes = gather_shapes(torch, gather, table, gen, "at the 62M table",
                           rows=GATHER_PATH_ROWS + (m,), warm_rows=(m,),
                           given={m: idx}, yardsticks=GATHER_PATH_ROWS)
    extra = {"gather_rows": dict(
        ms_62m=shapes[m]["warm_ms"], cold_ms_62m=shapes[m]["ms"],
        plain_ms_62m=time_ms(lambda: gather.gather_rows_plain(table, idx),
                             iters=20, hold=True),
        library_ms_62m=time_ms(lambda: torch.index_select(table, 0, idx),
                               hold=True),
        bound_ms_62m=shapes[m]["bound_ms"],
        kernel_route_62m=shapes[m]["route"])}
    for rows_m in GATHER_PATH_ROWS:
        f = shapes[rows_m]
        extra["gather_rows"].update({
            "cold_ms_62m_%d" % rows_m: f["ms"],
            "bound_ms_62m_%d" % rows_m: f["bound_ms"],
            "plain_cold_ms_62m_%d" % rows_m: f["plain_ms"],
            "library_cold_ms_62m_%d" % rows_m: f["library_ms"],
            "kernel_route_62m_%d" % rows_m: f["route"]})
    out = spmm.segment_spmm(table, ids, deg, "mean", torch.float32)
    ref = spmm.segment_spmm_plain(table, ids, deg, "mean", torch.float32)
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          "segment_spmm at the 62M table: max err %g"
          % (out - ref).abs().max().item())
    s_bound, _ = bound(m * d * es + m * 4 + deg.numel() * 4
                       + ids.shape[0] * d * 4, m * d + ids.shape[0] * d)
    extra["segment_spmm"] = dict(
        warm_cold(lambda: spmm.segment_spmm(table, ids, deg, "mean",
                                            torch.float32)),
        plain_ms_62m=time_ms(lambda: spmm.segment_spmm_plain(
            table, ids, deg, "mean", torch.float32), iters=20, hold=True),
        library_ms_62m=time_ms(lambda: F.embedding_bag(
            ids, table, mode="mean"), hold=True),
        bound_ms_62m=s_bound)
    extra["segment_spmm"].update({
        k + "_62m": v for k, v in spmm_work(
            torch, spmm, "at the 62M table", table, ids, deg).items()})
    starts, packed = sweep.sweep_prep(idx, k2, n)
    out4 = sweep.sweep_aggregate(starts, packed, table, ids.shape[0]) / k2
    check(torch.allclose(out4, ref, rtol=1e-5, atol=1e-5),
          "sweep_aggregate / k at the 62M table: max err %g"
          % (out4 - ref).abs().max().item())
    w_bound, _ = bound(int(torch.unique(idx).numel()) * d * es + m * 4
                       + starts.numel() * 4 + ids.shape[0] * d * 4, m * d)
    extra["sweep_aggregate"] = dict(
        warm_cold(lambda: sweep.sweep_aggregate(starts, packed, table,
                                                ids.shape[0])),
        prep_ms_62m=time_ms(lambda: sweep.sweep_prep(idx, k2, n),
                            iters=20, hold=True),
        plain_ms_62m=time_ms(lambda: sweep.sweep_aggregate_plain(
            starts, packed, table, ids.shape[0], 4096), iters=20, hold=True),
        library_ms_62m=None, bound_ms_62m=w_bound)
    extra["sweep_aggregate"].update({
        k + "_62m": v for k, v in sweep_split(
            torch, sweep, starts, packed, table, ids.shape[0], 4096,
            "at the 62M table").items()})
    for name, f in extra.items():
        log("%s at the 62M table (%d x %d bf16, %d random rows): %.4f ms "
            "warm, %.4f ms cold (plain %.4f, library %s, bound %.4f by "
            "bytes)%s"
            % (name, n, d, m, f["ms_62m"], f["cold_ms_62m"],
               f["plain_ms_62m"], "none" if f["library_ms_62m"] is None
               else "%.4f" % f["library_ms_62m"], f["bound_ms_62m"],
               "; the call in parts: zero fill %.4f ms, kernel %.4f ms; "
               "sweep_prep %.4f ms" % (f["fill_ms_62m"], f["kernel_ms_62m"],
                                       f["prep_ms_62m"])
               if "prep_ms_62m" in f else ""))
    return launches1, launches2, extra


# ---------------------------------------------------------------------------
# Phase 9: the samplers that read the full store, through QueryService
# ---------------------------------------------------------------------------

FULL_CAP, STRATEGY_K = 32, 6


def full_store_queries(torch, g, spmm):
    """A "full" query answered by QueryService, its SparseNodes reduced by
    Kernel 2 on ragged degrees; an edge_weight and a topk query checked for
    true neighbours (topk: the heaviest edges first)."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.core.values import SparseNodes

    et = g.store.edge_table("rel")
    out_deg = et.out_degrees
    rng = np.random.default_rng(2)
    raw = rng.integers(0, N_NODES, 1500)
    svc = gl.QueryService(g, device="cuda")
    try:
        def ask(strategy, k):
            q = (g.V("item").batch(MICRO_BATCH).alias("src").outV("rel")
                 .sample(k).by(strategy).alias("nbrs").values())
            return svc.run(svc.install(q, micro_batch=MICRO_BATCH), raw)

        spmm.LAUNCHES.reset()
        ans = ask("full", FULL_CAP)
        nb = ans["nbrs"]
        check(isinstance(nb, SparseNodes) and nb.ids.shape == (raw.size,
                                                               FULL_CAP),
              "full query: not SparseNodes [n, cap]")
        check(np.array_equal(nb.degrees.cpu().numpy(),
                             np.minimum(out_deg[raw], FULL_CAP)),
              "full query: degrees are not the out-degrees clipped to cap")
        table = nb.float_attrs.table
        worst = 0.0
        for op in ("mean", "max"):
            got = nb.embedding_agg(op)
            ref = spmm.segment_spmm_plain(table, nb.ids, nb.degrees, op,
                                          table.dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            # bf16 out: the order of the f32 sums may flip one bf16 rounding
            check(torch.allclose(got.float(), ref.float(), rtol=2 ** -7,
                                 atol=1e-5),
                  "SparseNodes.embedding_agg(%s): max err %g" % (op, err))
            worst = max(worst, err)
        launches = spmm.LAUNCHES.count
        check(launches == 2, "embedding_agg on ragged rows launched "
              "segment_spmm %d times, expected 2" % launches)
        # every listed neighbour is an out-edge of its seed, in adjacency
        # order (heaviest first), and the list is the whole row up to cap
        src64, dst64 = et.src, et.dst
        order = np.lexsort((-et.weights.astype(np.float64), src64))
        row_start = np.concatenate([[0], np.cumsum(out_deg)])
        ids = nb.ids.cpu().numpy()
        for i in rng.integers(0, raw.size, 200):
            lo = row_start[raw[i]]
            want = dst64[order[lo:lo + min(out_deg[raw[i]], FULL_CAP)]]
            check(np.array_equal(ids[i, :want.size], want),
                  "full query: row %d is not the seed's adjacency" % i)
        log("full query through QueryService: %d seeds, cap %d, degrees "
            "%d..%d (ragged), rows equal the weight-ordered adjacency; "
            "SparseNodes.embedding_agg mean/max on segment_spmm (%d "
            "launches) within rtol=2^-7, atol=1e-5 of the plain version "
            "(max abs err %g)"
            % (raw.size, FULL_CAP, nb.degrees.min().item(),
               nb.degrees.max().item(), launches, worst))

        keys = np.unique(src64 * N_NODES + dst64)
        for strategy in ("edge_weight", "topk"):
            hop = ask(strategy, STRATEGY_K)["nbrs"].ids.cpu().numpy()
            check(hop.shape == (raw.size, STRATEGY_K), strategy + ": shape")
            pair = np.repeat(raw, STRATEGY_K) * N_NODES + hop.reshape(-1)
            pos = np.clip(np.searchsorted(keys, pair), 0, keys.size - 1)
            empty = np.repeat(out_deg[raw] == 0, STRATEGY_K)
            check(bool(np.all(np.where(
                empty, hop.reshape(-1) == gl.conf.default_neighbor_id,
                keys[pos] == pair))), strategy + ": a non-neighbour")
            if strategy == "topk":
                for i in rng.integers(0, raw.size, 200):
                    lo, dg = row_start[raw[i]], out_deg[raw[i]]
                    if dg:
                        want = dst64[order[lo + np.arange(STRATEGY_K) % dg]]
                        check(np.array_equal(hop[i], want), "topk: row %d "
                              "is not the heaviest edges first" % i)
        log("edge_weight and topk queries through QueryService: every id a "
            "true neighbour (default fill on zero-degree seeds), topk rows "
            "the heaviest edges first with circular padding")
    finally:
        svc.close()
    return launches


FILTER_K = 15


def filtered_queries(torch, g):
    """``.outV("rel").sample(15).by(s).filter("src")`` through QueryService
    for random, topk, edge_weight and full, on every node that links to
    itself and 1 000 others: every id a true neighbour, and no hop-1 id
    equal to its seed in a row that lists the seed once beside another
    neighbour; without the filter the seeds do come back as their own
    neighbours."""
    import graph_learn_tpu_torch as gl

    et = g.store.edge_table("rel")
    src, dst = et.src, et.dst
    out_deg = et.out_degrees
    order = np.argsort(src, kind="stable")
    row_start = np.concatenate([[0], np.cumsum(out_deg)])
    loops = np.unique(src[src == dst])
    raw = np.concatenate([loops, np.random.default_rng(3).integers(
        0, N_NODES, 1000)])
    svc = gl.QueryService(g, device="cuda")
    hits = {}
    try:
        for strategy in ("random", "topk", "edge_weight", "full"):
            for filtered in (False, True):
                hop = (g.V("item").batch(MICRO_BATCH).alias("src")
                       .outV("rel").sample(FILTER_K).by(strategy))
                if filtered:
                    hop = hop.filter("src")
                q = hop.alias("nbrs").values()
                ans = svc.run(svc.install(q, micro_batch=MICRO_BATCH),
                              raw)["nbrs"]
                ids = ans.ids.cpu().numpy()
                deg = (ans.degrees.cpu().numpy() if strategy == "full"
                       else None)
                n_hits = 0
                for i, s in enumerate(raw):
                    row = dst[order[row_start[s]:row_start[s + 1]]]
                    got = ids[i, :deg[i]] if deg is not None else ids[i]
                    if row.size == 0:
                        check(bool(np.all(got == gl.conf.default_neighbor_id)),
                              "%s: a zero-degree seed got neighbours"
                              % strategy)
                        continue
                    check(bool(np.isin(got, row).all()),
                          "%s (filtered=%s): a non-neighbour of seed %d"
                          % (strategy, filtered, s))
                    n_hits += int((got == s).sum())
                    if filtered and (row == s).sum() == 1 and row.size > 1:
                        check(s not in got, "%s: seed %d sampled as its own "
                              "neighbour through .filter('src')"
                              % (strategy, s))
                hits[strategy, filtered] = n_hits
            check(hits[strategy, True] < hits[strategy, False],
                  "%s: the seeds came back %d times without the filter, %d "
                  "with it" % (strategy, hits[strategy, False],
                               hits[strategy, True]))
    finally:
        svc.close()
    log("filtered queries through QueryService, .sample(%d).by(s)"
        ".filter('src') on %d seeds (%d of them linked to themselves): "
        "every id a true neighbour, no seed its own neighbour where its row "
        "has another; the seeds came back as their own neighbours %s times "
        "without the filter, %s with it"
        % (FILTER_K, raw.size, loops.size,
           {s: hits[s, False] for s in ("random", "topk", "edge_weight",
                                        "full")},
           {s: hits[s, True] for s in ("random", "topk", "edge_weight",
                                       "full")}))


# ---------------------------------------------------------------------------
# Phase 11: the port bench (graph_learn_tpu_torch/bench.py), eager and in
# one CUDA graph
# ---------------------------------------------------------------------------

BENCH_KERNELS = ("gather_rows", "segment_spmm", "sweep_aggregate")


def bench_work(torch, fn, steps, calls, tries=3, kernels=None):
    """Kernels per step and device ms per step of the work ``calls`` calls
    of ``fn`` (``steps`` steps each) put on the card, from torch.profiler:
    under a replay each kernel of the graph is an event of its own.
    ``kernels`` maps each name counted to the pattern of its kernels'
    names (default: BENCH_KERNELS, each its own pattern).  A window that
    lost records (a kernel count that is no whole number a step) is
    profiled again, up to ``tries`` times."""
    if kernels is None:
        kernels = {k: k for k in BENCH_KERNELS}
    for _ in range(tries):
        work, ms = device_work_per_call(torch, fn, calls=calls)
        per_step = {k: sum(c for n, c in work.items() if pat in n) / steps
                    for k, pat in kernels.items()}
        if all(v == int(v) for v in per_step.values()):
            by_name = {n: c * ms[n] / steps for n, c in work.items()}
            return per_step, sum(by_name.values()), by_name
        log("torch.profiler recorded %s kernels per step; profiling again"
            % per_step)
    check(False, "torch.profiler lost records in %d windows: %s kernels per "
          "step" % (tries, per_step))


def bench_path(torch, card, cfg, graph, gather, spmm, sweep, name,
               sorted_route=False):
    """``bench.run_bench(cfg)`` eager, then in a CUDA graph, from the same
    model seed, Adam state and generator seed: every step's loss bit for
    bit the same, and the same parameters after; two replays draw other
    seeds and give other losses; the profiler's kernels per replayed step
    are 2 gather_rows and 1 segment_spmm; every loss finite and every
    parameter moved.  With ``sorted_route`` a run under conf.sorted_gather
    is captured too (2 gather_rows and 1 sweep_aggregate a step).  Returns
    (row fields for the kernels line, the graph)."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}
    K, (k1, k2), b = cfg["scan_steps"], cfg["fanout"], cfg["batch"]
    for c in counters.values():
        c.reset()
    eager = bench.run_bench(cfg, "cuda", capture=False, graph=graph)
    launches = {k: c.count for k, c in counters.items()}
    n_steps = (cfg["warmup"] + eager["rounds"]) * K
    # the first batch's forward, then every step: src and hop 1 gathered,
    # the deepest hop reduced
    want = {"gather_rows": 2 * (n_steps + 1), "segment_spmm": n_steps + 1,
            "sweep_aggregate": 0}
    check(launches == want, "bench %s eager: launches %s, expected %s"
          % (name, launches, want))
    graph = eager["graph"]
    captured = bench.run_bench(cfg, "cuda", capture=True, graph=graph)
    el, gl_ = np.asarray(eager["losses"]), np.asarray(captured["losses"])
    check(el.shape == gl_.shape == (n_steps,)
          and bool(np.isfinite(gl_).all()),
          "bench %s: %s eager and %s graph losses, or one not finite"
          % (name, el.shape, gl_.shape))
    check(np.array_equal(el, gl_), "bench %s: the graph's losses differ "
          "from the eager ones from the same state: max relative %g"
          % (name, np.max(np.abs(el - gl_) / np.abs(el))))
    fresh = EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                         graph[1], agg_type="gcn", device="cuda")
    for p0, pe, pg in zip(fresh.parameters(), eager["model"].parameters(),
                          captured["model"].parameters()):
        check(torch.equal(pe, pg), "bench %s: eager and graph parameters "
              "differ after the same steps" % name)
        check(not torch.equal(p0, pg) and bool(torch.isfinite(pg).all()),
              "bench %s: a parameter did not move or is not finite" % name)

    step = captured["step"]
    seeds0, losses0 = step.graph_seeds[0].clone(), step.losses.clone()
    step()
    seeds1, losses1 = step.graph_seeds[0].clone(), step.losses.clone()
    check(not torch.equal(seeds0, seeds1) and not torch.equal(losses0,
                                                              losses1)
          and int(seeds1.min()) >= 0 and int(seeds1.max()) < cfg["n_nodes"],
          "bench %s: two replays drew the same seeds or gave the same "
          "losses" % name)
    graph_work, graph_busy, graph_by_name = bench_work(torch, step, K, 2)
    check(graph_work == {"gather_rows": 2.0, "segment_spmm": 1.0,
                         "sweep_aggregate": 0.0},
          "bench %s: kernels per replayed step %s; want 2 gather_rows and "
          "1 segment_spmm" % (name, graph_work))
    eager_work, eager_busy, _ = bench_work(torch, step.run_eager, K, 1)
    check(eager_work == graph_work, "bench %s: kernels per eager step %s, "
          "per replayed step %s" % (name, eager_work, graph_work))
    edges = b * (k1 + k1 * k2)
    log("bench %s (%d nodes, %d edges, fanout [%d, %d], batch %d, K = %d, G "
        "= %d, %d steps after %d warm-up calls): eager %.4f ms per step "
        "(%.4g edges/s, device busy %.4f ms, %.1f%%), CUDA graph %.4f ms per "
        "step (%.4g edges/s, device busy %.4f ms, %.1f%%); capture %.3f s, "
        "graph pool %.1f MB; %d losses bit-equal eager and captured (%.4f -> "
        "%.4f); kernels per replayed step %s; host draw %.1f s, CSR build "
        "and tables onto the card %.1f s (%.3f GB), peak allocated %.3f GB "
        "eager, %.3f GB with the graph; card: %s"
        % (name, cfg["n_nodes"], cfg["n_nodes"] * cfg["avg_degree"], k1, k2,
           b, K, captured["G"], captured["rounds"] * K, cfg["warmup"],
           eager["step_ms"], eager["edges_per_s"], eager_busy,
           100.0 * eager_busy / eager["step_ms"], captured["step_ms"],
           captured["edges_per_s"], graph_busy,
           100.0 * graph_busy / captured["step_ms"], captured["capture_s"],
           captured["graph_pool_bytes"] / 1e6, n_steps, gl_[0], gl_[-1],
           {k: v for k, v in graph_work.items() if v}, eager["host_build_s"],
           eager["tables_s"], eager["tables_bytes"] / 1e9,
           eager["device_bytes_peak"] / 1e9,
           captured["device_bytes_peak"] / 1e9, card))
    for kname, ms in sorted(graph_by_name.items(),
                            key=lambda kv: -kv[1])[:10]:
        log("  device %.4f ms per replayed step: %s" % (ms, kname[:90]))
    rows = {k: {"bench_%s_launches_per_step" % name: graph_work[k],
                "bench_%s_eager_launches" % name: launches[k]}
            for k in ("gather_rows", "segment_spmm")}
    rows["gather_rows"]["bench_%s_build_s" % name] = (eager["host_build_s"]
                                                      + eager["tables_s"])
    del eager, captured, step
    if not sorted_route:
        return rows, graph
    with bench.bench_conf(sorted_gather=True):
        first = bench.run_bench(dict(cfg, steps=K, warmup=1), "cuda",
                                capture=True, graph=graph)
        work, busy, _ = bench_work(torch, first["step"], K, 2)
    check(work == {"gather_rows": 2.0, "segment_spmm": 0.0,
                   "sweep_aggregate": 1.0},
          "bench %s sorted_gather: kernels per replayed step %s; want 2 "
          "gather_rows and 1 sweep_aggregate" % (name, work))
    check(abs(first["losses"][0] - el[0]) <= SORTED_LOSS_RTOL * abs(el[0])
          and bool(np.isfinite(first["losses"]).all()),
          "bench %s sorted_gather: first loss %g, unsorted %g"
          % (name, first["losses"][0], el[0]))
    log("bench %s, conf.sorted_gather on, captured: kernels per replayed "
        "step %s, device busy %.4f ms per step, first loss %.7f (unsorted "
        "%.7f, limit %g relative)"
        % (name, {k: v for k, v in work.items() if v}, busy,
           first["losses"][0], el[0], SORTED_LOSS_RTOL))
    rows["sweep_aggregate"] = {"bench_%s_sorted_launches_per_step" % name:
                               work["sweep_aggregate"]}
    return rows, graph


# ---------------------------------------------------------------------------
# Phase 12: the bipartite u2i path at the 61M-edge bipartite store
# ---------------------------------------------------------------------------

# draws per seed of the negative-rate check: enough that the expected
# count of true neighbours among soft_in_degree draws is tens (at
# FAMILY_DEGREE edges a node)
NEG_RATE_DRAWS = 4096
# steps of LocalTrainer.train at this store (after 2 of warm-up)
BIPARTITE_TRAIN_STEPS = 10
# Phases 12-14 build their stores at CFG_SCALE's node counts and widths
# with this many edges a node (CFG_SCALE: 25): the host builds of those
# stores set the smoke's wall (PERF.md section 5); cut from 8 to keep the
# smoke well inside its time on slow hosts
FAMILY_DEGREE = 4


def neighbour_mass(torch, et, seeds):
    """[b] f64: for each seed, the share of the ``outNeg`` in-degree pool's
    mass that falls on the seed's distinct out-neighbours, the chance that
    one ``soft_in_degree`` draw is a true neighbour (an ``in_degree`` draw
    of R rounds is one with the chance of its R-th power)."""
    from graph_learn_tpu_torch.ops.segment import row_bounds
    csr, pool, cdf = et.out, et.unique_dst, et.unique_dst_indeg_cdf
    start, end, deg = row_bounds(csr.row_offsets, seeds.long())
    width = max(int(deg.max()), 1)
    pos = start[:, None] + torch.arange(width, device=seeds.device)[None, :]
    valid = pos < end[:, None]
    nbr = csr.nbr_ids_sorted[torch.clamp(pos, max=csr.num_edges - 1).long()]
    # the row's id-sorted copy lists a repeated edge's id more than once
    first = torch.ones_like(valid)
    first[:, 1:] = nbr[:, 1:] != nbr[:, :-1]
    at = torch.clamp(torch.searchsorted(pool, nbr.contiguous()), max=pool.numel() - 1)
    cdf64 = cdf.double()
    mass = cdf64[at] - torch.where(at > 0, cdf64[torch.clamp(at - 1, min=0)],
                                   0.0)
    return torch.where(valid & first & (pool[at] == nbr), mass, 0.0).sum(1)


def negative_rates(torch, et, seeds, generator, k=NEG_RATE_DRAWS):
    """{strategy: (true neighbours among the ``b * k`` draws, the count
    :func:`neighbour_mass` predicts)} for ``soft_in_degree`` and
    ``in_degree`` (R = ``conf.sampling_retry_times + 1`` rounds)."""
    from graph_learn_tpu_torch.config import conf
    from graph_learn_tpu_torch.ops.negative import negative_sample
    from graph_learn_tpu_torch.ops.segment import row_member
    p = neighbour_mass(torch, et, seeds)
    rounds = conf.sampling_retry_times + 1
    out = {}
    for strategy, power in (("soft_in_degree", 1), ("in_degree", rounds)):
        ids = negative_sample(et, seeds, k, generator, strategy=strategy)
        hits = int(row_member(et.out, seeds, ids).sum())
        out[strategy] = (hits, float(k * (p ** power).sum()))
    return out


def rate_agrees(hits, expected):
    """A Poisson count within five standard deviations (and one) of its
    mean."""
    return abs(hits - expected) <= 5.0 * expected ** 0.5 + 1.0


def bipartite_path(torch, card, gather, spmm, sweep):
    """``examples/family_scale.py``'s bipartite family at its full store
    (1.225M users and items, ``FAMILY_DEGREE`` weighted edges a node, the
    "full" profile):
    the store build timed; one step of the towers on the kernels against
    the plain versions; the negatives checked; LocalTrainer.train over the
    port's bipartite_sage; the K-step form eager and captured; then phase
    18 (``categorical_path``) on the same store.  Returns the kernels
    line's fields of both."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.config import conf
    from graph_learn_tpu_torch.examples import bipartite_sage as bs
    from graph_learn_tpu_torch.examples import family_scale as fs
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.gsl.dataset import Dataset
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from torch.profiler import ProfilerActivity, profile

    cfg = dict(bench.CFG_SCALE, avg_degree=FAMILY_DEGREE)
    k1, n_neg = fs.fanout(False)
    b, d, hidden = cfg["batch"], cfg["feat_dim"], cfg["hidden"]
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}
    t0 = time.perf_counter()
    graph = fs.build_graph(cfg, "cuda")
    draw_s = time.perf_counter() - t0
    g, udec, idec = graph
    q = fs.build_query(g, b, k1, n_neg)
    t0 = time.perf_counter()
    tables = q.device_tables()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    csr_s = sum(g.store.edge_table(t).host_build_s for t in fs.EDGE_TYPES)
    n_ui = g.store.edge_table("u-i").num_edges
    n_ii = g.store.edge_table("i-i").num_edges
    et = tables["edges"]["u-i"]
    want_ui = int(cfg["n_nodes"] * FAMILY_DEGREE * 0.67)
    check(n_ui == want_ui and n_ii == cfg["n_nodes"] * FAMILY_DEGREE - want_ui
          and et.inc is not None and et.unique_dst is not None
          and et.out.cum_weights is not None,
          "bipartite store: not the full-profile %d + %d-edge store"
          % (want_ui, cfg["n_nodes"] * FAMILY_DEGREE - want_ui))
    log("bipartite store (%d users, %d items, %d u-i + %d i-i weighted "
        "edges, %d bf16 features, full profile): host draw %.1f s, CSR and "
        "candidate-pool build %.1f s (both directions of both edge types), "
        "upload %.1f s, tables %.3f GB on the card; u-i pool %d distinct "
        "items; card: %s"
        % (g.store.node_table("u").num_nodes, g.store.node_table("i").num_nodes,
           n_ui, n_ii, d, draw_s, csr_s, tables_s - csr_s,
           nbytes(tables) / 1e9, et.unique_dst.numel(), card))

    # 1. one step of the towers on the kernels against the plain versions
    model = bs.towers(udec, idec, hidden, "cuda")
    batch = Dataset(q, window=1, device="cuda").next()
    table = tables["nodes"]["i"].float_attrs
    feats = {"u": tables["nodes"]["u"].float_attrs, "i": table}

    def embeddings(bt, defer=None):
        src, dst, neg = bs.egos(bt, defer)
        return [model["u"](src), model["i"](dst), model["i"](neg)]

    def loss_and_grads(bt, defer=None):
        embs = embeddings(bt, defer)
        loss = bs.unsupervised_softmax_cross_entropy_loss(*embs)
        return embs, loss, torch.autograd.grad(loss,
                                               list(model.parameters()))

    plain = {a: v.replace(float_attrs=feats[v.type_name][v.ids.long()])
             for a, v in batch.items() if a != "seed"}
    ref = loss_and_grads(plain)
    worst = {}
    for form, defer in (("gathered", None), ("deferred", table)):
        for c in counters.values():
            c.reset()
        got = loss_and_grads(batch, defer)
        launches = {kn: c.count for kn, c in counters.items()}
        want = ({"gather_rows": 6, "segment_spmm": 0, "sweep_aggregate": 0}
                if defer is None else
                {"gather_rows": 3, "segment_spmm": 3, "sweep_aggregate": 0})
        check(launches == want, "bipartite step, %s: launches %s, expected "
              "%s" % (form, launches, want))
        lk, lp = got[1].item(), ref[1].item()
        check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), "bipartite step, %s: "
              "loss %g on the kernels, %g on the plain versions"
              % (form, lk, lp))
        rel = 0.0
        for x, y in zip(list(got[0]) + list(got[2]),
                        list(ref[0]) + list(ref[2])):
            r = (x - y).abs().max().item() / max(y.abs().max().item(), 1e-12)
            rel = max(rel, r)
        check(rel <= STEP_GRAD_TOL, "bipartite step, %s: an embedding or "
              "gradient off by %g of its largest value" % (form, rel))
        worst[form] = (lk, lp, rel)
    log("bipartite towers (EgoSAGEConv mean, %d -> %d, batch %d, k1 %d, %d "
        "negatives): one step on the kernels against the plain versions: "
        "gathered hops (6 gather_rows) loss %.6f vs %.6f, deferred hops (3 "
        "gather_rows + 3 segment_spmm) loss %.6f vs %.6f (limit %g "
        "relative); worst embedding or gradient error %.3g / %.3g of the "
        "tensor's largest value (limit %g)"
        % (d, hidden, b, k1, n_neg, worst["gathered"][0],
           worst["gathered"][1], worst["deferred"][0], worst["deferred"][1],
           STEP_LOSS_RTOL, worst["gathered"][2], worst["deferred"][2],
           STEP_GRAD_TOL))

    # 2. the negatives: random ones from the pool, in_degree ones rejected
    neg = batch["neg"].ids
    check(tuple(neg.shape) == (b, n_neg)
          and bool(torch.isin(neg, et.unique_dst).all()),
          "bipartite: a random negative outside the u-i pool")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rates = negative_rates(torch, et, batch["src"].ids, gen)
    for strategy, (hits, expected) in rates.items():
        check(rate_agrees(hits, expected), "bipartite %s negatives: %d true "
              "neighbours among %d draws, %.2f expected"
              % (strategy, hits, b * NEG_RATE_DRAWS, expected))
    log("bipartite negatives: the batch's %d random negatives all in the "
        "u-i pool; true neighbours among %d draws: soft_in_degree %d "
        "(%.2f expected), in_degree with %d rounds %d (%.3g expected)"
        % (neg.numel(), b * NEG_RATE_DRAWS, rates["soft_in_degree"][0],
           rates["soft_in_degree"][1],
           conf.sampling_retry_times + 1, rates["in_degree"][0],
           rates["in_degree"][1]))

    # 3. LocalTrainer.train over bipartite_sage's query and loss
    tq = bs.build_query(g, b, [k1])
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    tr = LocalTrainer(seed=0, device="cuda")
    losses, stamps = [], []

    def loss_fn(m, bt, generator, training):
        stamps.append(time.perf_counter())
        loss = bs.loss_fn(m, bt, generator, training)
        losses.append(loss.detach())
        return loss

    def train(n):
        """(seconds from the call to its first step: the call's set-up,
        above all the epoch's permutation of the u-i seed edges, and the
        first batch; ms per step from the first step to the last)."""
        del losses[:], stamps[:]
        t0 = time.perf_counter()
        tr.train(tq, model, loss_fn, opt, epochs=1, steps_per_epoch=n,
                 verbose=False)
        torch.cuda.synchronize()
        return (stamps[0] - t0,
                (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3)

    train(2)  # warm-up
    for c in counters.values():
        c.reset()
    n = BIPARTITE_TRAIN_STEPS
    setup_s, step_ms = train(n)
    tr_launches = {kn: c.count / n for kn, c in counters.items()}
    check(tr_launches == {"gather_rows": 6.0, "segment_spmm": 0.0,
                          "sweep_aggregate": 0.0},
          "bipartite LocalTrainer: launches per step %s; want 6 gather_rows"
          % tr_launches)
    check(len(losses) == n and bool(torch.isfinite(torch.stack(losses))
                                    .all()),
          "bipartite LocalTrainer: %d losses or one not finite" % len(losses))
    first, last = losses[0].item(), losses[-1].item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_step_ms = train(5)
    busy = sum(device_ms_by_kernel(prof).values()) / 5
    edges = b * (2 * k1 + n_neg * (1 + k1))
    log("bipartite LocalTrainer.train (bipartite_sage, shuffle over %d u-i "
        "edges): %.3f s from the call to its first step (the epoch's seed "
        "permutation and the first batch), then %d steps of batch %d, %.3f "
        "ms per step on the host clock (%.3f ms under the profiler), %.4g "
        "edges/s (%d sampled edges a step); loss %.4f -> %.4f; launches per "
        "step %s; device busy %.3f ms per step (%.1f%%); card: %s"
        % (n_ui, setup_s, n, b, step_ms, prof_step_ms,
           edges / step_ms * 1e3, edges, first, last,
           {k: v for k, v in tr_launches.items() if v}, busy,
           100.0 * busy / step_ms, card))
    del model, opt, tr, losses

    # 4. the K-step form, eager then captured, from the same state
    K = cfg["scan_steps"]
    for c in counters.values():
        c.reset()
    eager = fs.run_bipartite(cfg, device="cuda", capture=False, graph=graph)
    launches = {kn: c.count for kn, c in counters.items()}
    n_steps = (1 + eager["rounds"]) * K
    # the first batch's loss, then every step
    want = {"gather_rows": 3 * (n_steps + 1),
            "segment_spmm": 3 * (n_steps + 1), "sweep_aggregate": 0}
    check(launches == want, "bipartite K-step eager: launches %s, expected "
          "%s" % (launches, want))
    captured = fs.run_bipartite(cfg, device="cuda", capture=True, graph=graph)
    el, gl_ = np.asarray(eager["losses"]), np.asarray(captured["losses"])
    check(el.shape == gl_.shape == (n_steps,)
          and bool(np.isfinite(gl_).all()), "bipartite K-step: %s eager and "
          "%s graph losses, or one not finite" % (el.shape, gl_.shape))
    check(np.array_equal(el, gl_), "bipartite K-step: the graph's losses "
          "differ from the eager ones from the same state: max relative %g"
          % np.max(np.abs(el - gl_) / np.abs(el)))
    for pe, pg in zip(eager["model"].parameters(),
                      captured["model"].parameters()):
        check(torch.equal(pe, pg) and bool(torch.isfinite(pg).all()),
              "bipartite K-step: eager and graph parameters differ")
    step = captured["step"]
    seeds0 = step.graph_seeds[0].clone()
    step()
    seeds1 = step.graph_seeds[0]
    check(not torch.equal(seeds0, seeds1) and int(seeds1.min()) >= 0
          and int(seeds1.max()) < n_ui,
          "bipartite K-step: two replays drew the same seed edges")
    graph_work, graph_busy, by_name = bench_work(torch, step, K, 2)
    check(graph_work == {"gather_rows": 3.0, "segment_spmm": 3.0,
                         "sweep_aggregate": 0.0},
          "bipartite K-step: kernels per replayed step %s; want 3 "
          "gather_rows and 3 segment_spmm" % graph_work)
    eager_work, eager_busy, _ = bench_work(torch, step.run_eager, K, 1)
    check(eager_work == graph_work, "bipartite K-step: kernels per eager "
          "step %s, per replayed step %s" % (eager_work, graph_work))
    log("bipartite K-step (family_scale run_bipartite, K = %d, %d steps after "
        "1 warm-up call, %d sampled edges a step): eager %.4f ms per step "
        "(%.4g edges/s, device busy %.4f ms, %.1f%%), CUDA graph %.4f ms per "
        "step (%.4g edges/s, device busy %.4f ms, %.1f%%); capture %.3f s, "
        "graph pool %.1f MB; %d losses bit-equal eager and captured (%.4f -> "
        "%.4f); kernels per replayed step %s; peak allocated %.3f GB; card: "
        "%s"
        % (K, captured["rounds"] * K, edges, eager["step_ms"],
           eager["edges_per_s"], eager_busy,
           100.0 * eager_busy / eager["step_ms"], captured["step_ms"],
           captured["edges_per_s"], graph_busy,
           100.0 * graph_busy / captured["step_ms"], captured["capture_s"],
           captured["graph_pool_bytes"] / 1e6, n_steps, gl_[0], gl_[-1],
           {k: v for k, v in graph_work.items() if v},
           captured["device_bytes_peak"] / 1e9, card))
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log("  device %.4f ms per replayed step: %s" % (ms, kname[:90]))
    rows = {k: {"bipartite_launches_per_step": graph_work[k],
                "bipartite_trainer_launches_per_step": tr_launches[k]}
            for k in ("gather_rows", "segment_spmm")}
    # phase 18 on this store, before it is freed
    del eager, captured, step, tables, batch, plain, ref, feats, table, et
    gc.collect()
    torch.cuda.empty_cache()
    for k, fields in categorical_path(torch, card, gather, spmm, sweep,
                                      graph).items():
        rows[k].update(fields)
    return rows


# ---------------------------------------------------------------------------
# Phase 18 (inside phase 12): categorical items and conditional negatives
# ---------------------------------------------------------------------------

# the item table's categorical columns: a category of CAT_VALUES values
# drawn with probability 1 / (rank + 1), a brand "brand_<j>" (j uniform in
# [0, CAT_BRANDS)) hashed into CAT_BUCKETS, and 0 to CAT_MAX_TAGS tags
# "tag_<t>" (t uniform in [0, CAT_TAGS)) hashed into CAT_BUCKETS; each
# embedded CAT_DIM wide
CAT_VALUES, CAT_BRANDS, CAT_TAGS, CAT_MAX_TAGS = 1000, 50_000, 5_000, 8
CAT_BUCKETS, CAT_DIM = 10_000, 16
CAT_TYPES = [("int", CAT_VALUES), ("string", CAT_BUCKETS),
             ("string", CAT_BUCKETS, True)]
# one negative of the two by the positive's category, one free
CAT_COND = {"int_cols": [0], "int_props": [0.5]}
# Kernel 1 at every item-table row count of the step: the positives'
# 1 024, the negatives' 2 048, the positives' hops' 10 240 and the
# negatives' hops' 20 480
CAT_GATHER_ROWS = (1_024, 2_048, 10_240, 20_480)
# draws of the chi-square check in the heaviest category, its bins, and
# the seed edges (each with one retry-free draw) of the relaxation check
CAT_CHI_DRAWS, CAT_CHI_BINS, CAT_RELAX_ROWS = 1 << 21, 100, 1 << 16
CAT_TRAIN_STEPS = 10


def category_draw(n, n_values, rng):
    """[n] int64 categories in [0, n_values), value r drawn with
    probability proportional to 1 / (r + 1)."""
    p = 1.0 / np.arange(1, n_values + 1)
    return rng.choice(n_values, size=n, p=p / p.sum())


def categorical_strings(n, seed):
    """The items' attribute strings ``"<category>:brand_<j>:<tag>,..."``,
    drawn from ``np.random.default_rng(seed)``, and the categories."""
    rng = np.random.default_rng(seed)
    cat = category_draw(n, CAT_VALUES, rng)
    brand = rng.integers(0, CAT_BRANDS, n)
    n_tags = rng.integers(0, CAT_MAX_TAGS + 1, n)
    tags = ["tag_%d" % t for t in rng.integers(0, CAT_TAGS,
                                              int(n_tags.sum())).tolist()]
    ends = np.cumsum(n_tags).tolist()
    starts = [0] + ends[:-1]
    strs = ["%d:brand_%d:%s" % (c, b_, ",".join(tags[lo:hi]))
            for c, b_, lo, hi in zip(cat.tolist(), brand.tolist(), starts,
                                     ends)]
    return strs, cat


def chi_square_p(obs, exp):
    """The chi-square p-value of counts ``obs`` against ``exp`` (same
    total) by the Wilson-Hilferty normal approximation of the chi-square
    tail, close for the tens of degrees of freedom of a binned CDF."""
    obs, exp = np.asarray(obs, np.float64), np.asarray(exp, np.float64)
    stat = float(((obs - exp) ** 2 / exp).sum())
    dof = obs.size - 1
    z = ((stat / dof) ** (1.0 / 3) - (1 - 2.0 / (9 * dof))) \
        / math.sqrt(2.0 / (9 * dof))
    return 0.5 * math.erfc(z / math.sqrt(2))


def relaxed_rows(bad, forced):
    """(rows holding a rejected negative, rows whose draws had fewer
    acceptable candidates than their quota, whether the two sets are the
    same) of [b, k] ``bad`` and [b] ``forced`` (numpy bools): a row takes a
    rejected draw exactly when it had to relax."""
    bad_rows = np.asarray(bad).any(axis=1)
    forced = np.asarray(forced)
    return (int(bad_rows.sum()), int(forced.sum()),
            bool(np.array_equal(bad_rows, forced)))


def categorical_path(torch, card, gather, spmm, sweep, graph):
    """Categorical items and conditional negatives on the bipartite
    store: the item table swapped for one with the same ids and float
    features plus a category, a brand and tags (``categorical_strings``
    through ``core/ingest.py _parse_attrs``), the towers' item encoders
    embedding them, the negatives drawn one by the positive's category and
    one free.  Checks one batch's negatives, the relaxation rule, the
    in-run CDF, one step against the plain versions, LocalTrainer.train
    and the K-step form eager and captured; times Kernel 1 at the towers'
    row counts of the item table.  Returns the kernels line's fields."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.core.ingest import _parse_attrs
    from graph_learn_tpu_torch.core.schema import Decoder
    from graph_learn_tpu_torch.core.store import NodeTable
    from graph_learn_tpu_torch.examples import bipartite_sage as bs
    from graph_learn_tpu_torch.examples import family_scale as fs
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.gsl.dataset import Dataset
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from graph_learn_tpu_torch.ops import conditional as cond_ops
    from graph_learn_tpu_torch.ops.negative import uniform_ids
    from graph_learn_tpu_torch.ops.segment import row_member
    from torch.profiler import ProfilerActivity, profile

    cfg = bench.CFG_SCALE
    k1, n_neg = fs.fanout(False)
    b, d, hidden = cfg["batch"], cfg["feat_dim"], cfg["hidden"]
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}
    g, udec, _ = graph
    old = g.store.node_table("i")
    n_i = old.num_nodes
    t0 = time.perf_counter()
    strs, cats = categorical_strings(n_i, seed=12)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ia, _, mv, ml = _parse_attrs(strs, Decoder(
        attr_types=CAT_TYPES, attr_dims=[CAT_DIM] * 3,
        multival_max_len=CAT_MAX_TAGS))
    parse_s = time.perf_counter() - t0
    del strs
    check(np.array_equal(ia[:, 0], cats) and ia.shape == (n_i, 2)
          and mv.shape == (n_i, 1, CAT_MAX_TAGS)
          and int(ml.min()) == 0 and int(ml.max()) == CAT_MAX_TAGS,
          "categorical: the parsed columns are not the drawn ones")
    runs = np.bincount(cats, minlength=CAT_VALUES)
    idec = Decoder(attr_types=["float"] * d + CAT_TYPES,
                   attr_dims=[None] * d + [CAT_DIM] * 3,
                   multival_max_len=CAT_MAX_TAGS)
    g.add_node_table(NodeTable("i", idec, old.raw_ids, int_attrs=ia,
                               float_attrs=old.float_attrs,
                               multival_attrs=mv, multival_lens=ml))
    del old
    gc.collect()
    q = fs.build_query(g, b, k1, n_neg, CAT_COND)
    t0 = time.perf_counter()
    tables = q.device_tables()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    nt, et = tables["nodes"]["i"], tables["edges"]["u-i"]
    ct = next(iter(tables["cond"].values()))
    cat_bytes = sum(nbytes(t) for t in (nt.int_attrs, nt.multival_attrs,
                                        nt.multival_lens))
    log("categorical items (%d items, 100 bf16 features + category of %d "
        "values with runs of %d to %d items, brand hashed from %d strings "
        "and 0-%d tags, into %d buckets, each embedded %d wide): host draw "
        "%.1f s, _parse_attrs %.1f s, item table and condition table on the "
        "card %.1f s; the new columns %.1f MB, the condition table %.1f MB; "
        "card: %s"
        % (n_i, CAT_VALUES, runs.min(), runs.max(), CAT_BRANDS,
           CAT_MAX_TAGS, CAT_BUCKETS, CAT_DIM, draw_s, parse_s, tables_s,
           cat_bytes / 1e6, nbytes(tables["cond"]) / 1e6, card))

    # 1. one batch: conditioned negatives share the positive's category;
    # rejected negatives only in rows that had to relax
    batch = Dataset(q, window=1, device="cuda").next()
    neg, pos, seeds = batch["neg"].ids, batch["dst"].ids, batch["src"].ids
    cat_dev = nt.int_attrs[:, 0]
    same = cat_dev[neg[:, 0].long()] == cat_dev[pos.long()]
    check(tuple(neg.shape) == (b, n_neg) and bool(same.all()),
          "categorical: %d of %d conditioned negatives outside their "
          "positive's category" % (int((~same).sum()), b))
    bad = row_member(et.out, seeds, neg) | (neg == pos[:, None])
    batch_relaxed = int(bad.any(dim=1).sum())
    free_same = float((cat_dev[neg[:, 1].long()]
                       == cat_dev[pos.long()]).float().mean())
    # the rule on the card, on draws made to be rejected: 65 536 seed
    # edges, two candidates a part; each part's first candidate is the
    # positive itself (the category part's by a run draw aimed at it), and
    # in every 5th row (category part) and every 7th row (free part) the
    # second too, so those rows must relax
    col = ct.int_cols[0]
    inv = torch.empty_like(col.perm)
    inv[col.perm.long()] = torch.arange(col.perm.numel(), dtype=torch.int32,
                                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    n_r = CAT_RELAX_ROWS
    e_ids = torch.randint(0, et.num_edges, (n_r,), generator=gen,
                          device="cuda", dtype=torch.int32)
    s_, p_ = et.src[e_ids.long()], et.dst[e_ids.long()]
    pia = nt.int_attrs[p_.long()]
    lo_p = torch.searchsorted(col.vals_sorted, pia[:, 0].contiguous())
    hi_p = torch.searchsorted(col.vals_sorted, pia[:, 0].contiguous(),
                              side="right")
    aim = ((inv[p_.long()] - lo_p).double() + 0.5) / (hi_p - lo_p).double()
    r_ix = torch.arange(n_r, device="cuda")
    u = torch.rand((n_r, 2), generator=gen, device="cuda")
    u[:, 0] = aim.float()
    u[r_ix % 5 == 0, 1] = aim.float()[r_ix % 5 == 0]
    fb = uniform_ids(et.unique_dst, (n_r, 2), gen)
    free = uniform_ids(et.unique_dst, (n_r, 2), gen)
    free[:, 0] = p_
    free[r_ix % 7 == 0, 1] = p_[r_ix % 7 == 0]
    with bench.bench_conf(sampling_retry_times=1):
        negs = cond_ops.conditional_negative_sample_draw(
            et, ct, s_, p_, pia, None, n_neg, CAT_COND["int_cols"],
            CAT_COND["int_props"], [], [], [(fb, u)], free)
    cands = [cond_ops._sample_matching(col, pia[:, 0], u, fb), free]
    check(torch.equal(cands[0][:, 0], p_), "categorical relaxation: a run "
          "draw aimed at the positive missed it")
    want, forced = [], torch.zeros(n_r, dtype=torch.bool, device="cuda")
    for c in cands:
        ok = ~(row_member(et.out, s_, c) | (c == p_[:, None]))
        # the first acceptable candidate, else the first
        pick = torch.where(ok.any(dim=1), torch.argmax(ok.to(torch.uint8),
                                                       dim=1), 0)
        want.append(torch.gather(c, 1, pick[:, None]))
        forced |= ~ok.any(dim=1)
    check(torch.equal(negs, torch.cat(want, dim=1)), "categorical "
          "relaxation: the negatives are not each part's first acceptable "
          "candidate (else its first)")
    neg_bad = row_member(et.out, s_, negs) | (negs == p_[:, None])
    n_bad, n_forced, same_rows = relaxed_rows(neg_bad.cpu().numpy(),
                                              forced.cpu().numpy())
    check(same_rows and n_forced >= n_r // 5, "categorical relaxation: %d "
          "rows hold a rejected negative, %d rows had to relax; want the "
          "same rows, at least %d" % (n_bad, n_forced, n_r // 5))
    # the in-run CDF: draws in the heaviest category, binned by position
    heavy = int(np.argmax(runs))
    hv = torch.full((CAT_CHI_DRAWS,), heavy, dtype=torch.int32,
                    device="cuda")
    drawn = cond_ops._sample_matching(
        col, hv, torch.rand((CAT_CHI_DRAWS, 1), generator=gen,
                            device="cuda"),
        torch.full((CAT_CHI_DRAWS, 1), -1, dtype=torch.int32,
                   device="cuda"))[:, 0]
    lo = int(torch.searchsorted(col.vals_sorted, hv[:1]))
    at = (inv[drawn.long()] - lo).long()
    n_run = int(runs[heavy])
    check(int(at.min()) >= 0 and int(at.max()) < n_run,
          "categorical: a draw in category %d left its run" % heavy)
    edges = np.linspace(0, n_run, CAT_CHI_BINS + 1).astype(np.int64)
    obs = np.histogram(at.cpu().numpy(), bins=edges)[0]
    exp = CAT_CHI_DRAWS * np.diff(edges) / n_run
    p_value = chi_square_p(obs, exp)
    check(p_value > 1e-4, "categorical: draws in category %d off its run's "
          "CDF, chi-square p %.3g" % (heavy, p_value))
    log("categorical negatives (%d a seed, base random, one by the "
        "positive's category, one free): the batch's %d conditioned "
        "negatives all share their positive's category (the free ones "
        "%.1f%%); %d of %d rows hold a true neighbour or the positive; the "
        "relaxation rule on %d seed edges with two candidates a part, each "
        "part's first the positive: every negative its part's first "
        "acceptable candidate, %d rows had to relax and exactly those %d "
        "hold a rejected negative; %d "
        "draws in the heaviest category (%d items) over %d bins of its run: "
        "chi-square p %.3g"
        % (n_neg, b, 100 * free_same, batch_relaxed, b, CAT_RELAX_ROWS,
           n_forced, n_bad, CAT_CHI_DRAWS, n_run, CAT_CHI_BINS, p_value))

    # 2. one step of the towers on the kernels against the plain versions
    model = bs.towers(udec, idec, hidden, "cuda")
    tabs = {"u": tables["nodes"]["u"].float_attrs, "i": nt.float_attrs}

    def loss_and_grads(bt):
        src, dst, ng = bs.egos(bt)
        embs = [model["u"](src), model["i"](dst), model["i"](ng)]
        loss = bs.unsupervised_softmax_cross_entropy_loss(*embs)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    plain = {a: v.replace(float_attrs=tabs[v.type_name][v.ids.long()])
             for a, v in batch.items() if a != "seed"}
    ref = loss_and_grads(plain)
    for c in counters.values():
        c.reset()
    got = loss_and_grads(batch)
    launches = {kn: c.count for kn, c in counters.items()}
    check(launches == {"gather_rows": 6, "segment_spmm": 0,
                       "sweep_aggregate": 0},
          "categorical step: launches %s; want 6 gather_rows" % launches)
    lk, lp = got[0].item(), ref[0].item()
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), "categorical step: loss "
          "%g on the kernels, %g on the plain versions" % (lk, lp))
    names = [n for n, _ in model.named_parameters()]
    rel, emb_rel = 0.0, 0.0
    for name, x, y in zip(names, got[1], ref[1]):
        r = (x - y).abs().max().item() / max(y.abs().max().item(), 1e-12)
        rel = max(rel, r)
        if "embedding" in name:
            emb_rel = max(emb_rel, r)
    check(rel <= STEP_GRAD_TOL, "categorical step: a gradient off by %g of "
          "its largest value" % rel)
    n_emb = sum(1 for n in names if "embedding" in n)
    log("categorical towers (EgoSAGEConv mean, user (100, 148) and item "
        "(148, 148) -> %d, %d embedding tables): one step on the kernels "
        "against the plain versions: loss %.6f vs %.6f (limit %g relative), "
        "worst gradient error %.3g of the tensor's largest value, %.3g on "
        "the embedding tables (limit %g); 6 gather_rows, 0 segment_spmm"
        % (hidden, n_emb, lk, lp, STEP_LOSS_RTOL, rel, emb_rel,
           STEP_GRAD_TOL))

    # 3. LocalTrainer.train over the conditional query
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    tr = LocalTrainer(seed=0, device="cuda")
    losses, stamps = [], []

    def loss_fn(m, bt, generator, training):
        stamps.append(time.perf_counter())
        loss = bs.loss_fn(m, bt, generator, training)
        losses.append(loss.detach())
        return loss

    def train(n_steps):
        del losses[:], stamps[:]
        tr.train(q, model, loss_fn, opt, epochs=1, steps_per_epoch=n_steps,
                 verbose=False)
        torch.cuda.synchronize()
        return (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3

    train(2)  # warm-up
    tables_before = {n: p.detach().clone() for n, p in
                     model.named_parameters() if "embedding" in n}
    for c in counters.values():
        c.reset()
    step_ms = train(CAT_TRAIN_STEPS)
    tr_launches = {kn: c.count / CAT_TRAIN_STEPS
                   for kn, c in counters.items()}
    check(tr_launches == {"gather_rows": 6.0, "segment_spmm": 0.0,
                          "sweep_aggregate": 0.0},
          "categorical LocalTrainer: launches per step %s; want 6 "
          "gather_rows" % tr_launches)
    check(len(losses) == CAT_TRAIN_STEPS
          and bool(torch.isfinite(torch.stack(losses)).all()),
          "categorical LocalTrainer: %d losses or one not finite"
          % len(losses))
    moved = [n for n, p in model.named_parameters()
             if n in tables_before and not torch.equal(p.detach(),
                                                       tables_before[n])]
    check(sorted(moved) == sorted(tables_before), "categorical "
          "LocalTrainer: embedding tables that did not move: %s"
          % sorted(set(tables_before) - set(moved)))
    first, last = losses[0].item(), losses[-1].item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_step_ms = train(5)
    busy = sum(device_ms_by_kernel(prof).values()) / 5
    edges = b * (2 * k1 + n_neg * (1 + k1))
    log("categorical LocalTrainer.train (bs.loss_fn on the conditional "
        "query): %d steps of batch %d, %.3f ms per step on the host clock "
        "(%.3f ms under the profiler), %.4g edges/s (%d sampled edges a "
        "step); loss %.4f -> %.4f; every embedding table moved; launches "
        "per step %s; device busy %.3f ms per step (%.1f%%); card: %s"
        % (CAT_TRAIN_STEPS, b, step_ms, prof_step_ms, edges / step_ms * 1e3,
           edges, first, last, {k: v for k, v in tr_launches.items() if v},
           busy, 100.0 * busy / step_ms, card))
    del model, opt, tr, losses, batch, plain, ref, got
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the K-step form, eager then captured, from the same state
    K = cfg["scan_steps"]
    eager = fs.run_bipartite(cfg, device="cuda", capture=False,
                             graph=(g, udec, idec), condition=CAT_COND)
    captured = fs.run_bipartite(cfg, device="cuda", capture=True,
                                graph=(g, udec, idec), condition=CAT_COND)
    el, gl_ = np.asarray(eager["losses"]), np.asarray(captured["losses"])
    n_steps = (1 + eager["rounds"]) * K
    check(el.shape == gl_.shape == (n_steps,)
          and bool(np.isfinite(gl_).all()), "categorical K-step: %s eager "
          "and %s graph losses, or one not finite" % (el.shape, gl_.shape))
    check(np.array_equal(el, gl_), "categorical K-step: the graph's losses "
          "differ from the eager ones from the same state: max relative %g"
          % np.max(np.abs(el - gl_) / np.abs(el)))
    step = captured["step"]
    graph_work, graph_busy, by_name = bench_work(torch, step, K, 2)
    check(graph_work == {"gather_rows": 6.0, "segment_spmm": 0.0,
                         "sweep_aggregate": 0.0},
          "categorical K-step: kernels per replayed step %s; want 6 "
          "gather_rows" % graph_work)
    eager_work, eager_busy, _ = bench_work(torch, step.run_eager, K, 1)
    check(eager_work == graph_work, "categorical K-step: kernels per eager "
          "step %s, per replayed step %s" % (eager_work, graph_work))
    log("categorical K-step (family_scale run_bipartite with CAT_COND, K = "
        "%d, %d steps after 1 warm-up call, %d sampled edges a step): eager "
        "%.4f ms per step (%.4g edges/s, device busy %.4f ms, %.1f%%), CUDA "
        "graph %.4f ms per step (%.4g edges/s, device busy %.4f ms, %.1f%%); "
        "capture %.3f s, graph pool %.1f MB; %d losses bit-equal eager and "
        "captured (%.4f -> %.4f); kernels per replayed step %s; card: %s"
        % (K, captured["rounds"] * K, edges, eager["step_ms"],
           eager["edges_per_s"], eager_busy,
           100.0 * eager_busy / eager["step_ms"], captured["step_ms"],
           captured["edges_per_s"], graph_busy,
           100.0 * graph_busy / captured["step_ms"], captured["capture_s"],
           captured["graph_pool_bytes"] / 1e6, n_steps, gl_[0], gl_[-1],
           {k: v for k, v in graph_work.items() if v}, card))
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log("  device %.4f ms per replayed step: %s" % (ms, kname[:90]))
    del eager, captured, step
    gc.collect()
    torch.cuda.empty_cache()

    # 5. Kernel 1 at the towers' row counts of the item table, cold
    shapes = gather_shapes(torch, gather, nt.float_attrs, gen,
                           "at the categorical item table",
                           rows=CAT_GATHER_ROWS, yardsticks=CAT_GATHER_ROWS)
    rows = {k: {"cond_launches_per_step": graph_work[k],
                "cond_trainer_launches_per_step": tr_launches[k]}
            for k in ("gather_rows", "segment_spmm")}
    for m, f in shapes.items():
        rows["gather_rows"].update({
            "cold_ms_cond_%d" % m: f["ms"], "bound_ms_cond_%d" % m:
            f["bound_ms"], "plain_cold_ms_cond_%d" % m: f["plain_ms"],
            "library_cold_ms_cond_%d" % m: f["library_ms"],
            "kernel_route_cond_%d" % m: f["route"]})
    return rows


# ---------------------------------------------------------------------------
# Phase 13: the rgcn family at the two-relation store
# ---------------------------------------------------------------------------

# steps of LocalTrainer.train at this store (after 2 of warm-up)
RGCN_TRAIN_STEPS = 10
# Kernel 1's row counts on the rgcn path besides the src's 1 024: the two
# level-1 hops (10 240 each) and, gathered, the four deepest (51 200 each)
RGCN_GATHER_ROWS = (10_240, 51_200)
# the two routes of one batch: the deepest level's means in f32 from the
# same bf16 rows, summed in other orders
RGCN_ROUTE_RTOL = 1e-5


def rgcn_path(torch, card, gather, spmm, sweep):
    """``examples/family_scale.py``'s rgcn family at its full store (2.45M
    items, two weighted relations of 30 625 000 edges, the "minimal"
    profile): the store build timed; one step on the kernels against the
    plain versions on both routes, and the routes against each other; the
    K-step form eager and captured on both routes, in the order deferred,
    gathered, gathered, deferred; LocalTrainer.train over the port's
    ego_rgcn example; Kernels 1-2 at the path's shapes.  Returns the
    kernels line's fields."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.core.schema import Mask
    from graph_learn_tpu_torch.examples import ego_rgcn as er
    from graph_learn_tpu_torch.examples import family_scale as fs
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.nn.data import PreAggregatedRows
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoRGCN
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from torch.profiler import ProfilerActivity, profile

    cfg = dict(bench.CFG_SCALE, avg_degree=FAMILY_DEGREE)
    nbrs = fs.rgcn_fanout(False)
    k1, k2 = nbrs
    R = len(er.RELS)
    n, b, d = cfg["n_nodes"], cfg["batch"], cfg["feat_dim"]
    dims = [d, cfg["hidden"], cfg["classes"]]
    edges = b * (R * k1 + R * R * k1 * k2)
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}
    per_step = {False: {"gather_rows": 1 + R + R * R, "segment_spmm": 0,
                        "sweep_aggregate": 0},
                True: {"gather_rows": 1 + R, "segment_spmm": R * R,
                       "sweep_aggregate": 0}}

    def launches():
        return {kn: c.count for kn, c in counters.items()}

    def reset():
        for c in counters.values():
            c.reset()

    t0 = time.perf_counter()
    graph = er.build_rgcn_graph(cfg, "cuda")
    draw_s = time.perf_counter() - t0
    g, dec = graph
    q, aliases = er.rgcn_query(g, Mask.NONE, b, nbrs)
    t0 = time.perf_counter()
    tables = q.device_tables()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    csr_s = sum(g.store.edge_table(r).host_build_s for r in er.RELS)
    table = tables["nodes"]["item"].float_attrs
    ets = [tables["edges"][r] for r in er.RELS]
    per_rel = n * FAMILY_DEGREE // 2
    check(all(g.store.edge_table(r).num_edges == per_rel
              and g.store.edge_table(r).weights is not None
              for r in er.RELS)
          and all(et.inc is None and et.out.num_edges == per_rel
                  for et in ets)
          and table.shape == (n, d) and table.dtype == torch.bfloat16,
          "rgcn store: not two weighted minimal-profile relations of "
          "%d edges over a [%d, %d] bf16 table" % (per_rel, n, d))
    log("rgcn store (%d items, %d bf16 features, %d classes; %s: %d "
        "weighted edges each, minimal profile): host draw %.1f s, CSR build "
        "%.1f s, upload %.1f s, tables %.3f GB on the card; card: %s"
        % (n, d, cfg["classes"], " and ".join(er.RELS), per_rel, draw_s,
           csr_s, tables_s - csr_s, nbytes(tables) / 1e9, card))

    # 1. one step on the kernels against the plain versions, both routes
    model = EgoRGCN(dims, dec, num_relations=R, num_bases=1, device="cuda")
    params = list(model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(13)
    with torch.no_grad():
        _, batch = bench.sample_one(q, tables, n, gen)
    deep = aliases[-R * R:]
    plain = {a: v.replace(float_attrs=table[v.ids.long()])
             for a, v in batch.items()}
    plain_on = dict(plain)
    for a in deep:
        plain_on[a] = batch[a].replace(float_attrs=PreAggregatedRows(
            table[batch[a].ids.long()].float().reshape(-1, k2, d).mean(1),
            "mean"))

    def step_of(bt):
        logits = model(er.make_ego(bt, aliases, nbrs))
        loss = supervised_softmax_loss(logits, bt["src"].labels)
        return logits, loss, torch.autograd.grad(loss, params)

    worst = {}
    for route, defer in (("gathered", False), ("deferred", True)):
        ref = step_of(plain_on if defer else plain)
        reset()
        with torch.no_grad():
            bt = (er.pre_aggregate_deepest(batch, aliases, table, R * R)
                  if defer else batch)
        got = step_of(bt)
        check(launches() == per_step[defer], "rgcn step, %s: launches %s, "
              "expected %s" % (route, launches(), per_step[defer]))
        lk, lp = got[1].item(), ref[1].item()
        check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), "rgcn step, %s: loss "
              "%g on the kernels, %g on the plain versions" % (route, lk, lp))
        rel = 0.0
        for x, y in zip([got[0]] + list(got[2]), [ref[0]] + list(ref[2])):
            rel = max(rel, (x - y).abs().max().item()
                      / max(y.abs().max().item(), 1e-12))
        check(rel <= STEP_GRAD_TOL, "rgcn step, %s: the logits or a gradient "
              "off by %g of its largest value" % (route, rel))
        worst[route] = (lk, lp, rel)
    l_off, l_on = worst["gathered"][0], worst["deferred"][0]
    check(abs(l_on - l_off) <= RGCN_ROUTE_RTOL * abs(l_off),
          "rgcn: first loss %g deferred, %g gathered, on the same batch"
          % (l_on, l_off))
    log("rgcn EgoRGCN(%s, num_relations=2, num_bases=1), batch %d, fanout "
        "%s per relation: one step on the kernels against the plain "
        "versions: gathered (%d gather_rows) loss %.6f vs %.6f, deferred (%d "
        "gather_rows + %d segment_spmm) loss %.6f vs %.6f (limit %g "
        "relative); worst logit or gradient error %.3g / %.3g of the "
        "tensor's largest value (limit %g); the two routes' losses on the "
        "same batch %.7f / %.7f (limit %g relative)"
        % (dims, b, list(nbrs), per_step[False]["gather_rows"],
           worst["gathered"][0], worst["gathered"][1],
           per_step[True]["gather_rows"], per_step[True]["segment_spmm"],
           worst["deferred"][0], worst["deferred"][1], STEP_LOSS_RTOL,
           worst["gathered"][2], worst["deferred"][2], STEP_GRAD_TOL,
           l_off, l_on, RGCN_ROUTE_RTOL))

    # 2. the K-step form, eager then captured from the same state, in the
    # order deferred, gathered, gathered, deferred (the host clock drifts)
    K = cfg["scan_steps"]
    runs, work = [], {}
    for defer in (True, False, False, True):
        name = "deferred" if defer else "gathered"
        reset()
        eager = fs.run_rgcn(cfg, device="cuda", capture=False, graph=graph,
                            defer=defer)
        n_steps = (1 + eager["rounds"]) * K
        # the first batch's loss, then every step
        want = {kn: v * (n_steps + 1) for kn, v in per_step[defer].items()}
        check(launches() == want, "rgcn K-step %s eager: launches %s, "
              "expected %s" % (name, launches(), want))
        captured = fs.run_rgcn(cfg, device="cuda", capture=True, graph=graph,
                               defer=defer)
        el, gl_ = np.asarray(eager["losses"]), np.asarray(captured["losses"])
        check(el.shape == gl_.shape == (n_steps,)
              and bool(np.isfinite(gl_).all()), "rgcn K-step %s: %s eager "
              "and %s graph losses, or one not finite"
              % (name, el.shape, gl_.shape))
        check(np.array_equal(el, gl_), "rgcn K-step %s: the graph's losses "
              "differ from the eager ones from the same state: max relative "
              "%g" % (name, np.max(np.abs(el - gl_) / np.abs(el))))
        for pe, pg in zip(eager["model"].parameters(),
                          captured["model"].parameters()):
            check(torch.equal(pe, pg) and bool(torch.isfinite(pg).all()),
                  "rgcn K-step %s: eager and graph parameters differ" % name)
        step = captured["step"]
        if name not in work:
            seeds0 = step.graph_seeds[0].clone()
            step()
            seeds1 = step.graph_seeds[0]
            check(not torch.equal(seeds0, seeds1) and int(seeds1.min()) >= 0
                  and int(seeds1.max()) < n,
                  "rgcn K-step %s: two replays drew the same seeds" % name)
            graph_work, graph_busy, by_name = bench_work(torch, step, K, 2)
            want_work = {kn: float(v) for kn, v in per_step[defer].items()}
            check(graph_work == want_work, "rgcn K-step %s: kernels per "
                  "replayed step %s; want %s" % (name, graph_work, want_work))
            eager_work, eager_busy, _ = bench_work(torch, step.run_eager, K,
                                                   1)
            check(eager_work == graph_work, "rgcn K-step %s: kernels per "
                  "eager step %s, per replayed step %s"
                  % (name, eager_work, graph_work))
            work[name] = (graph_work, graph_busy, eager_busy, by_name)
        graph_work, graph_busy, eager_busy, by_name = work[name]
        runs.append((name, eager["step_ms"], captured["step_ms"]))
        log("rgcn K-step, %s (family_scale run_rgcn, K = %d, %d steps after 1 "
            "warm-up call, %d sampled edges a step): eager %.4f ms per step "
            "(%.4g edges/s, device busy %.4f ms, %.1f%%), CUDA graph %.4f ms "
            "per step (%.4g edges/s, device busy %.4f ms, %.1f%%); capture "
            "%.3f s, graph pool %.1f MB; %d losses bit-equal eager and "
            "captured (%.4f -> %.4f); kernels per replayed step %s; peak "
            "allocated %.3f GB; card: %s"
            % (name, K, captured["rounds"] * K, edges, eager["step_ms"],
               eager["edges_per_s"], eager_busy,
               100.0 * eager_busy / eager["step_ms"], captured["step_ms"],
               captured["edges_per_s"], graph_busy,
               100.0 * graph_busy / captured["step_ms"],
               captured["capture_s"], captured["graph_pool_bytes"] / 1e6,
               n_steps, gl_[0], gl_[-1],
               {k: v for k, v in graph_work.items() if v},
               captured["device_bytes_peak"] / 1e9, card))
        if len(runs) <= 2:
            for kname, ms in sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:10]:
                log("  device %.4f ms per replayed step: %s"
                    % (ms, kname[:90]))
        del eager, captured, step
    log("rgcn K-step, runs in the order %s: CUDA graph %s ms per step, eager "
        "%s ms per step; card: %s"
        % (", ".join(r[0] for r in runs),
           ", ".join("%.4f" % r[2] for r in runs),
           ", ".join("%.4f" % r[1] for r in runs), card))

    # 3. LocalTrainer.train over the ego_rgcn example's query and loss
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    tr = LocalTrainer(seed=0, device="cuda")
    losses, stamps = [], []

    def loss_fn(m, bt, generator, training):
        stamps.append(time.perf_counter())
        loss = er.rgcn_loss(m, bt, aliases, nbrs, training, generator)
        losses.append(loss.detach())
        return loss

    def train(n_steps):
        """(seconds from the call to its first step, ms per step from the
        first step to the last)."""
        del losses[:], stamps[:]
        t0 = time.perf_counter()
        tr.train(q, model, loss_fn, opt, epochs=1, steps_per_epoch=n_steps,
                 verbose=False)
        torch.cuda.synchronize()
        return (stamps[0] - t0,
                (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3)

    before = [p.detach().clone() for p in model.parameters()]
    train(2)  # warm-up
    reset()
    n_tr = RGCN_TRAIN_STEPS
    setup_s, step_ms = train(n_tr)
    tr_launches = {kn: c.count / n_tr for kn, c in counters.items()}
    want = {kn: float(v) for kn, v in per_step[False].items()}
    check(tr_launches == want, "rgcn LocalTrainer: launches per step %s; "
          "want %s" % (tr_launches, want))
    check(len(losses) == n_tr and bool(torch.isfinite(torch.stack(losses))
                                       .all()),
          "rgcn LocalTrainer: %d losses or one not finite" % len(losses))
    check(all(not torch.equal(a, p.detach()) for a, p in
              zip(before, model.parameters())),
          "rgcn LocalTrainer: a parameter did not move")
    first, last = losses[0].item(), losses[-1].item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_step_ms = train(5)
    busy = sum(device_ms_by_kernel(prof).values()) / 5
    log("rgcn LocalTrainer.train (ego_rgcn's query and loss, every hop "
        "gathered): %.3f s from the call to its first step, then %d steps "
        "of batch %d, %.3f ms per step on the host clock (%.3f ms under the "
        "profiler), %.4g edges/s; loss %.4f -> %.4f; launches per step %s; "
        "device busy %.3f ms per step (%.1f%%); card: %s"
        % (setup_s, n_tr, b, step_ms, prof_step_ms, edges / step_ms * 1e3,
           first, last, {k: v for k, v in tr_launches.items() if v}, busy,
           100.0 * busy / step_ms, card))
    del model, opt, tr, losses

    # 4. Kernels 1-2 at this path's shapes, cold, at its table
    gen = torch.Generator(device="cuda").manual_seed(17)
    shapes = gather_shapes(torch, gather, table, gen, "at the rgcn table",
                           rows=RGCN_GATHER_ROWS,
                           yardsticks=RGCN_GATHER_ROWS)
    rows = {"gather_rows": {}, "segment_spmm": {}}
    for m, f in shapes.items():
        rows["gather_rows"].update({
            "cold_ms_62m_%d" % m: f["ms"], "bound_ms_62m_%d" % m:
            f["bound_ms"], "plain_cold_ms_62m_%d" % m: f["plain_ms"],
            "library_cold_ms_62m_%d" % m: f["library_ms"],
            "kernel_route_62m_%d" % m: f["route"]})
    ids = torch.randint(0, n, (b * k1, k2), generator=gen, device="cuda",
                        dtype=torch.int32)
    f = spmm_shape(torch, spmm, table, ids, "mean", "at the rgcn table")
    rows["segment_spmm"].update({
        "cold_ms_rgcn": f["ms"], "bound_ms_rgcn": f["bound_ms"],
        "plain_cold_ms_rgcn": f["plain_ms"],
        "library_cold_ms_rgcn": f["library_ms"]})
    for k in ("gather_rows", "segment_spmm"):
        rows[k].update({
            "rgcn_launches_per_step": work["gathered"][0][k],
            "rgcn_defer_launches_per_step": work["deferred"][0][k],
            "rgcn_trainer_launches_per_step": tr_launches[k]})
    return rows


# ---------------------------------------------------------------------------
# Phase 14: the temporal family at the timestamped store
# ---------------------------------------------------------------------------

TEMPORAL_PER_STEP = {"gather_rows": 2.0, "segment_spmm": 1.0,
                     "sweep_aggregate": 0.0}


def temporal_edge_query(g, b, nbrs):
    """The family's query with each hop as an edge hop and its endpoint:
    the same draws in the same order, so on the same generator state its
    ``h1`` / ``h2`` ids are the family query's, and its ``e1`` / ``e2``
    Edges carry the sampled edges' ids and timestamps."""
    seed = g.E("rel").batch(b).alias("ev")
    src = seed.outV().alias("src")
    e1 = src.outE("rel").sample(nbrs[0]).by("edge_weight").alias("e1")
    e2 = (e1.inV().alias("h1").outE("rel").sample(nbrs[1])
          .by("edge_weight").alias("e2"))
    e2.inV().alias("h2")
    return seed.values()


def before_t_check(torch, gl, q, eq, tables, n_edges, csr):
    """One batch of the family query, and the same draws through
    :func:`temporal_edge_query`, checked on the card: the same ids; every
    sampled edge strictly earlier than its bound (hop 1: the event, hop 2:
    the hop-1 edge); where a seed has no admissible edge, the default id
    and edge id -1, and elsewhere no -1.  Returns the zero-admissible seed
    counts of the two hops."""
    from graph_learn_tpu_torch.gsl.compile import _execute
    from graph_learn_tpu_torch.ops import temporal

    gen = torch.Generator(device="cuda").manual_seed(14)
    seeds = torch.randint(0, n_edges, (q.dag.batch_size,), generator=gen,
                          device="cuda", dtype=torch.int32)
    with torch.no_grad():
        out = _execute(q, tables, seeds,
                       torch.Generator(device="cuda").manual_seed(41))
        eout = _execute(eq, tables, seeds,
                        torch.Generator(device="cuda").manual_seed(41))
    ev_ts = eout["ev"].timestamps
    e1, e2 = eout["e1"], eout["e2"]
    oks, zero = [], []
    for parent_ids, bound, hop, ids in (
            (eout["src"].ids, ev_ts, e1, out["h1"].ids),
            (eout["h1"].ids.reshape(-1), e1.timestamps.reshape(-1), e2,
             out["h2"].ids)):
        eids = hop.edge_ids.reshape(bound.shape[0], -1)
        ts = hop.timestamps.reshape(eids.shape)
        _, _, deg = temporal.cutoffs(csr, parent_ids, bound)
        none = (deg == 0)[:, None]
        oks += [torch.equal(hop.dst_ids.reshape(-1), ids.reshape(-1)),
                ((eids < 0) | (ts < bound[:, None])).all(),
                (~none | ((eids == -1) & (hop.dst_ids.reshape(eids.shape)
                                          == gl.conf.default_neighbor_id)))
                .all(),
                (none | (eids >= 0)).all()]
        zero.append((deg == 0).sum())
    oks = torch.stack([torch.as_tensor(o, device="cuda") for o in oks])
    result = oks.cpu().tolist()
    names = ("the edge query's ids equal the family query's",
             "every edge earlier than its bound",
             "zero-admissible seeds filled with the default id and -1",
             "admissible seeds without a -1")
    for hop in range(2):
        for i, name in enumerate(names):
            check(result[4 * hop + i], "temporal hop %d: not %s"
                  % (hop + 1, name))
    return [int(z) for z in torch.stack(zero).cpu()]


def temporal_path(torch, card, gather, spmm, sweep):
    """``examples/family_scale.py``'s temporal family at its store's node
    count and widths (2.45M items, ``FAMILY_DEGREE`` weighted, timestamped
    edges a node, the "full" profile): the store build timed; the
    before-t bound of one batch
    checked on the card; one step on the kernels against the plain
    versions; the K-step form eager and captured.  Returns the kernels
    line's fields."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import family_scale as fs
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.gsl.dataset import Dataset
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    cfg = dict(bench.CFG_SCALE, avg_degree=FAMILY_DEGREE)
    nbrs = fs.temporal_fanout(False)
    k1, k2 = nbrs
    n, b, d = cfg["n_nodes"], cfg["batch"], cfg["feat_dim"]
    dims = [d, cfg["hidden"], cfg["classes"]]
    edges = b * (k1 + k1 * k2)
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "sweep_aggregate": sweep.LAUNCHES_SWEEP}

    def launches():
        return {kn: c.count for kn, c in counters.items()}

    def reset():
        for c in counters.values():
            c.reset()

    t0 = time.perf_counter()
    graph = fs.build_temporal_graph(cfg, "cuda")
    draw_s = time.perf_counter() - t0
    g, dec = graph
    q = fs.temporal_query(g, b, nbrs)
    eq = temporal_edge_query(g, b, nbrs)
    t0 = time.perf_counter()
    tables = q.device_tables()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    host = g.store.edge_table("rel")
    csr_s = host.host_build_s
    et = tables["edges"]["rel"]
    table = tables["nodes"]["item"].float_attrs
    n_e = host.num_edges
    check(n_e == n * FAMILY_DEGREE and host.weights is not None
          and host.timestamps is not None and et.inc is not None
          and et.out.nbr_ts is not None and et.out.nbr_ts.dtype == torch.int32
          and et.out.cum_weights is not None and et.timestamps is not None
          and table.shape == (n, d) and table.dtype == torch.bfloat16,
          "temporal store: not the weighted, timestamped full-profile "
          "%d-edge store over a [%d, %d] bf16 table" % (n * FAMILY_DEGREE,
                                                        n, d))
    log("temporal store (%d items, %d bf16 features, %d classes; rel: %d "
        "weighted edges, timestamps in [0, %d), full profile): host draw "
        "%.1f s, CSR build %.1f s (both directions: ts-ascending rows, "
        "nbr_ts, id-sorted copies, weight and in-degree CDFs, pools), "
        "upload %.1f s, tables %.3f GB on the card; largest row %d; card: %s"
        % (n, d, cfg["classes"], n_e, fs.TS_RANGE, draw_s, csr_s,
           tables_s - csr_s, nbytes(tables) / 1e9, et.out.max_degree, card))

    # 1. the before-t bound of one batch, on the card
    zero = before_t_check(torch, gl, q, eq, tables, n_e, et.out)
    check(zero[0] > 0 and zero[1] > 0, "temporal: no zero-admissible seed "
          "at a hop (%s): the fill check saw nothing" % zero)
    log("temporal before-t bound, one batch of %d events checked on the "
        "card: every sampled edge of hops 1 and 2 strictly earlier than its "
        "bound (the event's time, then the hop-1 edge's); %d of %d hop-1 and "
        "%d of %d hop-2 seeds with no admissible edge, each slot the default "
        "id and edge id -1; the outE / inV form of the query drew the same "
        "ids" % (b, zero[0], b, zero[1], b * k1))

    # 2. one step on the kernels against the plain versions
    model = EgoGraphSAGE(dims, dec, agg_type="gcn", device="cuda")
    params = list(model.parameters())
    batch = Dataset(q, window=1, device="cuda").next()
    plain = {a: batch[a].replace(float_attrs=table[batch[a].ids.long()])
             for a in ("src",) + fs.TEMPORAL_HOPS}

    def loss_and_grads(loss):
        return loss, torch.autograd.grad(loss, params)

    reset()
    loss, grads = loss_and_grads(fs.temporal_loss(model, batch, table))
    step_launches = launches()
    check(step_launches == {k: int(v) for k, v in TEMPORAL_PER_STEP.items()},
          "temporal step: launches %s, expected %s" % (step_launches,
                                                       TEMPORAL_PER_STEP))
    ref_loss, ref_grads = loss_and_grads(supervised_softmax_loss(
        model(EgoGraph.from_query_result(plain, "src", fs.TEMPORAL_HOPS)),
        plain["src"].labels))
    lk, lp = loss.item(), ref_loss.item()
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), "temporal step: loss %g "
          "on the kernels, %g on the plain versions" % (lk, lp))
    worst = 0.0
    for x, y in zip(grads, ref_grads):
        worst = max(worst, (x - y).abs().max().item()
                    / max(y.abs().max().item(), 1e-12))
    check(worst <= STEP_GRAD_TOL, "temporal step: a gradient off by %g of "
          "its largest value" % worst)
    log("temporal EgoGraphSAGE(%s, gcn), batch %d, fanout %s: one step on "
        "the kernels (%s) against the plain versions (plain indexing, the "
        "conv's own mean): loss %.6f vs %.6f (limit %g relative), worst "
        "gradient error %.3g of the tensor's largest value (limit %g)"
        % (dims, b, list(nbrs), step_launches, lk, lp, STEP_LOSS_RTOL, worst,
           STEP_GRAD_TOL))
    del model, params, grads, ref_grads

    # 3. the K-step form, eager then captured, from the same state
    K = cfg["scan_steps"]
    reset()
    eager = fs.run_temporal(cfg, device="cuda", capture=False, graph=graph)
    n_steps = (1 + eager["rounds"]) * K
    # the first batch's loss, then every step
    want = {kn: int(v) * (n_steps + 1) for kn, v in TEMPORAL_PER_STEP.items()}
    check(launches() == want, "temporal K-step eager: launches %s, expected "
          "%s" % (launches(), want))
    captured = fs.run_temporal(cfg, device="cuda", capture=True, graph=graph)
    el, gl_ = np.asarray(eager["losses"]), np.asarray(captured["losses"])
    check(el.shape == gl_.shape == (n_steps,)
          and bool(np.isfinite(gl_).all()), "temporal K-step: %s eager and "
          "%s graph losses, or one not finite" % (el.shape, gl_.shape))
    check(np.array_equal(el, gl_), "temporal K-step: the graph's losses "
          "differ from the eager ones from the same state: max relative %g"
          % np.max(np.abs(el - gl_) / np.abs(el)))
    for pe, pg in zip(eager["model"].parameters(),
                      captured["model"].parameters()):
        check(torch.equal(pe, pg) and bool(torch.isfinite(pg).all()),
              "temporal K-step: eager and graph parameters differ")
    step = captured["step"]
    seeds0 = step.graph_seeds[0].clone()
    step()
    seeds1 = step.graph_seeds[0]
    check(not torch.equal(seeds0, seeds1) and int(seeds1.min()) >= 0
          and int(seeds1.max()) < n_e,
          "temporal K-step: two replays drew the same seed edges")
    graph_work, graph_busy, by_name = bench_work(torch, step, K, 2)
    check(graph_work == TEMPORAL_PER_STEP, "temporal K-step: kernels per "
          "replayed step %s; want %s" % (graph_work, TEMPORAL_PER_STEP))
    eager_work, eager_busy, _ = bench_work(torch, step.run_eager, K, 1)
    check(eager_work == graph_work, "temporal K-step: kernels per eager step "
          "%s, per replayed step %s" % (eager_work, graph_work))
    log("temporal K-step (family_scale run_temporal, K = %d, %d steps after "
        "1 warm-up call, %d sampled edges a step): eager %.4f ms per step "
        "(%.4g edges/s, device busy %.4f ms, %.1f%%), CUDA graph %.4f ms per "
        "step (%.4g edges/s, device busy %.4f ms, %.1f%%); capture %.3f s, "
        "graph pool %.1f MB; %d losses bit-equal eager and captured (%.4f -> "
        "%.4f); kernels per replayed step %s; peak allocated %.3f GB; card: "
        "%s"
        % (K, captured["rounds"] * K, edges, eager["step_ms"],
           eager["edges_per_s"], eager_busy,
           100.0 * eager_busy / eager["step_ms"], captured["step_ms"],
           captured["edges_per_s"], graph_busy,
           100.0 * graph_busy / captured["step_ms"], captured["capture_s"],
           captured["graph_pool_bytes"] / 1e6, n_steps, gl_[0], gl_[-1],
           {k: v for k, v in graph_work.items() if v},
           captured["device_bytes_peak"] / 1e9, card))
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log("  device %.4f ms per replayed step: %s" % (ms, kname[:90]))
    return {k: {"temporal_launches_per_step": graph_work[k]}
            for k in ("gather_rows", "segment_spmm")}


# ---------------------------------------------------------------------------
# Phase 15: the EgoTGAT link-prediction path (examples/ego_tgat.py)
# ---------------------------------------------------------------------------

# per step: three towers, each gathering its src, two node hops and two
# edge hops (Kernel 1), and running three convs (Kernel 3), each
# differentiated
TGAT_PER_STEP = {"gather_rows": 15, "gat_block": 9, "gat_block_bwd": 9}
# the example's tower width at level 0 (feat 8 + time 8 queries against
# feat 8 + edge 4 + time 8 keys) and level 1 (hidden 32 + time 8)
TGAT_NBRS, TGAT_BATCH = (8, 4), 128
# gradients under this share of the step's largest one are held to it
TGAT_GRAD_FLOOR = 1e-6


def tgat_path(torch, card, gather, gat):
    """``examples/ego_tgat.py`` at its defaults (6 000 events, f32): one
    step on the kernels against the plain versions, LocalTrainer.train for
    its 3 epochs with the launches per step held to the design, the test
    accuracy.  Returns the kernels line's fields."""
    from graph_learn_tpu_torch.core.values import DeferredRows
    from graph_learn_tpu_torch.examples import ego_tgat as et
    from graph_learn_tpu_torch.gsl.compile import _execute
    from graph_learn_tpu_torch.nn.layers import ego as ego_layers
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from torch.profiler import ProfilerActivity, profile

    nhops = len(TGAT_NBRS)
    counters = {"gather_rows": gather.LAUNCHES,
                "gat_block": gat.LAUNCHES_FWD,
                "gat_block_bwd": gat.LAUNCHES_BWD}
    routes = list(gat.ROUTE_LAUNCHES.values()) + [gat.WGMMA_LAUNCHES]

    def reset():
        for c in list(counters.values()) + routes:
            c.reset()

    t0 = time.perf_counter()
    g, udec, idec, edec = et.build_graph(et.temporal_u2i(), "cuda")
    q = et.build_query(g, TGAT_BATCH, TGAT_NBRS, "train")
    q_test = et.build_query(g, TGAT_BATCH, TGAT_NBRS, "test")
    q.device_tables()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_train = g.store.edge_table("train").num_edges
    model = et.TGATLink(udec, idec, 32, 16, 8, nhops,
                        edec.float_attr_num, device="cuda")
    params = list(model.parameters())

    # 1. one step on the kernels against the plain versions, on events
    # from the middle of the train span: the first batch's users and items
    # have almost no earlier interactions, so their neighbours are the same
    # fill (or a few repeated edges), the attention is uniform and level
    # 0's query and attention weights get gradients that are zero in exact
    # arithmetic (1e-20 to 1e-12, rounding noise)
    mid = n_train // 2
    with torch.no_grad():
        batch = _execute(q, q.device_tables(),
                         torch.arange(mid, mid + TGAT_BATCH, device="cuda",
                                      dtype=torch.int32),
                         torch.Generator(device="cuda").manual_seed(15))

    def plain_rows(v):
        fa = v.float_attrs
        if isinstance(fa, DeferredRows):
            return v.replace(float_attrs=fa.table[fa.idx.long()])
        return v

    plain = {a: plain_rows(v) for a, v in batch.items()}
    reset()
    loss = et.tgat_loss(model, batch, nhops)
    grads = torch.autograd.grad(loss, params)
    step_launches = {k: c.count for k, c in counters.items()}
    check(step_launches == TGAT_PER_STEP, "tgat step: launches %s, "
          "expected %s" % (step_launches, TGAT_PER_STEP))
    check(gat.ROUTE_LAUNCHES["tensor"].count == 18
          and gat.ROUTE_LAUNCHES["fma"].count == 0
          and gat.WGMMA_LAUNCHES.count == 9,
          "tgat step: gat_block product routes %s, %d forwards on wgmma; "
          "want every product on the tensor cores and 9 forwards on wgmma"
          % ({r: c.count for r, c in gat.ROUTE_LAUNCHES.items()},
             gat.WGMMA_LAUNCHES.count))
    kernel_block = ego_layers.gat_block
    ego_layers.gat_block = gat.gat_block_plain
    try:
        ref_loss = et.tgat_loss(model, plain, nhops)
        ref_grads = torch.autograd.grad(ref_loss, params)
    finally:
        ego_layers.gat_block = kernel_block
    lk, lp = loss.item(), ref_loss.item()
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), "tgat step: loss %g on "
          "the kernels, %g on the plain versions" % (lk, lp))
    # each gradient held to its own largest value, or to TGAT_GRAD_FLOOR of
    # the step's largest gradient where its own is smaller (a gradient that
    # is zero in exact arithmetic); the tensors under the floor are counted
    top = max(y.abs().max().item() for y in ref_grads)
    worst, floored = 0.0, 0
    for (pname, _), x, y in zip(model.named_parameters(), grads, ref_grads):
        own = y.abs().max().item()
        floored += own < TGAT_GRAD_FLOOR * top
        rel = ((x - y).abs().max().item()
               / max(own, TGAT_GRAD_FLOOR * top))
        check(rel <= STEP_GRAD_TOL, "tgat step: the gradient of %s off by "
              "%g of its largest value %g" % (pname, rel, own))
        worst = max(worst, rel)
    log("tgat TGATLink (feat 8, edge feat 4, hidden 32, out 16, time 8, "
        "heads 2, nbrs %s, batch %d; store and plan tables %.2f s): one step "
        "on the kernels (%s, every product on the tensor cores, 9 forwards "
        "on wgmma) against the plain versions (plain indexing, "
        "gat_block_plain), events %d-%d: loss %.6f vs %.6f (limit %g "
        "relative), worst gradient error %.3g of the tensor's largest value "
        "(limit %g; %d of %d tensors under %g of the step's largest "
        "gradient, held to that)"
        % (list(TGAT_NBRS), TGAT_BATCH, build_s, step_launches, mid,
           mid + TGAT_BATCH - 1, lk, lp, STEP_LOSS_RTOL, worst,
           STEP_GRAD_TOL, floored, len(params), TGAT_GRAD_FLOOR))
    del grads, ref_grads

    # 2. LocalTrainer.train for the example's 3 epochs, then the accuracy
    opt = torch.optim.Adam(params, lr=1e-3)
    tr = LocalTrainer(seed=0, device="cuda")
    losses, stamps = [], []

    def loss_fn(m, bt, generator, training):
        stamps.append(time.perf_counter())
        loss_ = et.tgat_loss(m, bt, nhops, training, generator)
        losses.append(loss_.detach())
        return loss_

    def train(epochs, steps=None):
        del losses[:], stamps[:]
        t0 = time.perf_counter()
        _, hist = tr.train(q, model, loss_fn, opt, epochs=epochs,
                           steps_per_epoch=steps, verbose=False)
        torch.cuda.synchronize()
        return hist, time.perf_counter() - t0

    before = [p.detach().clone() for p in params]
    reset()
    hist, wall = train(3)
    n = len(losses)
    per_step = {k: c.count / n for k, c in counters.items()}
    check(n == 3 * -(-n_train // TGAT_BATCH) and len(hist) == 3,
          "tgat LocalTrainer: %d steps in %d epochs" % (n, len(hist)))
    check(per_step == {k: float(v) for k, v in TGAT_PER_STEP.items()},
          "tgat LocalTrainer: launches per step %s, expected %s"
          % (per_step, TGAT_PER_STEP))
    check(bool(torch.isfinite(torch.stack(losses)).all())
          and all(np.isfinite(hist)), "tgat LocalTrainer: a loss is not "
          "finite")
    check(all(not torch.equal(a, p.detach()) for a, p in zip(before, params)),
          "tgat LocalTrainer: a parameter did not move")
    step_ms = (stamps[-1] - stamps[0]) / (n - 1) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_wall = train(1, 5)
    by_kernel = device_ms_by_kernel(prof)
    busy = sum(by_kernel.values()) / 5
    t0 = time.perf_counter()
    acc = tr.evaluate(q_test, model,
                      lambda m, bt: et.link_accuracy(m, bt, nhops))
    eval_s = time.perf_counter() - t0
    check(0.0 <= acc <= 1.0, "tgat: test accuracy %g" % acc)
    log("tgat LocalTrainer.train (ego_tgat, %d train events, batch %d, Adam "
        "1e-3): 3 epochs, %d steps in %.3f s, %.3f ms per step on the host "
        "clock (%.3f ms under the profiler); per-epoch mean loss %s; "
        "launches per step %s; device busy %.3f ms per step (%.1f%%); test "
        "link-pred acc: %.4f (%d test events, %.2f s); card: %s"
        % (n_train, TGAT_BATCH, n, wall, step_ms, prof_wall / 5 * 1e3,
           ["%.4f" % x for x in hist], per_step, busy, 100.0 * busy / step_ms,
           acc, g.store.edge_table("test").num_edges, eval_s, card))
    for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log("  device %.4f ms per step: %s" % (ms / 5, kname[:90]))
    return {"gather_rows": {"tgat_trainer_launches_per_step":
                            per_step["gather_rows"]},
            "gat_block": {"tgat_launches_per_step": per_step["gat_block"],
                          "tgat_bwd_launches_per_step":
                          per_step["gat_block_bwd"],
                          "tgat_test_accuracy": acc}}


# ---------------------------------------------------------------------------
# Phase 16: the walks family at the weighted 61.25M-edge store
# ---------------------------------------------------------------------------

# Kernel 1's row count on the walk path: a batch of 1 024 walks of 20
WALK_GATHER_ROWS = (20_480,)
# a share check fails below this chi-square p-value
WALK_SHARE_P = 1e-4


def edge_keys(src, dst, n):
    """The edges of the host arrays ``src`` / ``dst`` as sorted int64 keys
    ``src * n + dst`` (repeated edges repeated): the reference the walk
    checks hold a walk to, apart from the port's CSR and membership code."""
    return np.sort(np.asarray(src, np.int64) * n + np.asarray(dst, np.int64))


def key_row(keys, n, v):
    """The out-neighbours of ``v`` (with repeats, ascending) in ``keys``."""
    v = int(v)  # an int32 id times n overflows int32
    lo, hi = np.searchsorted(keys, [v * n, (v + 1) * n])
    return keys[lo:hi] - v * n


def walk_invariants(walks, seeds, keys, n):
    """Hold a batch of walks [b, L] (numpy) to the edges ``keys``: column 0
    is ``seeds``; every step (w[:, t], w[:, t + 1]) between two ids is an
    edge; a walker emits -1 only at a node with no out-edge, and only -1
    after that.  Returns (transitions checked, walkers that got stuck)."""
    check(np.array_equal(walks[:, 0], seeds), "walks: column 0 is not the "
          "seeds")
    a, b = walks[:, :-1], walks[:, 1:]
    live = (a >= 0) & (b >= 0)
    k = a[live].astype(np.int64) * n + b[live]
    pos = np.minimum(np.searchsorted(keys, k), keys.size - 1)
    check(bool((keys[pos] == k).all()), "walks: %d of %d steps are not "
          "edges" % (int((keys[pos] != k).sum()), k.size))
    check(not bool(((a < 0) & (b >= 0)).any()), "walks: a walker moved "
          "again after a -1")
    stops = a[(a >= 0) & (b < 0)]
    degs = np.searchsorted(keys, (stops.astype(np.int64) + 1) * n) \
        - np.searchsorted(keys, stops.astype(np.int64) * n)
    check(not bool(degs.any()), "walks: a walker stopped at a node with "
          "out-edges")
    return int(live.sum()), int(stops.size)


def node2vec_shares(walks, keys, n, p, q, tries):
    """(observed, expected) counts of node2vec steps that return to the
    previous node, go to a neighbour of it, or elsewhere, over every step
    of ``walks`` [b, L] after the first (numpy, the edges ``keys``).  A
    proposal y of the current node's d out-edges, of weight w(y) / max_w =
    r, is taken with probability r/d (1 - (1 - a)^tries) / a + (1 - a)^(tries
    - 1) (1 - r)/d, with ``a`` the row's mean r: accepted at some try, or
    the last proposal after every try was rejected."""
    inv = np.array([1.0 / p, 1.0, 1.0 / q])
    r_of = inv / inv.max()
    obs, exp = np.zeros(3), np.zeros(3)
    for t in range(1, walks.shape[1] - 1):
        for prev, cur, nxt in walks[:, t - 1:t + 2]:
            if cur < 0:
                continue
            row = key_row(keys, n, cur)
            if row.size == 0:
                continue
            prow = key_row(keys, n, prev)
            cls = np.where(row == prev, 0, np.where(np.isin(row, prow), 1, 2))
            r, d = r_of[cls], row.size
            a = r.mean()
            pr = (r / d * (1 - (1 - a) ** tries) / a
                  + (1 - a) ** (tries - 1) * (1 - r) / d)
            exp += np.bincount(cls, weights=pr, minlength=3)
            obs[0 if nxt == prev else 1 if np.isin(nxt, prow) else 2] += 1
    return obs, exp


def share_p_value(obs, exp):
    """The chi-square p-value of ``obs`` against ``exp`` over the classes
    that can occur (1 or 2 degrees of freedom: erfc and exp are the chi-
    square tails); 0 where a class that cannot occur did."""
    if bool((obs[exp == 0] > 0).any()):
        return 0.0
    m = exp > 0
    stat = float(((obs[m] - exp[m]) ** 2 / exp[m]).sum())
    dof = int(m.sum()) - 1
    if dof <= 0:
        return 1.0
    return (math.erfc(math.sqrt(stat / 2)) if dof == 1
            else math.exp(-stat / 2))


def walks_path(torch, card, gather, graph):
    """``examples/family_scale.py``'s walks family on the weighted 61.25M-
    edge store that the bench phase built under the "minimal" profile: for
    deepwalk and node2vec (p 0.5, q 2) the K-batch form eager and captured
    from the same generator seed, the walks bit for bit the same, rates,
    device busy and kernels per replayed batch; one batch held to the host
    edge arrays (``walk_invariants``) and node2vec's step shares to their
    expectation; then a ``random_walk`` query's feature rows materialised
    once through its ``DeferredRows`` (one gather_rows launch, bit for bit
    against the plain version, timed cold).  Returns the kernels line's
    fields."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import family_scale as fs
    from graph_learn_tpu_torch.gsl.compile import _execute
    from graph_learn_tpu_torch.ops.walk import NUM_TRIES

    cfg = bench.CFG_SCALE
    n, b, K = cfg["n_nodes"], cfg["batch"], cfg["scan_steps"]
    length = fs.walk_len(False)
    g, _ = graph
    host = g.store.edge_table("rel")
    csr = host.device("cuda").out
    check(csr.nbr_ids_sorted is None and host.num_edges == 61_250_000,
          "walks: not the minimal-profile 61.25M-edge store")
    eager = fs.run_walks(cfg, device="cuda", capture=False, graph=graph)
    captured = fs.run_walks(cfg, device="cuda", capture=True, graph=graph)
    t0 = time.perf_counter()
    keys = edge_keys(host.src, host.dst, n)
    keys_s = time.perf_counter() - t0
    for label, p, q in fs.WALKS:
        e, c = eager[label], captured[label]
        se, sc = e["step"], c["step"]
        check(torch.equal(se.walks, sc.walks) and int(se.acc) == int(sc.acc)
              and torch.equal(se.seeds[0], sc.graph_seeds[0]),
              "walks %s: the captured batches differ from the eager ones "
              "from the same generator seed" % label)
        walks0 = sc.walks[0].cpu().numpy()
        seeds0 = sc.graph_seeds[0].cpu().numpy()
        steps, stuck = walk_invariants(walks0, seeds0, keys, n)
        work, ms = device_work_per_call(torch, sc, calls=2)
        per_batch = sum(c_ for name, c_ in work.items()
                        if not name.startswith("Memset")) / K
        busy = sum(c_ * ms[k] for k, c_ in work.items()) / K
        check(not any(k_ in name for name in work for k_ in BENCH_KERNELS),
              "walks %s: a kernel of the port ran: %s" % (label, work))
        extra = ""
        if p != 1.0 or q != 1.0:
            obs, exp = node2vec_shares(walks0, keys, n, p, q, NUM_TRIES)
            pv = share_p_value(obs, exp)
            check(pv > WALK_SHARE_P, "walks %s: return / neighbour / other "
                  "steps %s, expected %s (p = %g)" % (label, obs, exp, pv))
            extra = ("; steps returning / to a neighbour of the previous "
                     "node / elsewhere %s, expected %s (chi-square p %.3g)"
                     % (obs.astype(int).tolist(),
                        [round(float(x), 2) for x in exp], pv))
        log("walks %s (p %g, q %g; length %d, b %d, K = %d, %d batches after "
            "1 warm-up call; minimal profile, membership by scan): eager "
            "%.4f ms a batch (%.4g transitions/s), CUDA graph %.4f ms a "
            "batch (%.4g transitions/s, device busy %.4f ms, %.1f%%, %.1f "
            "kernels a replayed batch); capture %.3f s, graph pool %.1f MB; "
            "%d walks bit-equal eager and captured; one batch on the host "
            "edge arrays: %d steps are edges, column 0 the seeds, %d walkers "
            "stuck at dead ends and -1 after%s; card: %s"
            % (label, p, q, length, b, K, c["rounds"] * K, e["batch_ms"],
               e["transitions_per_s"], c["batch_ms"],
               c["transitions_per_s"], busy, 100.0 * busy / c["batch_ms"],
               per_batch, c["capture_s"], c["graph_pool_bytes"] / 1e6,
               K * b, steps, stuck, extra, card))
        for kname, kms in sorted(ms.items(), key=lambda kv: -kv[1]
                                 * work[kv[0]])[:5]:
            log("  device %.4f ms per replayed batch: %s"
                % (work[kname] * kms / K, kname[:90]))
    log("walks: host edge keys sorted in %.1f s" % keys_s)
    del eager, captured

    # the walk query's feature rows: Kernel 1 at b * length rows
    q = (g.V("item").batch(b).alias("src")
         .random_walk(length, p=0.5, q=2.0, edge_type="rel").alias("walks")
         .values())
    tables = q.device_tables()
    table = tables["nodes"]["item"].float_attrs
    gen = torch.Generator(device="cuda").manual_seed(23)
    seeds = torch.randint(0, n, (b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    out = _execute(q, tables, seeds, gen)["walks"]
    rows = out.float_attrs
    check(tuple(out.ids.shape) == (b, length) and torch.equal(
        rows.idx, torch.clamp(out.ids, min=0)), "walk query: ids %s, rows "
        "not at max(ids, 0)" % (tuple(out.ids.shape),))
    gather.LAUNCHES.reset()
    feats = rows.materialize()
    torch.cuda.synchronize()
    launches = gather.LAUNCHES.count
    flat = rows.idx.reshape(-1)
    check(launches == 1 and torch.equal(
        feats.reshape(-1, table.shape[1]),
        gather.gather_rows_plain(table, flat)),
          "walk query: %d gather_rows launches materialising the rows, or "
          "rows not bit-equal to gather_rows_plain" % launches)
    log("walk query (random_walk(%d, p 0.5, q 2) of %d seeds): %d ids, %d "
        "of them -1, rows [%d, %d] %s materialised by 1 gather_rows launch, "
        "bit-equal to gather_rows_plain"
        % (length, b, out.ids.numel(), int((out.ids < 0).sum()),
           flat.numel(), table.shape[1], table.dtype))
    shapes = gather_shapes(torch, gather, table, gen, "on the walk path",
                           rows=WALK_GATHER_ROWS,
                           given={flat.numel(): flat.to(torch.int32)},
                           yardsticks=WALK_GATHER_ROWS)
    fields = {"walks_launches": launches}
    for m, f in shapes.items():
        fields.update({
            "cold_ms_62m_%d" % m: f["ms"], "bound_ms_62m_%d" % m:
            f["bound_ms"], "plain_cold_ms_62m_%d" % m: f["plain_ms"],
            "library_cold_ms_62m_%d" % m: f["library_ms"],
            "kernel_route_62m_%d" % m: f["route"]})
    return {"gather_rows": fields}


# ---------------------------------------------------------------------------
# Phase 17: the node2vec, UltraGCN and TGN examples
# ---------------------------------------------------------------------------

# node2vec walks held to their step shares on the example's store
N2V_SHARE_WALKS = 512


def examples_path(torch, card, gather):
    """``examples/node2vec.py``, ``ultra_gcn.py`` and ``tgn.py`` at their
    defaults on the card, each from the TSV files it writes into a
    temporary ``--data_dir`` (its store from them bit-equal to its
    in-memory twin of the same draws read back from their text), each
    quality number above chance: the label coherence above 1/7, Recall@20
    above that of random scores, the pairwise AUC above 0.5; TGN's item
    features on Kernel 1, two launches a step.  Before them, node2vec
    walks (the example's p = q = 0.25) on the example's undirected store,
    held to its edges and to their step shares.  Returns the kernels
    line's fields."""
    import tempfile

    from graph_learn_tpu_torch.examples import bipartite_sage
    from graph_learn_tpu_torch.examples import node2vec as n2v
    from graph_learn_tpu_torch.examples import tgn, ultra_gcn
    from graph_learn_tpu_torch.examples.bipartite_sage import u2i_arrays
    from graph_learn_tpu_torch.ops import walk as walk_ops

    where = tempfile.mkdtemp(prefix="glt_examples_")
    try:
        dirs = {k: os.path.join(where, k) for k in ("cora_like", "u2i", "tgn")}
        g, _ = n2v.load(dirs["cora_like"], device="cuda")
        same_store(torch, g, n2v.build_graph(n2v.cora_like(text=True),
                                             "cuda")[0], "node2vec files")
        et = g.store.edge_table("relation")
        n = g.store.node_table("item").num_nodes
        keys = edge_keys(et.src, et.dst, n)
        gen = torch.Generator(device="cuda").manual_seed(29)
        seeds = torch.randint(0, n, (N2V_SHARE_WALKS,), generator=gen,
                              device="cuda", dtype=torch.int32)
        walks = walk_ops.node2vec_walk(et.device("cuda").out, seeds, 10, gen,
                                       p=0.25, q=0.25).cpu().numpy()
        steps, stuck = walk_invariants(walks, seeds.cpu().numpy(), keys, n)
        obs, exp = node2vec_shares(walks, keys, n, 0.25, 0.25,
                                   walk_ops.NUM_TRIES)
        pv = share_p_value(obs, exp)
        check(pv > WALK_SHARE_P and obs[0] > 0 and obs[1] > 0,
              "node2vec shares on the example store: %s, expected %s (p = %g)"
              % (obs, exp, pv))
        log("node2vec walks on the example's undirected store from its TSV "
            "files (bit-equal to its in-memory twin; %d nodes, %d edges both "
            "ways; %d walks of 10, p = q = 0.25): %d steps are "
            "edges, %d walkers stuck; steps returning / to a neighbour of the "
            "previous node / elsewhere %s, expected %s (chi-square p %.3g)"
            % (n, et.num_edges, N2V_SHARE_WALKS, steps, stuck,
               obs.astype(int).tolist(), [round(float(x), 1) for x in exp],
               pv))

        t0 = time.perf_counter()
        coherence = n2v.main(["--data_dir", dirs["cora_like"]])
        log("node2vec example (5 epochs, batch 128, walks of 10, window 5, 5 "
            "negatives; nothing cut): label coherence %.3f (chance %.3f) in "
            "%.1f s; card: %s" % (coherence, 1.0 / n2v.CLASSES,
                                  time.perf_counter() - t0, card))
        check(coherence > 1.0 / n2v.CLASSES, "node2vec: label coherence %.3f "
              "not above chance" % coherence)

        t0 = time.perf_counter()
        recall = ultra_gcn.main(["--data_dir", dirs["u2i"]])
        twin = bipartite_sage.build_graph(u2i_arrays(feat_dim=16, text=True),
                                          "cuda")[0]
        same_store(torch, bipartite_sage.load(dirs["u2i"], 16, "cuda")[0],
                   twin, "ultra_gcn files")
        u2i = u2i_arrays(feat_dim=16)
        rng = np.random.default_rng(0)
        chance = ultra_gcn.recall_at(
            rng.standard_normal((u2i["u_feat"].shape[0], 64)),
            rng.standard_normal((u2i["i_feat"].shape[0], 64)),
            u2i["ui_src"], u2i["ui_dst"])
        log("ultra_gcn example (its u2i TSV files, the store bit-equal to its "
            "in-memory twin; 400 steps of batch 512, 20 negatives; nothing "
            "cut): Recall@20 %.4f, random scores %.4f, in %.1f s; card: %s"
            % (recall, chance, time.perf_counter() - t0, card))
        check(recall > chance, "ultra_gcn: Recall@20 %.4f not above random "
              "scores' %.4f" % (recall, chance))

        gather.LAUNCHES.reset()
        t0 = time.perf_counter()
        auc = tgn.main(["--data_dir", dirs["tgn"]])
        launches = gather.LAUNCHES.count
        same_store(torch, tgn.load(dirs["tgn"]),
                   tgn.build_graph(tgn.gen_temporal_u2i(), "cuda"),
                   "tgn files")
        # 3 epochs of 31 batches of 128 of the 4 000 events, 2 gathers a step
        tgn_steps = 3 * len(range(0, 4000 - 128, 128))
        log("tgn example (its TSV files, the store bit-equal to its in-memory "
            "twin; 3 epochs, batch 128, 5 recency neighbours; nothing "
            "cut): pairwise AUC of the last quarter %.3f in %.1f s; %d "
            "gather_rows launches over %d steps; card: %s"
            % (auc, time.perf_counter() - t0, launches, tgn_steps, card))
        check(auc > 0.5, "tgn: pairwise AUC %.3f not above 0.5" % auc)
        check(launches == 2 * tgn_steps, "tgn: %d gather_rows launches, want "
              "2 a step over %d steps" % (launches, tgn_steps))
        return {"gather_rows": {"tgn_launches_per_step": launches / tgn_steps,
                                "node2vec_coherence": coherence,
                                "ultra_gcn_recall_at_20": recall,
                                "tgn_pairwise_auc": auc}}
    finally:
        shutil.rmtree(where, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 19: SubGraph induction, SEAL at ogbl-collab's size, the GSL
# SubGraph query at the 61.25M-edge store, the edge-star GraphSAGE
# ---------------------------------------------------------------------------

# SEAL (examples/seal.py defaults): batch, neighbours a side, BFS steps,
# hidden width, Adam's rate
SEAL_B, SEAL_NBRS, SEAL_STEPS, SEAL_HIDDEN, SEAL_LR = 64, 6, 2, 32, 0.01
SEAL_K, SEAL_ROUNDS = 20, 3  # K steps a call; timed calls after one
SEAL_GATHER_ROWS = (SEAL_B * (2 + 2 * SEAL_NBRS),)  # 896 rows a gather
SEAL_QUALITY_STEPS, SEAL_HITS_BAR = 150, 0.6  # tests/test_real_datasets.py
SUBGRAPH_QUERY_BATCH, SUBGRAPH_QUERY_CALLS = 1024, 20
SAGE_UNSUP_EPOCHS, SAGE_UNSUP_STEPS = 2, 30


def host_adjacency(src, dst, weights, nodes):
    """{node: (neighbour ids, edge ids)} of ``nodes`` from the edge arrays,
    each row in the store's adjacency order (weight descending where the
    edge type is weighted, then edge id), found without the CSR."""
    want = np.asarray(sorted(nodes))
    eid = np.flatnonzero(np.isin(src, want))
    s = src[eid]
    w = (np.zeros(eid.size) if weights is None
         else -weights[eid].astype(np.float64))
    order = np.lexsort((eid, w, s))
    eid, s = eid[order], s[order]
    starts = np.searchsorted(s, want, side="left")
    ends = np.searchsorted(s, want, side="right")
    return {int(v): (dst[eid[a:b]], eid[a:b])
            for v, a, b in zip(want, starts, ends)}


def _host_bfs(n, edges, root, steps):
    """Hop distances from ``root`` over the undirected local ``edges``, up
    to ``steps`` hops; ``steps + 1`` where unreached."""
    nbrs = [[] for _ in range(n)]
    for a, b in edges:
        nbrs[a].append(b)
        nbrs[b].append(a)
    dist = [steps + 1] * n
    if root >= n:
        return dist
    dist[root], frontier = 0, [root]
    for d in range(1, steps + 1):
        nxt = []
        for v in frontier:
            for u in nbrs[v]:
                if dist[u] > d:
                    dist[u] = d
                    nxt.append(u)
        frontier = nxt
    return dist


def induce_host(adj, seeds, cap, steps=None):
    """The induction of one seed set on the host: (sorted unique seeds,
    local edges [(i, j)] in (i, slot) order, their edge ids, and with
    ``steps`` the BFS distances of the padded [len(seeds)] node slots to
    local nodes 0 and 1), from ``host_adjacency``'s rows."""
    uniq = sorted(set(int(x) for x in seeds))
    pos = {v: i for i, v in enumerate(uniq)}
    edges, eids = [], []
    for i, v in enumerate(uniq):
        nbr, eid = adj[v]
        for u, e in zip(nbr[:cap], eid[:cap]):
            if int(u) in pos:
                edges.append((i, pos[int(u)]))
                eids.append(int(e))
    dists = None
    if steps is not None:
        n = len(seeds)
        dists = [_host_bfs(n, edges, r, steps) for r in (0, 1)]
    return uniq, edges, eids, dists


def check_induction(torch, sg, adj, seed_sets, cap, steps, what):
    """Each sample of ``sg`` (``induce_batched`` of ``seed_sets`` [B, S])
    exactly the host induction: node ids and their fill, counts, the edges,
    their ids and the padding after them, and the BFS distances.  Returns
    (rows cut at the cap, edges kept)."""
    from graph_learn_tpu_torch.ops.subgraph import FILL
    got = {f: getattr(sg, f).cpu().numpy() for f in (
        "node_ids", "num_nodes", "edge_index", "num_edges", "edge_ids")}
    d2s = None if sg.dist_to_src is None else sg.dist_to_src.cpu().numpy()
    d2d = None if sg.dist_to_dst is None else sg.dist_to_dst.cpu().numpy()
    cut = kept = 0
    for i, seeds in enumerate(seed_sets):
        uniq, edges, eids, dists = induce_host(adj, seeds, cap, steps)
        n, e, S = len(uniq), len(edges), len(seeds)
        want_ids = np.asarray(uniq + [FILL] * (S - n))
        ei = got["edge_index"][i]
        ok = (np.array_equal(got["node_ids"][i], want_ids)
              and got["num_nodes"][i] == n and got["num_edges"][i] == e
              and np.array_equal(ei[:, :e].T, np.asarray(edges).reshape(
                  -1, 2)) and not ei[:, e:].any()
              and np.array_equal(got["edge_ids"][i][:e], np.asarray(
                  eids, dtype=np.int64))
              and (got["edge_ids"][i][e:] == -1).all())
        if dists is not None:
            ok = ok and np.array_equal(d2s[i], dists[0]) and np.array_equal(
                d2d[i], dists[1])
        check(ok, "%s: sample %d differs from the host induction" % (what,
                                                                     i))
        cut += sum(len(adj[v][0]) > cap for v in uniq)
        kept += e
    return cut, kept


def seal_path(torch, card, gather):
    """``examples/seal.py`` at ogbl-collab's counts and widths: the
    planted-community link set drawn at 235 868 nodes with 128 f32
    features and 1 179 052 undirected train pairs; one batch of induced
    subgraphs held exactly to the host induction; one step on Kernel 1
    against the same step on the plain version (bit for bit: Kernel 1 is a
    copy and every sum is a sorted reduction); the K-step form (K = 20)
    eager and in one CUDA graph from the same state, losses bit-equal,
    with ms a step, subgraphs/s, device busy, kernels and Kernel 1
    launches per replayed step; Kernel 1 cold at the step's 896 rows; then
    the planted 400-node set written as ogbl-collab tables, 150 steps
    through ``--collab_dir`` (the store bit-equal to its in-memory twin),
    hits@50 at least 0.6.  Returns the kernels line's fields."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import seal
    from graph_learn_tpu_torch.ops.kernels import dispatch
    from graph_learn_tpu_torch.ops.sampling import uniform_draw
    from graph_learn_tpu_torch.ops.subgraph import FILL, induce_batched

    t0 = time.perf_counter()
    a = seal.planted_collab(seal.COLLAB_NODES, seal.COLLAB_TRAIN_PAIRS, 0, 0,
                            0, feat_dim=seal.COLLAB_FEAT)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    src, dst = a["train"][:, 0], a["train"][:, 1]
    g = seal.build_graph(a["feats"], src, dst, "cuda")
    et = g.store.edge_table("relation").device("cuda")
    feats = g.store.node_table("item").device("cuda").float_attrs
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    host = g.store.edge_table("relation")
    check(host.num_edges == 2 * seal.COLLAB_TRAIN_PAIRS
          and tuple(feats.shape) == (seal.COLLAB_NODES, seal.COLLAB_FEAT)
          and feats.dtype == torch.float32,
          "seal store: %d edges, table %s %s" % (host.num_edges,
                                                  tuple(feats.shape),
                                                  feats.dtype))
    log("seal store (planted communities at ogbl-collab's counts: %d nodes, "
        "%d undirected train pairs = %d edges, [%d, %d] f32 features): host "
        "draw %.1f s, store and tables onto the card %.1f s"
        % (seal.COLLAB_NODES, seal.COLLAB_TRAIN_PAIRS, host.num_edges,
           *feats.shape, draw_s, build_s))

    # 1. one batch of induced subgraphs against the host induction
    gen = torch.Generator(device="cuda").manual_seed(31)
    eidx = torch.randint(0, host.num_edges, (SEAL_B,), generator=gen,
                         device="cuda", dtype=torch.int32)
    s_ids, d_ids = et.src[eidx.long()], et.dst[eidx.long()]
    u = [torch.rand((SEAL_B, SEAL_NBRS), generator=gen, device="cuda")
         for _ in range(2)]
    sn, _ = uniform_draw(et.out, s_ids, u[0])
    dn, _ = uniform_draw(et.out, d_ids, u[1])
    seeds = torch.cat([s_ids[:, None], d_ids[:, None], sn, dn], 1)
    cap = 2 * SEAL_NBRS + 2
    sg = induce_batched(et.out, seeds, nbr_cap=cap, need_dist=True,
                        num_bfs_steps=SEAL_STEPS)
    seed_sets = seeds.cpu().numpy()
    adj = host_adjacency(host.src, host.dst, host.weights,
                         set(seed_sets.reshape(-1).tolist()))
    cut, kept = check_induction(torch, sg, adj, seed_sets, cap, SEAL_STEPS,
                                "seal batch")
    log("seal batch (%d pairs, %d neighbours a side, cap %d, BFS %d): node "
        "sets, edges, edge ids and distances of every subgraph equal the "
        "host induction from the edge arrays; %d nodes, %d edges kept, %d "
        "rows cut at the cap"
        % (SEAL_B, SEAL_NBRS, cap, SEAL_STEPS, int(sg.num_nodes.sum()), kept,
           cut))

    # 2. one step on Kernel 1 against the same step on the plain version
    def one_step(plain):
        model = seal.seal_model(seal.COLLAB_FEAT, SEAL_HIDDEN,
                                device="cuda")
        g_ = torch.Generator(device="cuda").manual_seed(37)
        kernel = dispatch.gather_rows
        if plain:
            dispatch.gather_rows = gather.gather_rows_plain
        try:
            gather.LAUNCHES.reset()
            loss, _, _ = seal.seal_loss(model, et, feats, eidx, g_)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            torch.cuda.synchronize()
            launches = gather.LAUNCHES.count
        finally:
            dispatch.gather_rows = kernel
        return loss.detach(), grads, launches

    loss_k, grads_k, launches_k = one_step(False)
    loss_p, grads_p, launches_p = one_step(True)
    check(launches_k == 2 and launches_p == 0, "seal step: %d gather_rows "
          "launches on the kernels (want 2), %d on the plain versions"
          % (launches_k, launches_p))
    check(torch.equal(loss_k, loss_p) and all(
        torch.equal(x_, y_) for x_, y_ in zip(grads_k, grads_p)),
          "seal step: loss %r or a gradient differs between Kernel 1 and "
          "the plain version" % ((loss_k.item(), loss_p.item()),))
    log("seal step (GCN([%d, %d]) + LinkPredictor(%d), one random negative "
        "a pair): loss %.6f and all %d gradients bit-equal on Kernel 1 (2 "
        "gather_rows launches) and on the plain version"
        % (seal.COLLAB_FEAT + SEAL_STEPS + 2, SEAL_HIDDEN, SEAL_HIDDEN,
           loss_k.item(), len(grads_k)))

    # 3. the K-step form, eager then captured, from the same state
    def k_steps(capture):
        model = seal.seal_model(seal.COLLAB_FEAT, SEAL_HIDDEN,
                                device="cuda")
        opt = bench.make_optimizer(model, torch.device("cuda"), SEAL_LR)
        step = seal.SealSteps(model, opt, et, feats, SEAL_B, SEAL_K,
                              torch.Generator(device="cuda").manual_seed(41),
                              capture)
        gather.LAUNCHES.reset()
        t0 = time.perf_counter()
        step()
        losses = [step.losses.clone()]
        float(step.losses[-1])
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(SEAL_ROUNDS):
            step()
            losses.append(step.losses.clone())
        float(step.losses[-1])
        ms = (time.perf_counter() - t0) / (SEAL_K * SEAL_ROUNDS) * 1e3
        return step, torch.cat(losses).cpu().numpy(), ms, warm_s, \
            gather.LAUNCHES.count

    e_step, el, e_ms, _, e_launches = k_steps(False)
    c_step, cl, c_ms, c_warm, _ = k_steps(True)
    n_steps = (1 + SEAL_ROUNDS) * SEAL_K
    check(e_launches == 2 * n_steps, "seal K-step eager: %d gather_rows "
          "launches over %d steps, want 2 a step" % (e_launches, n_steps))
    check(el.shape == cl.shape == (n_steps,) and bool(np.isfinite(cl).all()),
          "seal K-step: %s eager and %s graph losses, or one not finite"
          % (el.shape, cl.shape))
    check(np.array_equal(el, cl), "seal K-step: the graph's losses differ "
          "from the eager ones from the same state: max relative %g"
          % np.max(np.abs(el - cl) / np.abs(el)))
    rows = {}
    for label, step, ms, calls in (("eager", e_step, e_ms, 1),
                                   ("graph", c_step, c_ms, 2)):
        fn = step.run_eager if label == "eager" else step
        work, kms = device_work_per_call(torch, fn, calls=calls)
        kernels = sum(c for n, c in work.items()
                      if not n.startswith("Memset")) / SEAL_K
        busy = sum(c * kms[n] for n, c in work.items()) / SEAL_K
        k1 = sum(c for n, c in work.items() if "gather_rows" in n) / SEAL_K
        check(k1 == 2.0, "seal K-step %s: %s gather_rows kernels a step from "
              "the profiler, want 2" % (label, k1))
        rows[label] = dict(ms=ms, busy=busy, kernels=kernels, k1=k1,
                           top=sorted(((c * kms[n] / SEAL_K, n)
                                       for n, c in work.items()),
                                      reverse=True)[:8])
    for label in ("eager", "graph"):
        r = rows[label]
        log("seal K-step %s (K = %d, %d steps after 1 warm-up call, 2 x %d "
            "subgraphs a step): %.4f ms a step, %.1f subgraphs/s, device busy "
            "%.4f ms (%.1f%%), %.1f kernels and %.0f gather_rows a step%s; "
            "card: %s"
            % (label, SEAL_K, SEAL_ROUNDS * SEAL_K, SEAL_B, r["ms"],
               2 * SEAL_B / r["ms"] * 1e3, r["busy"],
               100.0 * r["busy"] / r["ms"], r["kernels"], r["k1"],
               "; capture call %.3f s, graph pool %.1f MB, %d losses "
               "bit-equal eager and captured (%.4f -> %.4f)"
               % (c_warm, c_step.pool_bytes / 1e6, n_steps, cl[0], cl[-1])
               if label == "graph" else "", card))
        for ms_, name in r["top"]:
            log("  device %.4f ms a %s step: %s" % (ms_, label, name[:90]))
    del e_step, c_step
    gc.collect()
    torch.cuda.empty_cache()

    # 4. Kernel 1 cold at the step's 896 rows of this table: the batch's
    # node slots, the padding at row 0 (BatchGraph.from_subgraphs)
    node_ids = torch.where(sg.node_ids == FILL, 0, sg.node_ids).reshape(-1)
    shapes = gather_shapes(torch, gather, feats, gen, "at the ogbl-collab "
                           "table", rows=SEAL_GATHER_ROWS,
                           given={node_ids.numel(): node_ids},
                           yardsticks=SEAL_GATHER_ROWS)

    # 5. quality: the planted 400-node set written as ogbl-collab tables,
    # 150 steps through --collab_dir, hits@50
    import tempfile

    from graph_learn_tpu_torch.examples.data import ogbl_collab
    p = seal.planted_collab()
    where = tempfile.mkdtemp(prefix="glt_seal_collab_")
    try:
        ogbl_collab.write_collab_tables(
            where, p["train"], np.ones(len(p["train"])), p["valid"],
            p["valid_neg"], p["test"], p["test_neg"], p["feats"])
        t0 = time.perf_counter()
        hits = seal.main(["--collab_dir", where, "--steps",
                          str(SEAL_QUALITY_STEPS)])
        wall = time.perf_counter() - t0
        same_store(torch, seal.load_collab(where), seal.build_graph(
            p["feats"], p["train"][:, 0], p["train"][:, 1], "cuda"),
            "seal collab files")
    finally:
        shutil.rmtree(where, ignore_errors=True)
    log("seal --collab_dir on the planted 400-node set written as "
        "ogbl-collab tables (the store bit-equal to its in-memory twin; %d "
        "steps of batch 64, as tests/test_real_datasets.py runs the JAX "
        "example): hits@50 %.4f (bar %.2f) in %.1f s; card: %s"
        % (SEAL_QUALITY_STEPS, hits, SEAL_HITS_BAR, wall, card))
    check(hits >= SEAL_HITS_BAR, "seal: hits@50 %.4f under %.2f"
          % (hits, SEAL_HITS_BAR))
    fields = {"seal_launches_per_step": rows["graph"]["k1"],
              "seal_hits_at_50": hits}
    for m, f in shapes.items():
        fields.update({
            "cold_ms_seal_%d" % m: f["ms"], "bound_ms_seal_%d" % m:
            f["bound_ms"], "plain_cold_ms_seal_%d" % m: f["plain_ms"],
            "library_cold_ms_seal_%d" % m: f["library_ms"],
            "kernel_route_seal_%d" % m: f["route"]})
    return {"gather_rows": fields}


def subgraph_query_path(torch, card, gather, graph):
    """``V("item").batch(1024).alias("s").SubGraph("rel",
    need_dist=True).alias("sg").values()`` (cap
    ``conf.default_full_nbr_num``) on the weighted 61.25M-edge store that
    the bench phase built under the "minimal" profile: one answer held
    exactly to the host induction (the rows cut at the cap counted), the
    node rows materialised once through their DeferredRows (one gather_rows
    launch, bit for bit against the plain version), and the ms a query.
    Returns the kernels line's fields."""
    from graph_learn_tpu_torch.config import conf
    from graph_learn_tpu_torch.gsl.compile import _execute

    g, _ = graph
    host = g.store.edge_table("rel")
    q = (g.V("item").batch(SUBGRAPH_QUERY_BATCH).alias("s")
         .SubGraph("rel", need_dist=True).alias("sg").values())
    tables = q.device_tables()
    table = tables["nodes"]["item"].float_attrs
    n = table.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(43)
    seeds = torch.randint(0, n, (SUBGRAPH_QUERY_BATCH,), generator=gen,
                          device="cuda", dtype=torch.int32)
    sg = _execute(q, tables, seeds, gen)["sg"]
    cap = conf.default_full_nbr_num
    t0 = time.perf_counter()
    seed_set = seeds.cpu().numpy()
    adj = host_adjacency(host.src, host.dst, host.weights,
                         set(seed_set.tolist()))
    cut, kept = check_induction(
        torch, sg.map(lambda x: x[None]), adj, seed_set[None], cap, 3,
        "subgraph query")
    host_s = time.perf_counter() - t0
    gather.LAUNCHES.reset()
    rows = sg.nodes.float_attrs.materialize()
    torch.cuda.synchronize()
    launches = gather.LAUNCHES.count
    idx = sg.nodes.float_attrs.idx
    check(launches == 1 and torch.equal(rows, gather.gather_rows_plain(
        table, torch.clamp(idx, 0, n - 1))), "subgraph query: %d gather_rows "
          "launches materialising the node rows, or rows not bit-equal to "
          "gather_rows_plain" % launches)

    def query():
        return _execute(q, tables, seeds, gen)["sg"].edge_index

    query()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SUBGRAPH_QUERY_CALLS):
        query()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / SUBGRAPH_QUERY_CALLS * 1e3
    work, kms = device_work_per_call(torch, query, calls=5)
    busy = sum(c * kms[k] for k, c in work.items())
    log("subgraph query (V(\"item\").batch(%d).SubGraph(\"rel\", "
        "need_dist=True), cap %d, on the weighted 61.25M-edge minimal "
        "store): %d nodes, %d edges, %d of %d rows cut at the cap; node "
        "sets, edges, edge ids and distances equal the host induction (%.1f "
        "s on the host); node rows [%d, %d] %s by 1 gather_rows launch, "
        "bit-equal to gather_rows_plain; %.4f ms a query on the host clock, "
        "device busy %.4f ms, %.0f kernels; card: %s"
        % (SUBGRAPH_QUERY_BATCH, cap, int(sg.num_nodes), kept, cut,
           int(sg.num_nodes), host_s, rows.shape[0], rows.shape[1],
           rows.dtype, ms, busy, sum(work.values()), card))
    return {"gather_rows": {"subgraph_query_launches": launches,
                            "subgraph_query_ms": ms}}


def sage_unsup_path(torch, card, gather):
    """``examples/sage_unsupervised.py`` at its defaults on the card
    (cora_like 800 nodes from the TSV files ``load`` writes, its store
    bit-equal to the in-memory twin; batch 128, 16 ``full`` neighbours,
    32-wide features): LocalTrainer for 2 epochs of 30 steps, every loss
    finite, Kernel 1 at 2 launches a step (each edge-star BatchGraph
    gathers its rows once), and the link accuracy above 0.5.  Returns the
    kernels line's fields."""
    import tempfile

    from graph_learn_tpu_torch.examples import node2vec as n2v
    from graph_learn_tpu_torch.examples import sage_unsupervised as su
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer

    where = tempfile.mkdtemp(prefix="glt_sage_unsup_")
    try:
        g, dec = su.load(where, 32, "cuda")
    finally:
        shutil.rmtree(where, ignore_errors=True)
    same_store(torch, g, su.build_graph(n2v.cora_like(
        n=su.NODES, feat_dim=32, text=True), "cuda")[0],
        "sage_unsupervised files")
    q = su.build_query(g, 128, 16)
    model = su.SageLink(dec, 32, 32, 32, device="cuda")
    tr = LocalTrainer(device="cuda")
    losses = []

    def loss_fn(m, batch, generator, training):
        loss = su.link_loss(m, batch, generator, training)
        losses.append(loss.detach())
        return loss

    gather.LAUNCHES.reset()
    t0 = time.perf_counter()
    _, history = tr.train(q, model, loss_fn,
                          torch.optim.Adam(model.parameters(), lr=5e-4),
                          epochs=SAGE_UNSUP_EPOCHS,
                          steps_per_epoch=SAGE_UNSUP_STEPS, verbose=False)
    torch.cuda.synchronize()
    # an epoch of the train edges in batches of 128 may end before 30 steps
    n_steps = len(losses)
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    per_step = gather.LAUNCHES.count / n_steps
    check(per_step == 2.0 and bool(torch.isfinite(torch.stack(losses)).all()),
          "sage_unsupervised: %s gather_rows launches a step (want 2), "
          "epoch losses %s" % (per_step, history))
    acc = tr.evaluate(q, model, su.link_accuracy)
    log("sage_unsupervised (from its TSV files, the store bit-equal to its "
        "in-memory twin; edge stars, batch 128, 16 full neighbours, "
        "GraphSAGE [32, 32, 32], %d epochs of at most %d steps: %d steps, "
        "every loss finite): epoch losses %s, %.3f ms a step on the host "
        "clock, %.0f gather_rows a step; link accuracy (pos > neg) %.4f; "
        "card: %s"
        % (SAGE_UNSUP_EPOCHS, SAGE_UNSUP_STEPS, n_steps,
           [round(v, 4) for v in history], step_ms, per_step, acc, card))
    check(acc > 0.5, "sage_unsupervised: link accuracy %.4f not above 0.5"
          % acc)
    return {"gather_rows": {"sage_unsup_launches_per_step": per_step,
                            "sage_unsup_link_accuracy": acc}}


# ---------------------------------------------------------------------------
# Phase 20: file ingest, the sampler API and k-NN
# ---------------------------------------------------------------------------


# the train split of the TSV store: the first tenth of the ids
FILE_TRAIN_SHARE = 10
# lines of each file parsed by both routes, the native loader and Python's
FILE_CHECK_LINES = 10_000
FILE_TRAIN_STEPS = 10
# features written at five decimals: read back within half a unit of the
# fifth decimal, plus the float32 rounding of the parse (one ulp)
FILE_FEATURE_TOL = 5e-6
SAMPLER_BATCH = 1024
SAMPLER_CALLS = 5
SAMPLER_NEG_K = 5
SAMPLER_FULL_CAP = 16
SAMPLER_SUBGRAPH_CAP = 100
SAMPLER_WALK = (20, 0.5, 2.0)  # length, p, q
NEIGHBOR_STRATEGIES = ("random", "topk", "edge_weight", "in_degree",
                       "random_without_replacement")
# SIFT1M (ann-benchmarks / INRIA TEXMEX): 1 000 000 base vectors of 128
# f32, 10 000 queries, L2, neighbours to depth 100.  The vectors are drawn:
# 1 000 Gaussian centres (spread 4) with unit-spread points about them;
# each query is a base vector plus noise at 1% of the points' spread
KNN_BASE, KNN_QUERIES, KNN_DIM, KNN_K = 1_000_000, 10_000, 128, 100
KNN_CENTRES, KNN_SPREAD, KNN_NOISE, KNN_SEED = 1_000, 4.0, 0.01, 20
# faiss's rule of thumb for the cells, 4 * sqrt(N); probes
KNN_NLIST, KNN_NPROBE = 4_096, 16
KNN_CHECK_QUERIES = 256
KNN_PEAK_BYTES = 8e9
KNN_SELF_RECALL = 0.99
# the chunked search against one unchunked computation: ids where the gap
# between the k-th and (k+1)-th score exceeds KNN_GAP, distances within
# KNN_DIST_RTOL of the row's largest distance
KNN_GAP, KNN_DIST_RTOL = 1e-3, 1e-4
KNN_CONFIGS = (("flat", 0), ("flat", 1), ("ivfflat", 0), ("ivfpq", 0))


def int_text(v, width):
    """[n] non-negative ints -> [n, width] uint8: the decimal digits
    right-aligned, 0 bytes (dropped by ``text_rows``) before them."""
    rest = np.asarray(v, np.int64).copy()
    check(not (rest < 0).any(), "tsv: a negative id or label")
    out = np.zeros((rest.size, width), np.uint8)
    for j in range(width - 1, -1, -1):
        out[:, j] = np.where((rest > 0) | (j == width - 1), rest % 10 + 48, 0)
        rest //= 10
    check(not rest.any(), "tsv: a value wider than %d digits" % width)
    return out


def fixed5_text(x):
    """[n, d] floats -> [n, d, 9] uint8: each value at five decimals
    (``-dd.ddddd``, 0 bytes for an absent sign or tens digit)."""
    scaled = np.rint(np.asarray(x, np.float64) * 1e5).astype(np.int64)
    a = np.abs(scaled)
    whole, frac = a // 100_000, a % 100_000
    check(int(whole.max(initial=0)) < 100, "tsv: a feature of 100 or more")
    out = np.zeros(scaled.shape + (9,), np.uint8)
    out[..., 0] = np.where(scaled < 0, ord("-"), 0)
    out[..., 1] = np.where(whole >= 10, whole // 10 + 48, 0)
    out[..., 2] = whole % 10 + 48
    out[..., 3] = ord(".")
    for j in range(5):
        out[..., 4 + j] = frac // 10 ** (4 - j) % 10 + 48
    return out


def sci9_text(w):
    """[n] non-negative floats -> [n, 14] uint8: nine significant digits,
    ``d.dddddddde-XX`` (``%.8e``'s form; nine digits read back to the same
    float32)."""
    w64 = np.asarray(w, np.float64)
    check(not (w64 < 0).any(), "tsv: a negative weight")
    pos = w64 > 0
    e = np.where(pos, np.floor(np.log10(np.where(pos, w64, 1.0))),
                 0).astype(np.int64)
    m = np.rint(w64 * 10.0 ** (8 - e)).astype(np.int64)
    for wrong, step in ((m >= 10 ** 9, 1), (pos & (m < 10 ** 8), -1)):
        e = np.where(wrong, e + step, e)
        m = np.where(wrong, np.rint(w64 * 10.0 ** (8 - e)).astype(np.int64),
                     m)
    digits = int_text(m, 9)
    digits[digits == 0] = ord("0")  # a zero weight: 0.00000000e+00
    out = np.zeros((w64.size, 14), np.uint8)
    out[:, 0] = digits[:, 0]
    out[:, 1] = ord(".")
    out[:, 2:10] = digits[:, 1:]
    out[:, 10] = ord("e")
    out[:, 11] = np.where(e < 0, ord("-"), ord("+"))
    out[:, 12:14] = int_text(np.abs(e), 2)
    out[:, 12:14][out[:, 12:14] == 0] = ord("0")
    return out


def text_rows(blocks, seps):
    """One table's records as bytes: the [n, w] uint8 column ``blocks``
    row by row, each followed by its separator byte (the last by a
    newline), the 0 bytes dropped."""
    n = blocks[0].shape[0]
    parts = []
    for block, sep in zip(blocks, list(seps) + ["\n"]):
        parts += [block, np.full((n, 1), ord(sep), np.uint8)]
    mat = np.concatenate(parts, axis=1)
    return mat[mat != 0].tobytes()


def write_store_tsv(where, nt, et, train_ids):
    """The store's node table (id, label, float features at five
    decimals), edge table (src, dst, weight at nine significant digits)
    and train split (ids) as TSV files under ``where``, written
    vectorised.  Returns ({name: path}, {name: bytes}, seconds)."""
    t0 = time.perf_counter()
    n, d = nt.float_attrs.shape
    width = len(str(int(nt.raw_ids.max())))
    feats = np.concatenate(
        [fixed5_text(nt.float_attrs),
         np.full((n, d, 1), ord(":"), np.uint8)], axis=2).reshape(n, -1)
    feats = feats[:, :-1]  # no separator after the last feature
    texts = {
        "nodes": b"id:int64\tlabel:int64\tfeature:string\n" + text_rows(
            [int_text(nt.raw_ids, width), int_text(nt.labels, 4), feats],
            "\t\t"),
        "edges": b"src_id:int64\tdst_id:int64\tweight:float\n" + text_rows(
            [int_text(nt.raw_ids[et.src], width),
             int_text(nt.raw_ids[et.dst], width),
             sci9_text(et.weights)], "\t\t"),
        "train": b"id:int64\n" + text_rows([int_text(train_ids, width)], ""),
    }
    paths = {}
    for name, text in texts.items():
        paths[name] = os.path.join(where, name)
        with open(paths[name], "wb") as f:
            f.write(text)
    return paths, {k: len(v) for k, v in texts.items()}, \
        time.perf_counter() - t0


def head_file(path, lines, where):
    """The header and first ``lines`` records of ``path``, as a new file."""
    with open(path, "rb") as f:
        head = b"".join(f.readline() for _ in range(lines + 1))
    out = os.path.join(where, os.path.basename(path) + ".head")
    with open(out, "wb") as f:
        f.write(head)
    return out


def check_native_route(native_ingest):
    """File ingest takes the native loader (csrc/ingest.cpp, built into
    graph_learn_tpu_torch/_build/); fails where it would take the Python
    parser."""
    check(native_ingest.available(), "file ingest: the native loader "
          "(csrc/ingest.cpp) was not built, so tables would be parsed by "
          "the Python parser")
    return str(native_ingest.library_path())


def same_columns(a, b):
    return set(a) == set(b) and all(
        (a[k] is None and b[k] is None) or (
            a[k] is not None and b[k] is not None
            and a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))
        for k in a)


def file_tier_path(torch, card, gather, spmm):
    """20a: the port bench's CFG store written as TSV, loaded through
    Graph(device="cuda").node(...).node(..., mask=TRAIN).edge(...).init()
    on the native route and held to synthetic_graph of the same seed; the
    two parse routes held to each other; LocalTrainer steps of the 2-hop
    EgoGraphSAGE query on the train split.  Returns (the kernels line's
    fields, the loaded graph, its node decoder)."""
    import shutil
    import tempfile

    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.core import ingest, native_ingest
    from graph_learn_tpu_torch.nn import data as gdata
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from torch.profiler import ProfilerActivity, profile

    cfg = bench.CFG
    n, d = cfg["n_nodes"], cfg["feat_dim"]
    lib = check_native_route(native_ingest)
    syn, _ = gl.synthetic_graph(n, cfg["avg_degree"], d, cfg["classes"],
                                seed=0, device="cuda")
    snt, set_ = syn.store.node_table("item"), syn.store.edge_table("rel")
    train_ids = snt.raw_ids[:n // FILE_TRAIN_SHARE]
    where = tempfile.mkdtemp(prefix="glt_tsv_")
    try:
        paths, sizes, write_s = write_store_tsv(where, snt, set_, train_ids)
        node_dec = gl.Decoder(labeled=True, attr_types=["float"] * d)
        edge_dec = gl.Decoder(weighted=True)
        decs = {"nodes": (node_dec, ingest.load_node_table),
                "edges": (edge_dec, ingest.load_edge_table),
                "train": (gl.Decoder(), ingest.load_node_table)}
        parse_s = {}
        for name, (dec, load) in decs.items():
            t0 = time.perf_counter()
            load(paths[name], dec)
            parse_s[name] = time.perf_counter() - t0
            head = head_file(paths[name], FILE_CHECK_LINES, where)
            ids = ingest.EDGE_IDS if name == "edges" else ingest.NODE_IDS
            check(same_columns(load(head, dec),
                               ingest._parse_records(head, ids, dec)),
                  "file ingest: the native loader and the Python parser "
                  "disagree on the first %d lines of %s"
                  % (FILE_CHECK_LINES, name))
        t0 = time.perf_counter()
        g = (gl.Graph(device="cuda").node(paths["nodes"], "item", node_dec)
             .node(paths["train"], "item", gl.Decoder(), mask=gl.Mask.TRAIN)
             .edge(paths["edges"], ("item", "item", "rel"), edge_dec).init())
        init_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    nt, et = g.store.node_table("item"), g.store.edge_table("rel")
    t0 = time.perf_counter()
    dev = et.device("cuda")
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    ref = set_.device("cuda")
    check(np.array_equal(nt.raw_ids, snt.raw_ids)
          and np.array_equal(nt.labels, snt.labels)
          and np.array_equal(et.src, set_.src)
          and np.array_equal(et.dst, set_.dst)
          and np.array_equal(et.weights, set_.weights),
          "file ingest: ids, labels, edges or weights differ from "
          "synthetic_graph's")
    err = np.abs(nt.float_attrs - snt.float_attrs)
    tol = FILE_FEATURE_TOL + np.spacing(np.abs(snt.float_attrs))
    check(bool((err <= tol).all()), "file ingest: features off by %g, more "
          "than %g plus one float32 ulp" % (err.max(), FILE_FEATURE_TOL))
    for side in ("out", "inc"):
        for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "cum_weights"):
            check(torch.equal(getattr(getattr(dev, side), f),
                              getattr(getattr(ref, side), f)),
                  "file ingest: CSR %s.%s differs from synthetic_graph's"
                  % (side, f))
    check(np.array_equal(g.store.node_set("MASK*item").indices,
                         np.arange(train_ids.size)),
          "file ingest: the train split is not the first tenth of the ids")
    del syn, snt, set_, ref
    gc.collect()
    log("file ingest (the bench CFG store as TSV: %d nodes with %d float "
        "features at five decimals, %d weighted edges at nine significant "
        "digits, a train split of %d ids): %s bytes written in %.3f s "
        "(vectorised); parsed on the native route (%s) in %s s; "
        "Graph.node/edge/init %.3f s; CSR build and upload %.3f s (host "
        "%.3f s); ids, labels, weights and both CSRs bit-equal to "
        "synthetic_graph's, features within %g + 1 ulp (max %g); the first "
        "%d lines of each file bit-equal on the Python parser; card: %s"
        % (n, d, et.num_edges, train_ids.size, sizes, write_s, lib,
           {k: round(v, 3) for k, v in parse_s.items()}, init_s, csr_s,
           et.host_build_s, FILE_FEATURE_TOL, err.max(), FILE_CHECK_LINES,
           card))

    k1, k2 = FANOUT
    q = (g.V("item", mask=gl.Mask.TRAIN).batch(MICRO_BATCH)
         .shuffle(traverse=True).alias("src")
         .outV("rel").sample(k1).by("random").alias("hop1")
         .outV("rel").sample(k2).by("random").alias("hop2").values())
    model = EgoGraphSAGE([d, HIDDEN, cfg["classes"]], node_dec,
                         agg_type="gcn", device="cuda")
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    tr = LocalTrainer(seed=0, device="cuda")
    losses = []

    def loss_fn(m, batch, generator, training):
        ego = gdata.EgoGraph.from_query_result(batch, "src", HOPS)
        loss = supervised_softmax_loss(m(ego, training=True),
                                       batch["src"].labels)
        losses.append(loss.detach())
        return loss

    def pre_aggregate(batch, tables):
        return gdata.pre_aggregate_hop(
            batch, "hop2", tables["nodes"]["item"].float_attrs)

    def train(steps):
        t0 = time.perf_counter()
        tr.train(q, model, loss_fn, opt, epochs=1, steps_per_epoch=steps,
                 verbose=False, batch_transform=pre_aggregate)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    train(2)  # warm-up
    del losses[:]
    gather.LAUNCHES.reset()
    spmm.LAUNCHES.reset()
    wall = train(FILE_TRAIN_STEPS)
    per_step = {"gather_rows": gather.LAUNCHES.count / FILE_TRAIN_STEPS,
                "segment_spmm": spmm.LAUNCHES.count / FILE_TRAIN_STEPS}
    check(per_step == {"gather_rows": 2.0, "segment_spmm": 1.0}
          and len(losses) == FILE_TRAIN_STEPS
          and bool(torch.isfinite(torch.stack(losses)).all()),
          "file store training: launches a step %s (want 2 gather_rows and "
          "1 segment_spmm), %d losses" % (per_step, len(losses)))
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = train(n_prof)
    by_kernel = device_ms_by_kernel(prof)
    seen = {k: sum(1 for ev in prof.events()
                   if k in ev.name and str(getattr(
                       ev, "device_type", "")).endswith("CUDA")) / n_prof
            for k in per_step}
    busy = sum(by_kernel.values()) / n_prof
    step_ms = wall / FILE_TRAIN_STEPS * 1e3
    log("file store training (V(\"item\", mask=TRAIN).batch(%d), fanout %s, "
        "EgoGraphSAGE [%d, %d, %d] gcn, deepest hop pre-aggregated): %d "
        "steps in %.3f s, %.3f ms a step on the host clock, first and last "
        "loss %.4f / %.4f; launches a step %s (counters), %s (profiler); "
        "device busy %.3f ms a step (%.1f%% of the step under the "
        "profiler, %.3f ms); card: %s"
        % (MICRO_BATCH, list(FANOUT), d, HIDDEN, cfg["classes"],
           FILE_TRAIN_STEPS, wall, step_ms, losses[0].item(),
           losses[-1].item(), per_step, seen, busy,
           100 * busy / (prof_wall / n_prof * 1e3),
           prof_wall / n_prof * 1e3, card))
    fields = {"file_trainer_launches_per_step": per_step["gather_rows"],
              "file_step_ms": step_ms, "file_parse_s": sum(parse_s.values()),
              "file_text_bytes": sum(sizes.values())}
    return ({"gather_rows": fields,
             "segment_spmm": {"file_trainer_launches_per_step":
                              per_step["segment_spmm"]}}, g, node_dec)


def edge_mask(keys, n, rows, vals):
    """([m, k] bool: is each of ``vals`` [m, k] (numpy) an out-neighbour
    of its row in the edge ``keys``; [m] out-degrees of ``rows``)."""
    r = np.asarray(rows, np.int64)
    key = np.repeat(r, vals.shape[1]) * n + vals.reshape(-1).astype(np.int64)
    pos = np.minimum(np.searchsorted(keys, key), keys.size - 1)
    deg = np.searchsorted(keys, (r + 1) * n) - np.searchsorted(keys, r * n)
    return (keys[pos] == key).reshape(vals.shape), deg


def true_edges(keys, n, rows, nbrs, fill, live=None):
    """Hold [m, k] (numpy) ``nbrs`` of ``rows`` [m] to the edge ``keys``:
    each (where ``live``) an out-neighbour of its row, or ``fill`` where
    the row has none."""
    edge, deg = edge_mask(keys, n, rows, nbrs)
    ok = np.where(deg[:, None] > 0, edge, nbrs == fill)
    if live is not None:
        ok |= ~live
    check(bool(ok.all()), "samplers: %d draws are neither an out-edge of "
          "their row nor the fill of an empty row" % int((~ok).sum()))


def sampler_api_path(torch, card, gather, g):
    """20b: the pre-GSL sampler objects on the loaded store: node batches,
    neighbours by every strategy, edges, negatives, a subgraph and walks,
    each held to the host's edge arrays; every hop's feature rows
    materialised by one gather_rows launch, bit-equal to the plain
    version; ms a get().  Returns the kernels line's fields."""
    from graph_learn_tpu_torch.config import conf
    from graph_learn_tpu_torch.ops import negative

    host = g.store.edge_table("rel")
    n = g.store.node_table("item").num_nodes
    keys = edge_keys(host.src, host.dst, n)
    table = g.store.node_table("item").device("cuda").float_attrs
    fill = conf.default_neighbor_id
    ms, launches = {}, 0

    def timed(name, fn):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SAMPLER_CALLS):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / SAMPLER_CALLS * 1e3
        return out

    def rows_of(values, what):
        """Each value's feature rows, one gather_rows launch each, against
        the plain version."""
        nonlocal launches
        gather.LAUNCHES.reset()
        got = [v.float_attrs.materialize() for v in values]
        torch.cuda.synchronize()
        check(gather.LAUNCHES.count == len(values), "%s: %d gather_rows "
              "launches for %d hops" % (what, gather.LAUNCHES.count,
                                        len(values)))
        launches += gather.LAUNCHES.count
        for v, rows in zip(values, got):
            idx = torch.clamp(v.float_attrs.idx.reshape(-1), 0, n - 1)
            check(torch.equal(rows.reshape(-1, table.shape[1]),
                              gather.gather_rows_plain(table, idx)),
                  "%s: rows differ from gather_rows_plain" % what)

    nodes = timed("node_sampler", g.node_sampler(
        "item", SAMPLER_BATCH, "shuffle", seed=20).get)
    seeds = nodes.raw_ids.cpu().numpy()
    idx = nodes.ids.cpu().numpy()
    check(np.array_equal(seeds, idx) and np.unique(idx).size == idx.size,
          "node_sampler: not a batch of distinct ids")
    rows_of([nodes], "node_sampler")
    for s in NEIGHBOR_STRATEGIES:
        sampler = g.neighbor_sampler("rel", list(FANOUT), s, seed=21)
        hops = timed("neighbor_sampler/" + s, lambda: sampler.get(seeds))
        prev = idx
        for h in hops:
            ids = h.ids.cpu().numpy().reshape(prev.size, -1)
            true_edges(keys, n, prev, ids, fill)
            prev = ids.reshape(-1)
        rows_of(hops, "neighbor_sampler/" + s)
    full = g.neighbor_sampler("rel", [SAMPLER_FULL_CAP], "full", seed=21)
    sp = timed("neighbor_sampler/full", lambda: full.get(seeds))[0]
    ids, degs = sp.ids.cpu().numpy(), sp.degrees.cpu().numpy()
    live = np.arange(SAMPLER_FULL_CAP)[None, :] < degs[:, None]
    true_deg = (np.searchsorted(keys, (idx.astype(np.int64) + 1) * n)
                - np.searchsorted(keys, idx.astype(np.int64) * n))
    check(np.array_equal(degs, np.minimum(true_deg, SAMPLER_FULL_CAP))
          and bool((ids[~live] == fill).all()),
          "neighbor_sampler/full: degrees or fills wrong")
    true_edges(keys, n, idx, ids, fill, live)
    rows_of([sp], "neighbor_sampler/full")

    edges = timed("edge_sampler", g.edge_sampler(
        "rel", SAMPLER_BATCH, seed=22).get)
    eid = edges.edge_ids.cpu().numpy()
    check(np.array_equal(edges.src_nodes.ids.cpu().numpy(), host.src[eid])
          and np.array_equal(edges.dst_nodes.ids.cpu().numpy(),
                             host.dst[eid])
          and np.array_equal(edges.weights.cpu().numpy(), host.weights[eid]),
          "edge_sampler: endpoints or weights differ from the edge table")
    rows_of([edges.src_nodes, edges.dst_nodes], "edge_sampler")

    neg_s = g.negative_sampler("rel", SAMPLER_NEG_K, "in_degree", seed=23)
    state = neg_s.generator.get_state()
    negs = neg_s.get(seeds)
    et = g.store.edge_table("rel").device("cuda")
    replay = torch.Generator(device="cuda")
    replay.set_state(state)
    rounds = conf.sampling_retry_times + 1
    cands = negative.cdf_ids(et.unique_dst, et.unique_dst_indeg_cdf,
                             (SAMPLER_BATCH, SAMPLER_NEG_K, rounds), replay)
    check(torch.equal(negative.pick_negatives(
        et, torch.as_tensor(idx, device="cuda"), cands), negs.ids),
        "negative_sampler/in_degree: not pick_negatives of its candidates")
    neg = negs.ids.cpu().numpy()
    check(bool(np.isin(neg, et.unique_dst.cpu().numpy()).all()),
          "negative_sampler/in_degree: a negative outside the dst pool")
    hit = edge_mask(keys, n, idx, neg)[0]
    all_hit = edge_mask(keys, n, idx, cands.cpu().numpy().reshape(
        SAMPLER_BATCH, -1))[0].reshape(cands.shape).all(axis=-1)
    check(not bool((hit & ~all_hit).any()), "negative_sampler/in_degree: a "
          "true neighbour kept where a candidate round was not one")
    timed("negative_sampler/in_degree", lambda: neg_s.get(seeds))
    node_neg = timed("negative_sampler/node", lambda: g.negative_sampler(
        "item", SAMPLER_NEG_K, seed=24).get(seeds))
    check(tuple(node_neg.ids.shape) == (SAMPLER_BATCH, SAMPLER_NEG_K)
          and bool(((node_neg.ids >= 0) & (node_neg.ids < n)).all()),
          "negative_sampler/node: ids outside the node table")
    rows_of([negs, node_neg], "negative_sampler")

    sub = g.subgraph_sampler("item", "rel", [SAMPLER_SUBGRAPH_CAP], seed=25)
    sg = timed("subgraph_sampler", lambda: sub.get(seeds))
    adj = host_adjacency(host.src, host.dst, host.weights, set(idx.tolist()))
    cut, kept = check_induction(torch, sg.map(lambda x: x[None]), adj,
                                idx[None], SAMPLER_SUBGRAPH_CAP, None,
                                "subgraph_sampler")
    rows_of([sg.nodes], "subgraph_sampler")

    length, p, qq = SAMPLER_WALK
    walker = g.random_walk_sampler("rel", length, p, qq, seed=26)
    walks = timed("random_walk_sampler", lambda: walker.get(seeds))
    steps, stuck = walk_invariants(walks.cpu().numpy(), idx, keys, n)
    log("sampler API on the file store (batch %d, card %s): ms a get() %s; "
        "every neighbour of random / topk / edge_weight / in_degree / "
        "random_without_replacement [%d, %d] and full (cap %d) an out-edge "
        "of its row or the fill of an empty row; edges at their table's "
        "endpoints and weights; in_degree negatives pick_negatives of their "
        "%d candidate rounds, in the dst pool, a true neighbour kept only "
        "where every round was one (%d slots); subgraph (cap %d) equal to "
        "the host induction (%d edges, %d rows cut); walks (len %d, p %g, q "
        "%g) along edges (%d steps, %d stuck); %d gather_rows launches "
        "materialising every answer's rows, each bit-equal to "
        "gather_rows_plain"
        % (SAMPLER_BATCH, card, {k: round(v, 4) for k, v in ms.items()},
           FANOUT[0], FANOUT[1], SAMPLER_FULL_CAP, rounds, int(hit.sum()),
           SAMPLER_SUBGRAPH_CAP, kept, cut, length, p, qq, steps, stuck,
           launches))
    return {"gather_rows": {"sampler_api_launches": launches,
                            "sampler_api_ms": ms}}


def knn_peak_bytes(torch, fn):
    """(``fn()``, the peak device bytes allocated while it ran:
    ``torch.cuda.max_memory_allocated`` after a reset); fails above
    ``KNN_PEAK_BYTES``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(peak < KNN_PEAK_BYTES, "k-NN: a search peaked at %.3f GB of "
          "device memory, over %.1f GB" % (peak / 1e9, KNN_PEAK_BYTES / 1e9))
    return out, peak


def knn_unchunked(torch, index, queries, kk):
    """(scores [m, kk], rows) of one unchunked computation of ``index``'s
    search for ``queries``: every data row scored at once, the IVF
    probes by torch.topk, then torch.topk of the row."""
    from graph_learn_tpu_torch.ops import knn
    q = torch.as_tensor(queries, device="cuda")
    m = q.shape[0]
    if isinstance(index, knn.FlatIndex):
        s = knn._scores(q, index._data, index.metric, index._norms)
    else:
        coarse = index.coarse if isinstance(index, knn.IVFPQIndex) else index
        metric = 0 if isinstance(index, knn.IVFPQIndex) else index.metric
        probe = torch.topk(knn._scores(q, coarse.centroids, metric),
                           coarse.nprobe, dim=1).indices
        slot = torch.full((m, coarse.nlist), -1, dtype=torch.long,
                          device="cuda")
        slot.scatter_(1, probe, torch.arange(
            coarse.nprobe, device="cuda").expand(m, -1).contiguous())
        at = slot[:, index._cell]
        if isinstance(index, knn.IVFPQIndex):
            lut = index._lut(q, probe).reshape(
                m, coarse.nprobe, index.m, index.ksub)
            rows = torch.arange(m, device="cuda")[:, None]
            pos = torch.clamp(at, min=0)
            s = sum(lut[rows, pos, j, index.codes[:, j][None, :]]
                    for j in range(index.m))
        else:
            s = knn._scores(q, index._data, index.metric, index._norms)
        s = torch.where(at >= 0, s, float("-inf"))
    vals, rows = torch.topk(s, kk, dim=1)
    return vals, rows


def knn_agree(torch, index, ids, dist, queries, metric, what):
    """The chunked search's answer for the first KNN_CHECK_QUERIES queries
    against ``knn_unchunked``: the same id sets where the k-th and (k+1)-th
    scores are more than KNN_GAP apart, distances within KNN_DIST_RTOL of
    the row's largest.  Returns the rows held to their ids."""
    k = ids.shape[1]
    vals, rows = knn_unchunked(torch, index, queries, k + 1)
    vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
    ref_ids = np.where(np.isfinite(vals[:, :k]),
                       index._ids.cpu().numpy()[rows[:, :k]], -1)
    ref_dist = -vals[:, :k] if metric == 0 else vals[:, :k]
    with np.errstate(invalid="ignore"):
        clear = (vals[:, k - 1] - vals[:, k]) > KNN_GAP
    for i in np.flatnonzero(clear):
        check(np.array_equal(np.sort(ids[i]), np.sort(ref_ids[i])),
              "k-NN %s: query %d's ids differ from the unchunked search"
              % (what, i))
    fin = np.isfinite(ref_dist)
    scale = np.max(np.where(fin, np.abs(ref_dist), 0), axis=1,
                   keepdims=True)
    err = np.where(fin, np.abs(dist - ref_dist), 0)
    check(bool((np.isfinite(dist) == fin).all()
               and (err <= KNN_DIST_RTOL * scale).all()),
          "k-NN %s: distances differ from the unchunked search by %g of "
          "the row's largest" % (what, float((err / scale).max())))
    check(clear.sum() * 2 >= clear.size, "k-NN %s: only %d of %d rows have "
          "a gap above %g at k" % (what, clear.sum(), clear.size, KNN_GAP))
    return int(clear.sum())


def recall_at(got, truth, r):
    """Mean share of each row's first ``r`` true ids among its first
    ``r`` found ones."""
    a, b = np.sort(got[:, :r], axis=1), np.sort(truth[:, :r], axis=1)
    hits = [np.isin(x, y, assume_unique=False).sum() for x, y in zip(a, b)]
    return float(np.sum(hits)) / (r * got.shape[0])


def knn_path(torch, card):
    """20c: Graph.search at SIFT1M's counts and widths (drawn vectors):
    flat (L2 and inner product), ivfflat and ivfpq (nlist 4 096, nprobe
    16) with k 100 over 1 000 000 x 128 f32 for 10 000 queries: Flat L2
    self-recall, the chunked search against an unchunked one, peak device
    memory, train / add / search times, queries/s, device busy and the IVF
    indexes' recall against Flat."""
    import graph_learn_tpu_torch as gl
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(KNN_SEED)
    centres = KNN_SPREAD * torch.randn((KNN_CENTRES, KNN_DIM), generator=gen,
                                       device="cuda")
    base = centres[torch.randint(0, KNN_CENTRES, (KNN_BASE,), generator=gen,
                                 device="cuda")]
    base += torch.randn(base.shape, generator=gen, device="cuda")
    picks = torch.randperm(KNN_BASE, generator=gen, device="cuda")[
        :KNN_QUERIES]
    queries = base[picks] + KNN_NOISE * torch.randn(
        (KNN_QUERIES, KNN_DIM), generator=gen, device="cuda")
    data, q, picks = base.cpu().numpy(), queries.cpu().numpy(), \
        picks.cpu().numpy()
    del centres, base, queries
    table = gl.NodeTable("item", gl.Decoder(attr_types=["float"] * KNN_DIM),
                         np.arange(KNN_BASE), float_attrs=data)
    draw_s = time.perf_counter() - t0
    answers, out = {}, {}
    for kind, metric in KNN_CONFIGS:
        what = "%s/%s" % (kind, "L2" if metric == 0 else "ip")
        g = gl.Graph(device="cuda").add_node_table(table)
        opt = gl.KnnOption(k=KNN_K, index_type=kind, nlist=KNN_NLIST,
                           nprobe=KNN_NPROBE, metric=metric)
        t0 = time.perf_counter()
        g.search("item", q[:1], opt)  # builds the index
        build_s = time.perf_counter() - t0
        index = next(iter(g._knn_indexes.values()))
        (ids, dist), peak = knn_peak_bytes(
            torch, lambda: g.search("item", q, opt))
        t0 = time.perf_counter()
        g.search("item", q, opt)
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g.search("item", q, opt)
            prof_wall = time.perf_counter() - t0
        busy = sum(device_ms_by_kernel(prof).values())
        clear = knn_agree(torch, index, ids[:KNN_CHECK_QUERIES],
                          dist[:KNN_CHECK_QUERIES], q[:KNN_CHECK_QUERIES],
                          0 if kind == "ivfpq" else metric, what)
        answers[what] = ids
        out[what] = dict(train_s=index.train_s, add_s=index.add_s,
                         search_ms=wall * 1e3, qps=KNN_QUERIES / wall,
                         peak_gb=peak / 1e9,
                         busy_share=busy / (prof_wall * 1e3))
        line = ("k-NN %s (%d x %d f32, %d queries, k %d%s): train %.3f s, "
                "add %.3f s (first search with the build %.3f s); search "
                "%.3f ms per %d queries, %.1f queries/s on the host clock; "
                "device busy %.1f%% of a search under the profiler (%.3f "
                "ms); peak %.3f GB; %d of %d checked rows' ids and every "
                "distance equal to the unchunked search"
                % (what, KNN_BASE, KNN_DIM, KNN_QUERIES, KNN_K,
                   "" if kind == "flat" else ", nlist %d, nprobe %d"
                   % (KNN_NLIST, KNN_NPROBE), index.train_s, index.add_s,
                   build_s, wall * 1e3, KNN_QUERIES, KNN_QUERIES / wall,
                   100 * out[what]["busy_share"], prof_wall * 1e3,
                   peak / 1e9, clear, KNN_CHECK_QUERIES))
        if what == "flat/L2":
            self_share = float(np.mean(ids[:, 0] == picks))
            check(self_share >= KNN_SELF_RECALL, "k-NN flat/L2: %.4f of the "
                  "queries find their own base vector first, under %g"
                  % (self_share, KNN_SELF_RECALL))
            line += "; %.4f of the queries find their own vector first" % (
                self_share)
        elif kind != "flat":
            truth = answers["flat/L2"]
            out[what]["recall_at_10"] = recall_at(ids, truth, 10)
            out[what]["recall_at_100"] = recall_at(ids, truth, KNN_K)
            line += "; recall@10 %.4f, recall@100 %.4f against flat/L2" % (
                out[what]["recall_at_10"], out[what]["recall_at_100"])
        log(line + "; card: %s" % card)
        del g, index
        gc.collect()
        torch.cuda.empty_cache()
    log("k-NN data: %d base vectors about %d centres, drawn in %.3f s (they "
        "hold SIFT1M's counts and widths, not its distribution)"
        % (KNN_BASE, KNN_CENTRES, draw_s))
    return out


# ---------------------------------------------------------------------------
# Phase 21: snapshots, the host tier, the BFS reorder, the TSV examples,
# checkpoints and the torch bridge
# ---------------------------------------------------------------------------

HOST_TIER_STEPS = 20
HOST_TIER_PROFILED = 5
HOST_STAGE_STEPS = 10
H2D_COPIES = 5
CKPT_STEPS = 5
LOADER_BATCHES = 20
TSV_TGAT_STEPS = 5
# launches of Kernels 1-3 a train step and an evaluated batch of the TSV
# examples at their defaults: src and hop 1 gathered, the deepest hop
# reduced by Kernel 2 (EgoGraphSAGE); every hop gathered and three
# neighbour blocks (EgoGAT); seven hops gathered (EgoRGCN)
TSV_PER_STEP = {
    "ego_sage_supervised": {"gather_rows": 2, "segment_spmm": 1},
    "ego_gat_supervised": {"gather_rows": 3, "gat_block": 3,
                           "gat_block_bwd": 3},
    "ego_rgcn_supervised": {"gather_rows": 7}}


def tree_tensors(x):
    """Every tensor of a (nested) dict, list or dataclass."""
    import dataclasses

    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tree_tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tree_tensors(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in tree_tensors(getattr(x, f.name))]
    return []


def same_store(torch, a, b, where, device="cuda"):
    """Two port stores bit for bit: every host array, the node sets, and
    the CSR and payload views on ``device``."""
    sa, sb = a.store, b.store
    check(set(sa.nodes) == set(sb.nodes) and set(sa.edges) == set(sb.edges)
          and set(sa.node_sets) == set(sb.node_sets),
          "%s: the stores hold other types" % where)

    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        if isinstance(x, torch.Tensor):
            return x.dtype == y.dtype and torch.equal(x, y)
        return x.dtype == y.dtype and np.array_equal(x, y)
    for t in sa.nodes:
        x, y = sa.nodes[t], sb.nodes[t]
        for f in ("raw_ids", "float_attrs", "labels", "weights"):
            check(same(getattr(x, f), getattr(y, f)),
                  "%s: node table %s.%s differs" % (where, t, f))
    for t in sa.node_sets:
        x, y = sa.node_sets[t], sb.node_sets[t]
        check(same(x.indices, y.indices) and same(x.weights, y.weights),
              "%s: node set %s differs" % (where, t))
    for t in sa.edges:
        x, y = sa.edges[t], sb.edges[t]
        check((x.ts_base, x.ts_scale) == (y.ts_base, y.ts_scale)
              and all(same(getattr(x, f), getattr(y, f)) for f in
                      ("src", "dst", "weights", "timestamps", "float_attrs")),
              "%s: edge table %s differs" % (where, t))
        dx, dy = x.device(device), y.device(device)
        for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "cum_weights",
                  "nbr_ts"):
            check(same(getattr(dx.out, f), getattr(dy.out, f)),
                  "%s: CSR %s.%s differs" % (where, t, f))


def snapshot_path(torch, card, graph, build_s):
    """21a: the weighted 61.25M-edge "minimal" store of the bench phase
    saved (Graph.save) and restored memory-mapped (Graph.load): raw ids,
    labels, f32 host features, edge src / dst / weights bit for bit; the
    restored store's CPU views (its host CSR, built once, and its bf16
    table) equal to the original's card views; bytes, save, load and CSR
    seconds beside the bench's build.  Returns (the restored graph, the
    snapshot directory, the kernels line's fields)."""
    import tempfile

    import graph_learn_tpu_torch as gl

    g, _ = graph
    where = tempfile.mkdtemp(prefix="glt_snapshot_")
    t0 = time.perf_counter()
    g.save(where)
    save_s = time.perf_counter() - t0
    nb = sum(os.path.getsize(os.path.join(where, f))
             for f in os.listdir(where))
    t0 = time.perf_counter()
    g2 = gl.Graph.load(where, device="cuda")
    load_s = time.perf_counter() - t0
    nt, nt2 = g.store.node_table("item"), g2.store.node_table("item")
    et, et2 = g.store.edge_table("rel"), g2.store.edge_table("rel")
    for name, x, y in (("raw ids", nt.raw_ids, nt2.raw_ids),
                       ("labels", nt.labels, nt2.labels),
                       ("features", nt.float_attrs, nt2.float_attrs),
                       ("edge src", et.src, et2.src),
                       ("edge dst", et.dst, et2.dst),
                       ("weights", et.weights, et2.weights)):
        check(x.dtype == y.dtype and np.array_equal(x, y),
              "snapshot: the restored %s differ" % name)
    t0 = time.perf_counter()
    cpu = et2.device("cpu")
    csr_s = time.perf_counter() - t0
    ref = et.device("cuda")
    for f in ("row_offsets", "nbr_ids", "nbr_edge_ids"):
        check(torch.equal(getattr(cpu.out, f), getattr(ref.out, f).cpu()),
              "snapshot: the restored CPU CSR's %s differs from the "
              "original's card view" % f)
    t0 = time.perf_counter()
    table = nt2.device("cpu").float_attrs
    table_s = time.perf_counter() - t0
    check(torch.equal(table, nt.device("cuda").float_attrs.cpu()),
          "snapshot: the restored %s table differs from the card's"
          % table.dtype)
    log("snapshot (the weighted 61.25M-edge store, %d nodes, [%d, %d] f32 "
        "host features): %d bytes in %d files, saved in %.2f s, loaded "
        "memory-mapped in %.2f s; raw ids, labels, features, edges and "
        "weights bit-equal; the restored store's CPU CSR built in %.2f s "
        "(%.2f s of host CSR) and its %s table in %.2f s, both bit-equal "
        "to the original's card views; the bench's draw, CSR build and "
        "upload took %.1f s; card: %s"
        % (nt.num_nodes, *nt.float_attrs.shape, nb, len(os.listdir(where)),
           save_s, load_s, csr_s, et2.host_build_s, table.dtype, table_s,
           build_s, card))
    return g2, where, {"snapshot_bytes": nb, "snapshot_save_s": save_s,
                       "snapshot_load_s": load_s, "snapshot_csr_s": csr_s}


def host_steps(torch, q, model, transform, steps, warm=3):
    """``steps`` host-tier training steps (the trainer's step: loss,
    backward, Adam) from one Dataset after ``warm``; returns (seconds,
    bytes of each batch shipped, the dataset)."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import host_tier_bench as htb
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.gsl.dataset import Dataset

    ds = Dataset(q, tier="host", device="cuda", seed=2, transform=transform)
    opt = torch.optim.Adam(model.parameters(), lr=bench.LEARNING_RATE)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sizes = []

    def step():
        batch = ds.next()
        sizes.append(nbytes(batch))
        loss = htb.sage_loss(model, batch, gen, True)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    try:
        for _ in range(warm):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sizes[-1]
    finally:
        ds.close()


def host_stages(torch, g, cfg, dec, transform):
    """Medians over ``HOST_STAGE_STEPS`` host-tier steps on the caller's
    thread (after 3), each stage ended by what it needs: the plan on the
    CPU, the transform, the rows gathered into pinned memory and the rest
    pinned (``host_batch``), the copy (synchronised) and the training step
    on the card (synchronised); ms."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.core.values import map_result
    from graph_learn_tpu_torch.examples import host_tier_bench as htb
    from graph_learn_tpu_torch.gsl.compile import _execute
    from graph_learn_tpu_torch.gsl.dataset import host_batch

    q = htb.sage_query(g, cfg)
    tables = q.device_tables("cpu")
    gen = torch.Generator().manual_seed(0)
    model = htb.make_model(cfg, dec, "cuda")
    opt = torch.optim.Adam(model.parameters(), lr=bench.LEARNING_RATE)
    names = ("plan", "transform", "gather and pin", "copy", "step")
    times = {k: [] for k in names}
    for i in range(HOST_STAGE_STEPS + 3):
        seeds = torch.randint(0, cfg["n_nodes"], (cfg["batch"],),
                              dtype=torch.int32, generator=gen)
        t = [time.perf_counter()]
        with torch.no_grad():
            out = _execute(q, tables, seeds, gen)
            t.append(time.perf_counter())
            if transform is not None:
                out = transform(out, tables)
        t.append(time.perf_counter())
        pinned = host_batch(out)
        t.append(time.perf_counter())
        moved = map_result(lambda x: x.to("cuda", non_blocking=True), pinned)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss = htb.sage_loss(model, moved, None, True)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if i >= 3:
            for k, a, b in zip(names, t, t[1:]):
                times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def host_produce_ms(torch, q, window, n=30):
    """ms a host-tier batch reaches the card with no training beside it."""
    from graph_learn_tpu_torch.gsl.dataset import Dataset

    ds = Dataset(q, tier="host", device="cuda", seed=1, window=window)
    try:
        ds.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ds.next()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3
    finally:
        ds.close()


def host_tier_path(torch, card, gather, spmm, graph, restored, cfg):
    """21b: examples/host_tier_bench.py's shapes on the restored store,
    through LocalTrainer(device="cuda").train(..., tier="host"):
    EgoGraphSAGE [100, 256, 47] "gcn", batch 1 024, fanout [15, 10], Adam
    1e-3, 20 steps, ``host`` with a window of 1 and the default window,
    and ``host+agg``: every loss finite, the parameters moved, and
    Kernels 1 and 2 never launched; a topk batch of the host tier
    bit-equal to the device tier's on the original store; a random one's
    hops true neighbours of the edge arrays, its rows the table's; ms a
    step, edges/s, device busy, bytes shipped a batch, H2D GB/s and the
    share of the step the producer thread hides.  Returns the kernels
    line's fields."""
    from torch.profiler import ProfilerActivity, profile

    from graph_learn_tpu_torch.config import conf
    from graph_learn_tpu_torch.core.values import map_result
    from graph_learn_tpu_torch.examples import host_tier_bench as htb
    from graph_learn_tpu_torch.gsl.dataset import Dataset, host_batch
    from graph_learn_tpu_torch.nn import data as gdata

    g, dec = graph
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES}
    k1, k2 = cfg["fanout"]
    edges = cfg["batch"] * (k1 + k1 * k2)
    runs = {}
    for label, shape, window in (("host, window 1", "host", 1),
                                 ("host", "host", None),
                                 ("host+agg", "host+agg", None)):
        model = htb.make_model(cfg, dec, "cuda")
        before = [p.detach().clone() for p in model.parameters()]
        for c in counters.values():
            c.reset()
        r = htb.run_shape(restored, dec, cfg, shape, HOST_TIER_STEPS, "cuda",
                          window, model)
        launches = {k: c.count for k, c in counters.items()}
        check(launches == {"gather_rows": 0, "segment_spmm": 0},
              "host tier %s: the card's kernels launched %s; the tables "
              "are in host RAM" % (label, launches))
        check(r["losses"].numel() == HOST_TIER_STEPS
              and bool(torch.isfinite(r["losses"]).all())
              and any(not torch.equal(a, b)
                      for a, b in zip(before, model.parameters())),
              "host tier %s: %d losses, finite %s, or no parameter moved"
              % (label, r["losses"].numel(),
                 bool(torch.isfinite(r["losses"]).all())))
        runs[label] = r
    hidden = 1.0 - runs["host"]["ms_step"] / runs["host, window 1"]["ms_step"]

    # device busy, bytes a batch: the same steps under the profiler
    busy, shipped = {}, {}
    for label, transform in (("host", None), ("host+agg", htb.agg_transform)):
        q = htb.sage_query(restored, cfg)
        model = htb.make_model(cfg, dec, "cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, shipped[label] = host_steps(torch, q, model, transform,
                                              HOST_TIER_PROFILED)
        busy[label] = (sum(device_ms_by_kernel(prof).values())
                       / (wall * 1e3))

    stages = {label: host_stages(torch, restored, cfg, dec, transform)
              for label, transform in (("host", None),
                                       ("host+agg", htb.agg_transform))}
    produce = {w: host_produce_ms(torch, htb.sage_query(restored, cfg), w)
               for w in (1, conf.dataset_capacity)}

    # H2D: one host batch as the tier ships it, then copied
    q = htb.sage_query(restored, cfg)
    ds = Dataset(q, tier="host", device="cpu", seed=3, window=1)
    pinned = host_batch(ds.next())
    n_bytes = sum(t.numel() * t.element_size() for t in tree_tensors(pinned))
    copy_ms = []
    for _ in range(H2D_COPIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        moved = map_result(lambda x: x.to("cuda", non_blocking=True), pinned)
        end.record()
        end.synchronize()
        copy_ms.append(start.elapsed_time(end))
        del moved
    h2d_ms = float(np.median(copy_ms))

    # a topk batch: the host tier's on the restored store, the device
    # tier's on the original, bit for bit
    def topk_query(gg):
        return (gg.V("item").batch(cfg["batch"]).alias("src")
                .outV("rel").sample(k1).by("topk").alias("hop1")
                .outV("rel").sample(k2).by("topk").alias("hop2").values())
    hds = Dataset(topk_query(restored), tier="host", device="cuda", seed=5,
                  window=2)
    hb = hds.next()
    hds.close()
    db = Dataset(topk_query(g), device="cuda", seed=5, window=1).next()
    for a in ("src", "hop1", "hop2"):
        check(hb[a].ids.device.type == "cuda"
              and torch.equal(hb[a].ids, db[a].ids)
              and torch.equal(gdata.materialized(hb[a]).float_attrs,
                              gdata.materialized(db[a]).float_attrs),
              "host tier: the topk batch's %s differs from the device "
              "tier's" % a)
    # a random batch: true neighbours of the edge arrays, the table's rows
    rds = Dataset(htb.sage_query(restored, cfg), tier="host", device="cuda",
                  seed=7, window=1)
    rb = rds.next()
    et, n = g.store.edge_table("rel"), cfg["n_nodes"]
    seeds = rb["src"].ids.cpu().numpy()
    h1 = rb["hop1"].ids.cpu().numpy()
    h2 = rb["hop2"].ids.cpu().numpy()
    rows = np.unique(np.concatenate([seeds, h1.reshape(-1)]))
    m = np.isin(et.src, rows)
    keys = np.sort(et.src[m] * n + et.dst[m])
    true_edges(keys, n, seeds, h1, conf.default_neighbor_id)
    true_edges(keys, n, h1.reshape(-1), h2.reshape(-1, k2),
               conf.default_neighbor_id)
    table = g.store.node_table("item").device("cuda").float_attrs
    for a in ("src", "hop1", "hop2"):
        check(torch.equal(gdata.materialized(rb[a]).float_attrs,
                          table[rb[a].ids.long()]),
              "host tier: the %s rows shipped are not the table's" % a)

    for label, r in runs.items():
        log("host tier %s (the restored store's CPU views, %s, batch %d, "
            "fanout [%d, %d], EgoGraphSAGE [%d, %d, %d] gcn, Adam 1e-3, "
            "LocalTrainer.train): %d steps in %.3f s, %.3f ms a step, %.4g "
            "edges/s, loss %.4f -> %.4f; gather_rows and segment_spmm "
            "launched 0 times; card: %s"
            % (label, "the deepest hop reduced on the CPU" if "agg" in label
               else "every row gathered on the CPU", cfg["batch"], k1, k2,
               cfg["feat_dim"], cfg["hidden"], cfg["classes"],
               HOST_TIER_STEPS, r["seconds"], r["ms_step"], r["edges_per_s"],
               r["losses"][0].item(), r["losses"][-1].item(), card))
    for label, st in stages.items():
        log("host tier %s, where a step goes (medians of %d steps on the "
            "caller's thread, ms): %s; card: %s"
            % (label, HOST_STAGE_STEPS,
               ", ".join("%s %.3f" % kv for kv in st.items()), card))
    log("host tier: batches alone (no training) %.3f ms each with a window "
        "of 1, %.3f with the producer thread (window %d); card: %s"
        % (produce[1], produce[conf.dataset_capacity],
           conf.dataset_capacity, card))
    log("host tier: the producer thread hides %.1f%% of a step (%.3f ms a "
        "step with a window of 1, %.3f with the default %d); device busy "
        "%.1f%% of a step (host), %.1f%% (host+agg); %d bytes shipped a "
        "batch (host), %d (host+agg); one host batch's %d bytes copied in "
        "%.3f ms (median of %d), %.2f GB/s host to device; the topk batch "
        "bit-equal to the device tier's on the original store; a random "
        "batch's hops true neighbours and its rows the table's; card: %s"
        % (100 * hidden, runs["host, window 1"]["ms_step"],
           runs["host"]["ms_step"], conf.dataset_capacity,
           100 * busy["host"], 100 * busy["host+agg"], shipped["host"],
           shipped["host+agg"], n_bytes, h2d_ms, H2D_COPIES,
           n_bytes / h2d_ms / 1e6, card))
    return {"gather_rows": {
        "host_tier_launches": 0, "host_tier_ms_step": runs["host"]["ms_step"],
        "host_agg_tier_ms_step": runs["host+agg"]["ms_step"],
        "host_tier_hidden_share": hidden,
        "host_tier_h2d_gb_per_s": n_bytes / h2d_ms / 1e6,
        "host_tier_stage_ms": stages["host"],
        "host_agg_tier_stage_ms": stages["host+agg"]},
        "segment_spmm": {"host_tier_launches": 0}}


def reorder_path(torch, card, gather):
    """21c: core/reorder.py on phase 19's planted-community store
    (ogbl-collab's 235 868 nodes and 1 179 052 undirected train pairs,
    128 f32 features): reorder_store with the raw-id adjacency, the
    payloads and a masked set unchanged; the mean neighbour index distance
    before and after; Kernel 1 cold over one 2-hop batch's rows (1 024
    seeds, [15, 10]) on each store, against its bound, plain version and
    index_select.  A measurement, not a claim.  Returns the kernels line's
    fields."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.core.reorder import reorder_store
    from graph_learn_tpu_torch.core.schema import mask_type
    from graph_learn_tpu_torch.examples import seal
    from graph_learn_tpu_torch.gsl.dataset import Dataset

    a = seal.planted_collab(seal.COLLAB_NODES, seal.COLLAB_TRAIN_PAIRS, 0, 0,
                            0, feat_dim=seal.COLLAB_FEAT)
    src, dst = a["train"][:, 0], a["train"][:, 1]
    n = seal.COLLAB_NODES
    test_raw = np.arange(0, n, 97)
    graphs = []
    for _ in range(2):
        g = seal.build_graph(a["feats"], src, dst, "cuda")
        g.add_node_set("item", test_raw, gl.Mask.TEST)
        graphs.append(g)
    g0, g1 = graphs
    t0 = time.perf_counter()
    reorder_store(g1.store)
    reorder_s = time.perf_counter() - t0
    nt0, nt1 = g0.store.node_table("item"), g1.store.node_table("item")
    et0, et1 = g0.store.edge_table("relation"), g1.store.edge_table(
        "relation")

    def raw_edges(nt, et):
        key = nt.raw_ids[et.src] * n + nt.raw_ids[et.dst]
        order = np.lexsort((et.weights, key))
        return key[order], et.weights[order]
    k0, w0 = raw_edges(nt0, et0)
    k1_, w1 = raw_edges(nt1, et1)
    check(np.array_equal(k0, k1_) and np.array_equal(w0, w1),
          "reorder: the raw-id adjacency changed")
    check(np.array_equal(nt1.float_attrs, nt0.float_attrs[nt1.raw_ids])
          and not np.array_equal(nt1.raw_ids, nt0.raw_ids),
          "reorder: a node's features did not follow it, or nothing moved")
    check(np.array_equal(
        np.sort(nt1.raw_ids[g1.store.node_set(
            mask_type("item", gl.Mask.TEST)).indices]),
        test_raw), "reorder: the masked set covers other raw ids")
    dist = [float(np.abs(et.src - et.dst).mean()) for et in (et0, et1)]
    kf1, kf2 = FANOUT
    fields, rows = {}, MICRO_BATCH * (1 + kf1 + kf1 * kf2)
    for label, g in (("before", g0), ("after", g1)):
        q = (g.V("item").batch(MICRO_BATCH).alias("src")
             .outV("relation").sample(kf1).by("random").alias("hop1")
             .outV("relation").sample(kf2).by("random").alias("hop2")
             .values())
        b = Dataset(q, device="cuda", seed=3, window=1).next()
        ids = torch.cat([b[h].ids.reshape(-1) for h in ("src", "hop1",
                                                         "hop2")]).to(
                                                             torch.int32)
        table = g.store.node_table("item").device("cuda").float_attrs
        check(ids.numel() == rows and torch.equal(
            gather.gather_rows(table, ids),
            gather.gather_rows_plain(table, ids)),
            "reorder: gather_rows over the batch's rows differs from "
            "table[idx]")
        name = gather_kernels(torch, [lambda: gather.gather_rows(table, ids)],
                              "the reordered store")[0]
        # the rows repeat within a batch: each distinct row is read once,
        # every row written once
        distinct = int(torch.unique(ids).numel())
        row_bytes = table.shape[1] * table.element_size()
        f = {"cold_ms": time_cold_ms(lambda: gather.gather_rows(table, ids)),
             "bound_ms": bound((distinct + rows) * row_bytes + 4 * rows,
                               0)[0],
             "plain_ms": time_cold_ms(
                 lambda: gather.gather_rows_plain(table, ids)),
             "library_ms": time_cold_ms(
                 lambda: torch.index_select(table, 0, ids))}
        log("gather_rows on the ogbl-collab store %s the reorder, one 2-hop "
            "batch's %d rows (%d distinct): %.4f ms cold, bound %.4f "
            "(%.1f%%), one kernel a call (%s); plain %.4f, index_select "
            "%.4f, both cold"
            % (label, rows, distinct, f["cold_ms"], f["bound_ms"],
               100 * f["bound_ms"] / f["cold_ms"], kernel_label(name),
               f["plain_ms"], f["library_ms"]))
        for k, v in f.items():
            fields["reorder_%s_%s" % (k, label)] = v
        fields["reorder_distinct_rows_%s" % label] = distinct
    log("reorder (bfs on the ogbl-collab-sized store: %d nodes, %d edges) "
        "in %.2f s: raw-id adjacency, features and the masked set "
        "unchanged; mean neighbour index distance %.1f before, %.1f after; "
        "Kernel 1 over one 2-hop batch's %d rows cold %.4f ms before, %.4f "
        "after (bound %.4f); card: %s"
        % (n, et1.num_edges, reorder_s, dist[0], dist[1], rows,
           fields["reorder_cold_ms_before"], fields["reorder_cold_ms_after"],
           fields["reorder_bound_ms_before"], card))
    fields.update(reorder_mean_nbr_distance_before=dist[0],
                  reorder_mean_nbr_distance_after=dist[1])
    return {"gather_rows": fields}


def tsv_examples_path(torch, card, gather, spmm, gat):
    """21d: the TSV examples at their defaults on the card, each loading
    its files through Graph.node/edge/init: ego_sage_supervised (2
    gather_rows + 1 segment_spmm a step), ego_gat_supervised (3
    gather_rows and 3 gat_block forwards and backwards a step),
    ego_rgcn_supervised (7 gather_rows a step; its store bit-equal to the
    in-memory twin of the same draws), each a test accuracy; and ego_tgat's
    store from its files bit-equal to the in-memory one, a few steps (15
    gather_rows, 9 gat_block each way) and the test accuracy.  Returns the
    kernels line's fields."""
    import tempfile

    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.core.schema import mask_type
    from graph_learn_tpu_torch.examples import (common, ego_gat_supervised,
                                                ego_rgcn_supervised,
                                                ego_sage_supervised, ego_tgat)
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer

    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES,
                "gat_block": gat.LAUNCHES_FWD,
                "gat_block_bwd": gat.LAUNCHES_BWD}
    where = tempfile.mkdtemp(prefix="glt_tsv_examples_")
    fields = {"gather_rows": {}, "segment_spmm": {}, "gat_block": {}}
    try:
        for mod in (ego_sage_supervised, ego_gat_supervised,
                    ego_rgcn_supervised):
            name = mod.__name__.rsplit(".", 1)[1]
            args = mod.build_parser().parse_args(
                ["--data_dir", os.path.join(where, "cora")])
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            out = mod.run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: c.count for k, c in counters.items()}
            store = out["graph"].store
            b = args.batch_size
            steps = args.epochs * -(-store.node_set(mask_type(
                "item", gl.Mask.TRAIN)).size // b)
            evals = -(-store.node_set(mask_type("item", gl.Mask.TEST)).size
                      // b)
            per = TSV_PER_STEP[name]
            want = expected_launches(per, counters, steps, evals)
            check(got == want and np.isfinite(out["history"]).all()
                  and 0.0 <= out["acc"] <= 1.0,
                  "%s: launches %s, want %s (%d steps, %d evaluated "
                  "batches); history %s, accuracy %s"
                  % (name, got, want, steps, evals, out["history"],
                     out["acc"]))
            if name == "ego_rgcn_supervised":
                twin, _ = common.cora_like_twin(two_relations=True,
                                                device="cuda")
                same_store(torch, out["graph"], twin, name)
            log("%s (cora_like TSV files through Graph.node/edge/init, its "
                "defaults: %d epochs, batch %d, %d steps): %.2f s, loss "
                "%.4f -> %.4f, test accuracy %.4f; launches a step %s "
                "(counters over the steps and %d evaluated batches)%s; "
                "card: %s"
                % (name, args.epochs, b, steps, wall, out["history"][0],
                   out["history"][-1], out["acc"], per, evals,
                   "; the store bit-equal to its in-memory twin"
                   if name == "ego_rgcn_supervised" else "", card))
            key = name.replace("_supervised", "").replace("ego_", "tsv_")
            fields["gather_rows"][key + "_launches_per_step"] = per[
                "gather_rows"]
            fields["gather_rows"][key + "_test_accuracy"] = out["acc"]
            if "segment_spmm" in per:
                fields["segment_spmm"][key + "_launches_per_step"] = per[
                    "segment_spmm"]
            if "gat_block" in per:
                fields["gat_block"][key + "_launches_per_step"] = per[
                    "gat_block"]
                fields["gat_block"][key + "_bwd_launches_per_step"] = per[
                    "gat_block_bwd"]
            del out
        # ego_tgat from its files
        d = os.path.join(where, "tgat")
        t0 = time.perf_counter()
        g, udec, idec, edec = ego_tgat.load(d, device="cuda")
        load_s = time.perf_counter() - t0
        twin = ego_tgat.build_graph(ego_tgat.temporal_u2i(text=True),
                                    "cuda")[0]
        same_store(torch, g, twin, "ego_tgat")
        nhops = len(TGAT_NBRS)
        q = ego_tgat.build_query(g, TGAT_BATCH, TGAT_NBRS, "train")
        model = ego_tgat.TGATLink(udec, idec, 32, 16, 8, nhops,
                                  edec.float_attr_num, device="cuda")
        tr = LocalTrainer(device="cuda")
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def loss_fn(m, batch, generator, training):
            return ego_tgat.tgat_loss(m, batch, nhops, training, generator)
        tr.train(q, model, loss_fn, opt, steps_per_epoch=2, verbose=False)
        for c in counters.values():
            c.reset()
        _, hist = tr.train(q, model, loss_fn, opt,
                           steps_per_epoch=TSV_TGAT_STEPS, verbose=False)
        per = {k: c.count / TSV_TGAT_STEPS for k, c in counters.items()}
        want = {k: float(v) for k, v in TGAT_PER_STEP.items()}
        check({k: per[k] for k in want} == want and per["segment_spmm"] == 0
              and np.isfinite(hist).all(),
              "ego_tgat from its files: launches a step %s, want %s; "
              "losses %s" % (per, want, hist))
        acc = tr.evaluate(ego_tgat.build_query(g, TGAT_BATCH, TGAT_NBRS,
                                               "test"), model,
                          lambda m, b: ego_tgat.link_accuracy(m, b, nhops))
        log("ego_tgat from its TSV files (Graph.node/edge/init in %.2f s, "
            "bit-equal to the in-memory store of the same draws read back "
            "from their text): %d steps, loss %.4f, launches a step %s, "
            "test link-pred accuracy %.4f after them; card: %s"
            % (load_s, TSV_TGAT_STEPS, hist[-1], want, acc, card))
        fields["gather_rows"]["tsv_tgat_launches_per_step"] = want[
            "gather_rows"]
        fields["gat_block"]["tsv_tgat_launches_per_step"] = want["gat_block"]
        fields["gat_block"]["tsv_tgat_bwd_launches_per_step"] = want[
            "gat_block_bwd"]
    finally:
        shutil.rmtree(where, ignore_errors=True)
    return fields


def checkpoint_bridge_path(torch, card, g, dec):
    """21e: EgoGraphSAGE [128, 256, 32] trained 5 steps on the card and
    saved (nn/checkpoint.py), restored into a fresh model and a fresh Adam
    on the card, one more step on the same batch from both: every
    parameter bit-equal; then torch_loader over the bench query for a
    whole epoch (the first 20 batches' tensors on the card, or on the CPU
    with tier="host", and the last batch cut to its true rows)."""
    import tempfile

    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.nn import data as gdata
    from graph_learn_tpu_torch.nn.checkpoint import Checkpointer
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
    from graph_learn_tpu_torch.nn.torch_bridge import torch_loader

    q = two_hop_query(g)
    ds = gl.Dataset(q, device="cuda", seed=4, window=2)
    batches = [ds.next() for _ in range(CKPT_STEPS + 1)]
    table = g.store.node_table("item").device("cuda").float_attrs

    def model_opt(seed):
        m = EgoGraphSAGE([FEAT_DIM, HIDDEN, CLASSES], dec, agg_type="gcn",
                         device="cuda",
                         generator=torch.Generator().manual_seed(seed))
        return m, torch.optim.Adam(m.parameters(), lr=LEARNING_RATE)

    def step(m, opt, batch):
        ego = gdata.EgoGraph.from_query_result(batch, "src", HOPS,
                                               defer_last_table=table)
        loss = supervised_softmax_loss(m(ego, training=True),
                                       batch["src"].labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    model, opt = model_opt(0)
    for b in batches[:CKPT_STEPS]:
        step(model, opt, b)
    where = tempfile.mkdtemp(prefix="glt_ckpt_")
    try:
        ck = Checkpointer(where, device="cuda")
        t0 = time.perf_counter()
        ck.save(CKPT_STEPS, {"model": model.state_dict(),
                             "optimizer": opt.state_dict(),
                             "step": CKPT_STEPS})
        save_s = time.perf_counter() - t0
        fresh, fresh_opt = model_opt(1)
        t0 = time.perf_counter()
        state = ck.restore()
        restore_s = time.perf_counter() - t0
        fresh.load_state_dict(state["model"])
        fresh_opt.load_state_dict(state["optimizer"])
    finally:
        shutil.rmtree(where, ignore_errors=True)
    la = step(model, opt, batches[CKPT_STEPS])
    lb = step(fresh, fresh_opt, batches[CKPT_STEPS])
    diff = max(float((p - r).detach().abs().max())
               for p, r in zip(model.parameters(), fresh.parameters()))
    check(state["step"] == CKPT_STEPS and torch.equal(la, lb)
          and all(torch.equal(p, r) for p, r in zip(model.parameters(),
                                                    fresh.parameters())),
          "checkpoint: the resumed step differs (loss %r vs %r, largest "
          "parameter difference %g)" % (la.item(), lb.item(), diff))
    log("checkpoint (EgoGraphSAGE [%d, %d, %d], Adam, %d steps on the card, "
        "saved in %.3f s, restored onto the card in %.3f s into a fresh "
        "model and Adam): one more step on the same batch from both, loss "
        "and every parameter bit-equal (largest difference %g); card: %s"
        % (FEAT_DIM, HIDDEN, CLASSES, CKPT_STEPS, save_s, restore_s, diff,
           card))
    n_batches = -(-g.store.node_set("item").size // MICRO_BATCH)
    last_rows = g.store.node_set("item").size - (n_batches - 1) * MICRO_BATCH
    for tier, dev_type in ((None, "cuda"), ("host", "cpu")):
        t0 = time.perf_counter()
        n, last = 0, None
        for b in torch_loader(q, window=4, tier=tier, device="cuda"):
            if n < LOADER_BATCHES:
                ts = tree_tensors(b)
                check(ts and all(t.device.type == dev_type for t in ts),
                      "torch_loader (tier %s): a tensor of batch %d is not "
                      "on the %s" % (tier, n, dev_type))
            n, last = n + 1, b
        wall = time.perf_counter() - t0
        check(n == n_batches and all(
            last[a]["ids"].shape[0] == last_rows for a in last)
              and last["hop2"]["float_attrs"].shape[:3] == (
                  last_rows, *FANOUT),
              "torch_loader (tier %s): %d batches, the last %s"
              % (tier, n, {a: tuple(v["ids"].shape) for a, v in
                           last.items()}))
        log("torch_loader over the bench query (tier %s): %d batches in "
            "%.2f s, the first %d with every tensor on the %s, the last cut "
            "to its %d true rows; card: %s"
            % (tier or "device", n, wall, LOADER_BATCHES, dev_type,
               last_rows, card))


# 8 requests a client and 2 edge batches: cut from 32 and 5 (then 16 and
# 3) to keep the whole smoke inside its time (each batch's host CSR
# rebuild is about 8 s)
ONLINE_CLIENTS, ONLINE_REQUESTS = 8, 8
# ids a served HTTP request carries: the JSON answer of one seed of the
# 2-hop [15, 10] query is 166 feature rows of 128 floats, about 0.25 MB of
# text whose encode and decode hold the interpreter lock for about 30 ms
ONLINE_MAX_IDS = 4
ONLINE_NEW_NODES = 1_000
ONLINE_EDGE_BATCHES, ONLINE_EDGE_BATCH = 2, 10_000
ONLINE_POLL_S = 0.2
ONLINE_THINK_S = 0.02  # a streaming-phase client's pause between requests
ONLINE_PROBE_WEIGHT = 10.0  # above every drawn weight (uniform in [0, 1))
ONLINE_PREDICT_CALLS = 20
ONLINE_PREDICT_SEED = 11
# the exported forward against the same forward run in the process: the
# same kernels on the same draws, so equal up to the f32 JSON round trip
# and, on the sorted route, the order of Kernel 4's adds (atomics)
ONLINE_PREDICT_TOL = 1e-5
ONLINE_STABLEHLO = os.path.join("tests", "fixtures", "jax_serving.stablehlo")


def load_gsl_client(root):
    """clients/py/gsl_client.py, imported by path as a user does."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gsl_client", os.path.join(root, "clients", "py", "gsl_client.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def replica_graph(gl, graph):
    """A second Graph over the same host tables (and their device views)
    as ``graph``: a worker of its own whose updates replace its own tables
    only (apply_updates never edits a table in place)."""
    g = gl.Graph(device=graph.device)
    for t in graph.store.nodes.values():
        g.store.add_node_table(t)
    for t in graph.store.edges.values():
        g.store.add_edge_table(t)
    g._initialized = True
    return g


def edge_key_sets(src, dst, n):
    """Sorted unique src * n + dst keys."""
    return np.unique(src.astype(np.int64) * n + dst.astype(np.int64))


def online_path(torch, card, gather, spmm, n_nodes=None, feat_dim=None,
                device="cuda", max_ids=ONLINE_MAX_IDS,
                edge_batch=ONLINE_EDGE_BATCH, new_nodes=ONLINE_NEW_NODES,
                files=None):
    """22: the online tier on one card at the bench store's width (module
    note, phase 22); the sizes and the device are arguments so that the
    phase can be rehearsed small on the CPU.  The TSV files are written
    into ``files`` and kept there (phase 25 serves from them), or into a
    temporary directory removed after.  Returns the launches of one
    /predict and the counts after the phase."""
    import base64
    import tempfile
    import urllib.error

    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.gsl.compile import _execute
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT, EgoGraphSAGE
    from graph_learn_tpu_torch.online import export, http, router, stream
    from graph_learn_tpu_torch.online.serve_main import serve
    from graph_learn_tpu_torch.ops.kernels import gat, sweep

    cfg = bench.CFG
    n = n_nodes or cfg["n_nodes"]
    d = feat_dim or cfg["feat_dim"]
    k1, k2 = FANOUT
    root = os.path.dirname(os.path.abspath(__file__))
    client_mod = load_gsl_client(root)
    t_phase = time.perf_counter()
    syn, _ = gl.synthetic_graph(n, cfg["avg_degree"], d, cfg["classes"],
                                seed=0, device=device)
    snt, set_ = syn.store.node_table("item"), syn.store.edge_table("rel")
    orig_src, orig_dst = set_.src.copy(), set_.dst.copy()
    orig_w = set_.weights.copy()
    where = files or tempfile.mkdtemp(prefix="glt_online_")
    servers, stops = [], []
    real_apply = stream.apply_updates
    try:
        paths, sizes, write_s = write_store_tsv(where, snt, set_,
                                                snt.raw_ids[:1])
        del syn, snt, set_
        topic_root = os.path.join(where, "topic")
        stream.FileTopic(topic_root, num_partitions=2)
        node_dec = {"labeled": True, "attr_types": ["float"] * d}
        conf = {"host": "127.0.0.1", "port": 0, "device": device,
                "nodes": [{"source": paths["nodes"], "type": "item",
                           "decoder": node_dec}],
                "edges": [{"source": paths["edges"],
                           "type": ["item", "item", "rel"],
                           "decoder": {"weighted": True}}],
                "update_topic": {"root": topic_root,
                                 "poll_interval_s": ONLINE_POLL_S}}
        # --- (a) serve_main from the files, the query over HTTP ---------
        applied, refreshes = [], []

        def timed_apply(graph, buf):
            batch = {"nodes": [dict(b) for bs in buf.node_updates.values()
                               for b in bs],
                     "edges": [dict(b) for bs in buf.edge_updates.values()
                               for b in bs]}
            t0 = time.perf_counter()
            real_apply(graph, buf)
            applied.append((batch, time.perf_counter() - t0))

        stream.apply_updates = timed_apply
        t0 = time.perf_counter()
        server, stop = serve(conf, block=False)
        servers.append(server)
        stops.append(stop)
        g, svc = server.graph, server.service
        serve_s = time.perf_counter() - t0
        real_refresh = svc.refresh

        def timed_refresh():
            t0 = time.perf_counter()
            real_refresh()
            sync(torch, device)
            # a request that ends after the refresh starts may already be
            # served from the new snapshot: it is checked against it
            refreshes.append({
                "t": t0, "s": time.perf_counter() - t0,
                "csr_s": g.store.edge_table("rel").host_build_s,
                "edges": g.store.edge_table("rel").num_edges})

        svc.refresh = timed_refresh
        base = "http://%s:%d" % (server.host, server.port)
        cg = client_mod.Graph(server.host, server.port, timeout=600.0)
        t0 = time.perf_counter()
        qid = cg.install(cg.V("item").batch(MICRO_BATCH).alias("src")
                         .outV("rel").sample(k1).by("random").alias("hop1")
                         .outV("rel").sample(k2).by("random").alias("hop2"),
                         micro_batch=MICRO_BATCH)
        install_s = time.perf_counter() - t0
        probe_qid = cg.install(cg.V("item").batch(1).alias("src")
                               .outV("rel").sample(k1).by("topk")
                               .alias("top"), micro_batch=16)
        check(cg.schema()["nodes"]["item"] == n, "online: schema")
        log("online store (the bench CFG store as TSV, %s bytes written in "
            "%.3f s): serve_main.serve on %s from the files with a "
            "2-partition FileTopic in %.3f s, the 2-hop [%d, %d] query "
            "installed through clients/py/gsl_client.py in %.3f s (CSR "
            "host %.3f s); card: %s"
            % (sizes, write_s, device, serve_s, k1, k2, install_s,
               g.store.edge_table("rel").host_build_s, card))

        rng = np.random.default_rng(22)
        records, errors = [], []
        lock = threading.Lock()

        def client(c, count, stop_evt, think):
            cc = client_mod.Graph(server.host, server.port, timeout=600.0)
            r = np.random.default_rng(100 + c)
            done = 0
            try:
                while (count is None and not stop_evt.is_set()) or \
                        (count is not None and done < count):
                    ids = r.integers(0, n, int(r.integers(1, max_ids + 1)))
                    t0 = time.perf_counter()
                    ans = cc.run(qid, ids.tolist())
                    t1 = time.perf_counter()
                    with lock:
                        records.append((t0, t1, ids, ans["src"]["ids"],
                                        ans["hop1"]["ids"]))
                    done += 1
                    if think:
                        time.sleep(think)
            except Exception as e:  # reported below; fails the run
                errors.append(e)

        def run_clients(count=None, stop_evt=None, think=0.0):
            ts = [threading.Thread(target=client,
                                   args=(c, count, stop_evt, think))
                  for c in range(ONLINE_CLIENTS)]
            for t in ts:
                t.start()
            return ts

        def join(ts):
            for t in ts:
                t.join(timeout=600)
            check(not any(t.is_alive() for t in ts), "online: clients hung")
            if errors:
                raise errors[0]

        cg.run(qid, [0])  # warm-up, not counted
        gather.LAUNCHES.reset()
        spmm.LAUNCHES.reset()
        t0 = time.perf_counter()
        join(run_clients(count=ONLINE_REQUESTS))
        wall = time.perf_counter() - t0
        quiet = list(records)
        lat = np.array([(r[1] - r[0]) * 1e3 for r in quiet])
        seeds = sum(r[2].size for r in quiet)
        log("online HTTP serving, %d clients x %d requests of 1..%d ids "
            "(the JSON answer carries every alias's feature rows): p50 "
            "%.3f ms, p99 %.3f ms, max %.3f ms, %.1f seeds/s, %.1f "
            "requests/s on the clients' clock; DGS's north star is a 20 ms "
            "p99; card: %s"
            % (ONLINE_CLIENTS, ONLINE_REQUESTS, max_ids,
               np.percentile(lat, 50), np.percentile(lat, 99), lat.max(),
               seeds / wall, len(quiet) / wall, card))

        # --- (b) the stream, with the clients running --------------------
        producer = stream.StreamProducer(
            stream.FileTopic(topic_root, create=False))
        new_ids = np.arange(n, n + new_nodes, dtype=np.int64)
        new_feats = rng.standard_normal((new_nodes, d)).astype(np.float32)
        new_labels = rng.integers(0, cfg["classes"], new_nodes).astype(
            np.int32)
        stop_evt = threading.Event()
        records.clear()
        streaming = run_clients(stop_evt=stop_evt, think=ONLINE_THINK_S)
        t_stream = time.perf_counter()
        stale, put = [], []
        try:
            producer.put_nodes("item", new_ids, labels=new_labels,
                               float_attrs=new_feats)
            deadline = time.time() + 300
            while len(refreshes) < 1 and time.time() < deadline:
                time.sleep(0.01)
            check(len(refreshes) >= 1, "online: the new nodes never landed")
            for b in range(ONLINE_EDGE_BATCHES):
                src = rng.integers(0, n, edge_batch)
                dst = rng.integers(0, n + new_nodes, edge_batch)
                w = rng.random(edge_batch).astype(np.float32)
                # the probe: its source's heaviest edge, newer probes
                # heavier still
                w[0] = ONLINE_PROBE_WEIGHT + b
                put.append((src, dst, w))
                t_put = time.perf_counter()
                producer.put_edges("rel", src, dst, weights=w)
                while time.perf_counter() - t_put < 300:
                    top = cg.run(probe_qid, [int(src[0])])["top"]["ids"][0]
                    if top[0] == int(dst[0]):
                        break
                    time.sleep(0.005)
                check(top[0] == int(dst[0]), "online: batch %d never served"
                      % b)
                stale.append(time.perf_counter() - t_put)
            # the pump may take a batch in two polls: wait for the rest
            total = ONLINE_EDGE_BATCHES * edge_batch
            while time.perf_counter() - t_stream < 600:
                landed = sum(b["src_ids"].size for batch, _ in applied
                             for b in batch["edges"])
                if landed == total and len(refreshes) == len(applied):
                    break
                time.sleep(0.05)
            check(landed == total and len(refreshes) == len(applied),
                  "online: %d of %d streamed edges applied" % (landed, total))
        finally:
            stop_evt.set()
            join(streaming)
        stream_wall = time.perf_counter() - t_stream
        counts = {"http_serving": {"gather_rows": gather.LAUNCHES.count,
                                   "segment_spmm": spmm.LAUNCHES.count}}
        busy = list(records)
        slat = np.array([(r[1] - r[0]) * 1e3 for r in busy])
        parts = [(a[1], r["csr_s"], r["s"] - r["csr_s"])
                 for a, r in zip(applied, refreshes)]
        log("online stream (%d new nodes with features, then %d batches of "
            "%d weighted edges, through StreamProducer -> FileTopic -> the "
            "update pump, polled every %.1f s): %d ingests in %.3f s; each "
            "ingest: apply_updates / host CSR / upload s %s; staleness "
            "from put_edges to the first answer that reaches the batch's "
            "heaviest edge %s s; HTTP p99 during the stream %.3f ms (p50 "
            "%.3f, max %.3f, %d requests) against %.3f ms without it; "
            "card: %s"
            % (new_nodes, ONLINE_EDGE_BATCHES, edge_batch, ONLINE_POLL_S,
               len(applied), stream_wall,
               [tuple(round(x, 3) for x in p) for p in parts],
               [round(s, 3) for s in stale], np.percentile(slat, 99),
               np.percentile(slat, 50), slat.max(), slat.size,
               np.percentile(lat, 99), card))

        # the streamed store against one built in memory from the same
        # rows, in the order the pump applied them
        got_edges = [b for batch, _ in applied for b in batch["edges"]]
        src_all = np.concatenate([b["src_ids"] for b in got_edges])
        dst_all = np.concatenate([b["dst_ids"] for b in got_edges])
        w_all = np.concatenate([b["weights"] for b in got_edges])
        want = np.concatenate([np.stack([s, t, w.view(np.int32)], 1)
                               for s, t, w in put])
        have = np.stack([src_all, dst_all, w_all.view(np.int32)], 1)
        check(np.array_equal(want[np.lexsort(want.T[::-1])],
                             have[np.lexsort(have.T[::-1])]),
              "online: the streamed edges are not the produced ones")
        got_nodes = [b for batch, _ in applied for b in batch["nodes"]]
        node_ids = np.concatenate([b["ids"] for b in got_nodes])
        check(np.array_equal(np.sort(node_ids), new_ids),
              "online: the streamed nodes are not the produced ones")
        nt = g.store.node_table("item")
        live = svc._queries[qid]._snap.tables["edges"]["rel"]
        mine = gl.EdgeTable(
            "rel", "item", "item", g.store.edge_table("rel").decoder,
            src=np.concatenate([orig_src, nt.index.lookup(src_all)]),
            dst=np.concatenate([orig_dst, nt.index.lookup(dst_all)]),
            num_src_nodes=nt.num_nodes, num_dst_nodes=nt.num_nodes,
            weights=np.concatenate([orig_w, w_all])).device(device)
        for side in ("out", "inc"):
            for f in ("row_offsets", "nbr_ids", "nbr_edge_ids",
                      "cum_weights"):
                check(torch.equal(getattr(getattr(live, side), f),
                                  getattr(getattr(mine, side), f)),
                      "online: the streamed store's %s.%s differs from the "
                      "in-memory build" % (side, f))
        check(np.array_equal(nt.raw_ids[n:], node_ids)
              and np.array_equal(nt.raw_ids[:n], np.arange(n)),
              "online: new node rows out of order")
        del mine
        # every served hop1 id is a true neighbour of the newest snapshot
        # live during its request (snapshots only grow); a fill is allowed
        # only where the seed had no edge when the request started
        n_all = n + new_nodes
        cum = [edge_key_sets(orig_src, orig_dst, n_all)]
        s_parts, d_parts = [orig_src], [orig_dst]
        for batch, _ in applied:
            if batch["edges"]:
                s_parts += [nt.index.lookup(b["src_ids"])
                            for b in batch["edges"]]
                d_parts += [nt.index.lookup(b["dst_ids"])
                            for b in batch["edges"]]
            cum.append(edge_key_sets(np.concatenate(s_parts),
                                     np.concatenate(d_parts), n_all))
        swaps = np.array([r["t"] for r in refreshes])
        out_deg0 = np.bincount(orig_src, minlength=n_all)
        checked = 0
        for t0, t1, ids, src_ids, hop1 in quiet + busy:
            keys = cum[int(np.searchsorted(swaps, t1))]
            s = np.repeat(np.asarray(src_ids, np.int64), k1)
            h = np.asarray(hop1, np.int64).reshape(-1)
            pos = np.clip(np.searchsorted(keys, s * n_all + h), 0,
                          keys.size - 1)
            ok = (keys[pos] == s * n_all + h) | ((out_deg0[s] == 0)
                                                 & (h == 0))
            check(bool(ok.all()) and np.array_equal(np.asarray(src_ids),
                                                     ids),
                  "online: a served hop1 id is no neighbour in any live "
                  "snapshot")
            checked += h.size
        log("online: the streamed store's flat CSR views (row_offsets, "
            "nbr_ids, nbr_edge_ids, cum_weights, out and in) bit-equal to "
            "an in-memory build from the original and streamed rows; %d "
            "served hop1 ids of %d requests each a true neighbour of the "
            "newest snapshot live during its request" % (checked,
                                                         len(quiet + busy)))

        # --- (c) exported programs through /admin/model -----------------
        q = server.service._queries[qid].query
        tables = svc._queries[qid]._snap.tables
        table = tables["nodes"]["item"].float_attrs
        on_card = torch.device(device).type == "cuda"
        devs = [torch.device(device)] if on_card else []
        counters = {"gather_rows": gather.LAUNCHES,
                    "segment_spmm": spmm.LAUNCHES,
                    "gat_block": gat.LAUNCHES_FWD,
                    "gat_block_bwd": gat.LAUNCHES_BWD,
                    "sweep_aggregate": sweep.LAUNCHES_SWEEP}

        def serving_fn(model):
            def fn(seeds, generator):
                ans = _execute(q, tables, seeds, generator)
                return model(EgoGraph.from_query_result(
                    ans, "src", ["hop1", "hop2"], defer_last_table=table))
            return fn

        def serve_exported(name, what, fn, want):
            """Export ``fn`` on the device, hold the program's glt
            operators to ``want``, install it by bytes through POST
            /admin/model; one /predict launches each kernel as often as
            the program holds it and equals the forward run in the process
            on the same seed; then the /predict latency.  Returns the
            launches of the one /predict and of all of them."""
            want = {k: want.get(k, 0) for k in counters}
            t0 = time.perf_counter()
            blob = export.export_serving_fn(
                fn, (np.arange(MICRO_BATCH), 0), device=device)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = export.load_serving_exported(blob)
            load_s = time.perf_counter() - t0
            ops = [str(x.target) for x in loaded.program.graph.nodes
                   if x.op == "call_function"]
            held = {k: ops.count("glt.%s.default" % k) for k in counters}
            check(held == want, "online: the exported %s program holds %s "
                  "glt operators (want %s)" % (name, held, want))
            del loaded
            t0 = time.perf_counter()
            r = cg.install_model(name, blob)
            install_model_s = time.perf_counter() - t0
            check(r == {"name": name, "batch": MICRO_BATCH},
                  "online: install_model answered %s" % r)
            ids = rng.integers(0, n, MICRO_BATCH)
            for c in counters.values():
                c.reset()
            got = np.asarray(cg.predict(name, ids.tolist(),
                                        seed=ONLINE_PREDICT_SEED), np.float32)
            one = {k: c.count for k, c in counters.items()}
            check(one == {k: v * on_card for k, v in want.items()},
                  "online: one /predict of %s launched %s (want %s)"
                  % (name, one, want))
            with torch.random.fork_rng(devices=devs), torch.no_grad():
                torch.manual_seed(ONLINE_PREDICT_SEED)
                ref = fn(torch.as_tensor(ids, dtype=torch.int32,
                                         device=device), None)
            ref = ref.float().cpu().numpy()
            err = float(np.abs(got - ref).max())
            check(got.shape == (MICRO_BATCH, CLASSES)
                  and np.isfinite(got).all()
                  and np.allclose(got, ref, rtol=ONLINE_PREDICT_TOL,
                                  atol=ONLINE_PREDICT_TOL),
                  "online: /predict of %s differs from the forward: %g"
                  % (name, err))
            plat = []
            for i in range(ONLINE_PREDICT_CALLS):
                part = rng.integers(0, n, int(rng.integers(1,
                                                           MICRO_BATCH + 1)))
                t0 = time.perf_counter()
                out = cg.predict(name, part.tolist(), seed=i)
                plat.append((time.perf_counter() - t0) * 1e3)
                check(len(out) == part.size, "online: /predict rows")
            plat = np.array(plat)
            log("online export (sample + lookup + %s, batch %d, traced on "
                "%s): %d bytes, exported in %.3f s, loaded in %.3f s "
                "(installed by bytes through POST /admin/model in %.3f s); "
                "the program holds the glt operators %s and one /predict "
                "launched %s; /predict equals the forward run in the "
                "process on the same seed within %g (max abs err %g); "
                "/predict of 1..%d ids over HTTP, %d calls: p50 %.3f ms, "
                "p99 %.3f ms; card: %s"
                % (what, MICRO_BATCH, device, len(blob), export_s, load_s,
                   install_model_s, {k: v for k, v in held.items() if v},
                   {k: v for k, v in one.items() if v}, ONLINE_PREDICT_TOL,
                   err, MICRO_BATCH, ONLINE_PREDICT_CALLS,
                   np.percentile(plat, 50), np.percentile(plat, 99), card))
            return one, {k: c.count for k, c in counters.items()}

        torch.manual_seed(22)
        model = EgoGraphSAGE([d, HIDDEN, CLASSES],
                             g.get_node_decoder("item"), agg_type="gcn",
                             device=device).eval()
        sage_fn = serving_fn(model)
        sage = ("gather_rows", "segment_spmm")
        one, total = serve_exported(
            "sage", "EgoGraphSAGE [%d, %d, %d] gcn" % (d, HIDDEN, CLASSES),
            sage_fn, {"gather_rows": 2, "segment_spmm": 1})
        launches = {k: one[k] for k in sage}
        counts["predict"] = {k: total[k] for k in sage}
        with open(os.path.join(root, ONLINE_STABLEHLO), "rb") as f:
            jax_blob = f.read()
        try:
            cg.install_model("jax", jax_blob)
            refused = False
        except urllib.error.HTTPError as e:
            refused = "torch.export" in e.read().decode()
        check(refused, "online: a JAX StableHLO artifact was not refused")
        log("online export: a JAX StableHLO artifact is refused by POST "
            "/admin/model")
        # EgoGAT at phase 6's width: three neighbour blocks (Kernel 3; the
        # card takes each block whole, and so does the CPU with
        # seed_chunk=0)
        torch.manual_seed(22)
        gat_model = EgoGAT([d, HIDDEN, CLASSES], g.get_node_decoder("item"),
                           num_heads=list(GAT_HEADS), seed_chunk=0,
                           device=device).eval()
        counts["gat_one_predict"], _ = serve_exported(
            "gat", "EgoGAT [%d, %d, %d] heads %s" % (d, HIDDEN, CLASSES,
                                                     list(GAT_HEADS)),
            serving_fn(gat_model), {"gather_rows": 3, "gat_block": 3})
        del gat_model
        # the EgoGraphSAGE above on the sorted route: its deepest-hop mean
        # through sweep_prep and Kernel 4, traced under the flag
        with bench.bench_conf(sorted_gather=True, sorted_gather_min_bytes=(
                table.numel() * table.element_size())):
            counts["sorted_one_predict"], _ = serve_exported(
                "sage_sorted", "EgoGraphSAGE [%d, %d, %d] gcn, "
                "conf.sorted_gather" % (d, HIDDEN, CLASSES), sage_fn,
                {"gather_rows": 2, "sweep_aggregate": 1})
        svc._models.clear()
        for c in counters.values():
            c.reset()

        # --- (d) the router over two in-process workers --------------------
        twin = http.ServingServer(replica_graph(gl, g), device=device).start()
        servers.append(twin)
        stops.append(twin.stop)
        urls = [base, "http://%s:%d" % (twin.host, twin.port)]
        rt = router.ServingRouter(urls)
        plan = (cg.V("item").batch(8).alias("src").outV("rel").sample(k1)
                .by("topk").alias("top")).plan()
        rqid = rt.install(plan, micro_batch=64)
        ids = rng.integers(0, n, 64)
        check(set((ids % 2).tolist()) == {0, 1}, "online: one owner only")
        stitched = rt.run(rqid, ids)
        single = rt.workers[0].run(rt._qids[rqid][0], ids)
        check(json.dumps(stitched, sort_keys=True)
              == json.dumps(single, sort_keys=True),
              "online: the router's stitched answer differs from one "
              "worker's")
        svc.refresh = real_refresh
        t0 = time.perf_counter()
        v = int(ids[0])
        r = rt.update(edges={"rel": {"src_ids": [v], "dst_ids": [n + 1],
                                     "weights": [2 * ONLINE_PROBE_WEIGHT]}})
        rt.refresh()
        fan_s = time.perf_counter() - t0
        check(r["applied"], "online: the router refused the update")
        want_top = int(nt.index.lookup(np.array([n + 1]))[0])
        for w, wq in zip(rt.workers, rt._qids[rqid]):
            check(w.run(wq, [v])["top"]["ids"][0][0] == want_top,
                  "online: the update did not reach every worker")
        log("online router over 2 in-process workers (one a replica of the "
            "streamed store): a topk answer of 64 ids over both owners "
            "stitched equal to one worker's; one update fanned out, "
            "applied and refreshed on both in %.3f s, its edge served by "
            "both; card: %s" % (fan_s, card))
    finally:
        stream.apply_updates = real_apply
        for stop in reversed(stops):
            stop()
        if files is None:
            shutil.rmtree(where, ignore_errors=True)
    counts["router"] = {"gather_rows": gather.LAUNCHES.count,
                        "segment_spmm": spmm.LAUNCHES.count}
    log("glt_online launches: %s (HTTP serving: the answers' feature rows; "
        "predict: %d /predict calls; router: the answers' rows); phase 22 "
        "in %.1f s" % (counts, ONLINE_PREDICT_CALLS + 1,
                       time.perf_counter() - t_phase))
    counts["one_predict"] = launches
    return counts


# ---------------------------------------------------------------------------
# Phase 23: the file-backed examples on real layouts: the reference Cora
# configuration at 1 433 features, Cora's raw layout through prepare_cora,
# SEAL's --collab_dir at ogbl-collab's counts
# ---------------------------------------------------------------------------

# tests/test_real_datasets.py:249-275: cora_like at Cora's size, the
# reference's EgoSAGE configuration (the example's other defaults:
# fanout [25, 10], gcn, hidden 128, batch 140, Adam 0.05, dropout 0.5)
CORA_REF = dict(nodes=2708, features=1433, classes=7, epochs=40, bar=0.88)
CORA_BATCH, CORA_NBRS = 140, (25, 10)
# Kernel 1's rows and Kernel 2's means in one step of that configuration
CORA_GATHER_ROWS = (CORA_BATCH, CORA_BATCH * CORA_NBRS[0])
# Cora's published counts: 2 708 papers, 5 429 citations, 1 433 binary
# words, 7 classes (their names); the raw files are drawn, their ids not
# contiguous, about 18 words a paper
RAW_CORA = dict(papers=2708, cites=5429, words=1433, epochs=2,
                density=18.0 / 1433, id_range=1_200_000, seed=23)
CORA_CLASSES = ("Case_Based", "Genetic_Algorithms", "Neural_Networks",
                "Probabilistic_Methods", "Reinforcement_Learning",
                "Rule_Learning", "Theory")
# Cora's splits (examples/data/cora.py): rows 0:140, 200:500, 500:1500
CORA_SPLITS = (("MASK*item", 0, 140), ("MASK**item", 200, 500),
               ("MASK***item", 500, 1500))
# ogbl-collab's published counts (seal.COLLAB_*), 150 steps of batch 64
COLLAB_FILES = dict(nodes=235_868, train=1_179_052, valid=60_084,
                    test=46_329, neg=100_000, steps=150, batch=64)
COLLAB_WRITE_TIMEOUT_S = 600


# 23(c)'s tables are written by a child process started with phase 15,
# while the card runs phases 15-21d: the writer is Python text
# formatting, one core for about 40 s
COLLAB_WRITER = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from graph_learn_tpu_torch.examples import seal
from graph_learn_tpu_torch.examples.data import ogbl_collab
where, c = sys.argv[2], json.loads(sys.argv[3])
a = seal.planted_collab(c["nodes"], c["train"], c["valid"], c["test"],
                        c["neg"], feat_dim=seal.COLLAB_FEAT)
t0 = time.perf_counter()
ogbl_collab.write_collab_tables(
    where, a["train"], np.ones(len(a["train"])), a["valid"], a["valid_neg"],
    a["test"], a["test_neg"], a["feats"])
print(json.dumps({"write_s": time.perf_counter() - t0}))
"""


def start_collab_writer(collab):
    """A child process that draws ``seal.planted_collab`` at ``collab``'s
    counts and writes its six tables into a new temporary directory with
    ``write_collab_tables``.  Returns (the process, the directory); a
    process left running is killed at exit."""
    import atexit
    import tempfile
    where = tempfile.mkdtemp(prefix="glt_collab_tables_")
    proc = subprocess.Popen(
        [sys.executable, "-c", COLLAB_WRITER,
         os.path.dirname(os.path.abspath(__file__)), where,
         json.dumps(collab)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    writer = (proc, where)
    atexit.register(stop_collab_writer, writer)
    return writer


def stop_collab_writer(writer):
    """Kill the writer if it still runs, reap it, remove its tables."""
    proc, where = writer
    if proc.poll() is None:
        proc.kill()
    proc.communicate()
    shutil.rmtree(where, ignore_errors=True)


def expected_launches(per, names, steps, evals):
    """{kernel: launches} of ``steps`` training steps and ``evals``
    evaluated batches at ``per`` launches a step; a backward
    (``gat_block_bwd``) runs in training only."""
    return {k: per.get(k, 0) * steps
            + (per.get(k, 0) * evals if not k.endswith("_bwd") else 0)
            for k in names}


def vector_route(name):
    """The route a mangled Kernel 1 or 2 name says: ``bulk``; ``lanes,
    N-byte words`` (the lane groups' vector type); ``vec N`` (Kernel 2's
    elements a load)."""
    import re
    if "bulk" in name:
        return "bulk"
    m = re.search(r"segment_spmm_kernelI.*?Li(\d+)E", name) or re.search(
        r"segment_spmm_kernel<[^>]*?(\d+)>", name)
    if "segment_spmm" in name:
        return "vec %s" % (m.group(1) if m else "?")
    m = re.search(r"gather_rows_kernelI(5uint4|5uint2|j|t|h)E", name)
    size = {"5uint4": 16, "5uint2": 8, "j": 4, "t": 2, "h": 1}.get(
        m.group(1) if m else "", 0)
    return "lanes, %d-byte words" % size if size else "lanes"


def draw_raw_cora(where, papers, cites, words, density, id_range, seed,
                  **_):
    """cora.content (id, ``words`` 0/1 flags, class name) and cora.cites
    (cited, citing) in Cora's raw format, drawn from ``seed``: ids
    distinct and not contiguous, classes round the 7 names, citations
    between two distinct papers.  Returns (ids, flags [papers, words])."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, id_range), papers, replace=False)
    flags = (rng.random((papers, words)) < density).astype(np.int8)
    labels = rng.integers(0, len(CORA_CLASSES), papers)
    text = np.where(flags == 1, "1", "0")
    with open(os.path.join(where, "cora.content"), "w") as f:
        for i in range(papers):
            f.write("%d\t%s\t%s\n" % (ids[i], "\t".join(text[i]),
                                      CORA_CLASSES[labels[i]]))
    a = rng.integers(0, papers, cites)
    b = (a + rng.integers(1, papers, cites)) % papers
    with open(os.path.join(where, "cora.cites"), "w") as f:
        f.write("".join("%d\t%d\n" % (ids[x], ids[y])
                        for x, y in zip(a, b)))
    return ids, flags


def uniform_cum_weights(torch, csr):
    """The cum_weights of rows whose weights are all zero: uniform, 1/deg,
    2/deg, ... 1 along each row."""
    off = csr.row_offsets.cpu().numpy()
    deg = np.diff(off)
    rows = np.repeat(np.arange(deg.size), deg)
    rank = np.arange(rows.size) - off[:-1][rows] + 1
    return torch.equal(csr.cum_weights.cpu(),
                       torch.from_numpy((rank / np.maximum(deg[rows], 1))
                                        .astype(np.float32)))


def cora_step_shapes(torch, card, gather, spmm, g):
    """Kernels 1 and 2 at one training batch of the Cora configuration:
    Kernel 1 at its src (140) and hop-1 (3 500) rows of the [2 708, 1 433]
    f32 table, Kernel 2 at its [3 500, 10] hop-2 means, each exact or
    within 1e-5 of its plain version, one kernel a call (``captured_work``)
    on the route its name says, cold against its bound (each distinct
    row read once: the 15.5 MB table fits the L2), plain version and
    library call.  Returns the kernels line's fields."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.examples import common
    from graph_learn_tpu_torch.gsl.dataset import Dataset

    q = common.supervised_query(g, gl.Mask.TRAIN, CORA_BATCH, CORA_NBRS)
    batch = Dataset(q, window=1, device="cuda").next()
    table = batch["hop2"].float_attrs.table
    n = table.shape[0]

    def ids(alias):
        idx = batch[alias].float_attrs.idx
        return torch.clamp(idx, 0, n - 1).to(torch.int32)
    given = {CORA_GATHER_ROWS[0]: ids("src").reshape(-1),
             CORA_GATHER_ROWS[1]: ids("hop1").reshape(-1)}
    check(tuple(table.shape) == (CORA_REF["nodes"], CORA_REF["features"])
          and table.dtype == torch.float32
          and sorted(given) == sorted(v.numel() for v in given.values()),
          "cora batch: table %s %s, rows %s" % (
              tuple(table.shape), table.dtype,
              [v.numel() for v in given.values()]))
    gen = torch.Generator(device="cuda").manual_seed(47)
    shapes = gather_shapes(torch, gather, table, gen, "at the Cora table",
                           rows=CORA_GATHER_ROWS, given=given,
                           yardsticks=CORA_GATHER_ROWS, distinct=True)
    fields = {"gather_rows": {}, "segment_spmm": {}}
    for m, f in shapes.items():
        fields["gather_rows"].update({
            "cold_ms_cora_%d" % m: f["ms"], "bound_ms_cora_%d" % m:
            f["bound_ms"], "plain_cold_ms_cora_%d" % m: f["plain_ms"],
            "library_cold_ms_cora_%d" % m: f["library_ms"],
            "kernel_route_cora_%d" % m: vector_route(f["kernel"])})
    hop2 = ids("hop2").reshape(-1, CORA_NBRS[1])
    deg = torch.full((hop2.shape[0],), CORA_NBRS[1], dtype=torch.int32,
                     device="cuda")
    def mean():
        return spmm.segment_spmm(table, hop2, deg, "mean", torch.float32)
    work, _ = check_one_launch(torch, "segment_spmm at the Cora table", mean,
                               "segment_spmm_kernel")
    name = next(n_ for n_ in captured_work(torch, mean)
                if "segment_spmm" in n_)
    f = spmm_shape(torch, spmm, table, hop2, "mean", "at the Cora table",
                   distinct=True)
    fields["segment_spmm"].update(
        cold_ms_cora_spmm=f["ms"], bound_ms_cora_spmm=f["bound_ms"],
        plain_cold_ms_cora_spmm=f["plain_ms"],
        library_cold_ms_cora_spmm=f["library_ms"],
        kernel_route_cora_spmm=vector_route(name))
    log("Kernels at the Cora shapes ([%d, %d] f32, rows of %d bytes): "
        "gather_rows %s; segment_spmm [%d, %d] mean on %s (%s a call); "
        "card: %s"
        % (n, table.shape[1], 4 * table.shape[1],
           {m: fields["gather_rows"]["kernel_route_cora_%d" % m]
            for m in CORA_GATHER_ROWS}, hop2.shape[0], hop2.shape[1],
           fields["segment_spmm"]["kernel_route_cora_spmm"], work, card))
    return fields


def real_layout_path(torch, card, gather, spmm, device="cuda",
                     cora_ref=CORA_REF, raw_cora=RAW_CORA,
                     collab=COLLAB_FILES, writer=None):
    """23: the file-backed examples on real layouts (module note, phase
    23); ``writer`` is ``start_collab_writer(collab)``'s (started here
    where it is None); the sizes and the device are arguments so that the
    phase can be rehearsed small on the CPU, where no kernel launches and
    none is timed.  Returns the kernels line's fields."""
    import tempfile

    from graph_learn_tpu_torch.examples import ego_sage_supervised, seal
    from graph_learn_tpu_torch.examples.data import cora, synthetic

    on_card = torch.device(device).type == "cuda"
    counters = {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES}
    per = TSV_PER_STEP["ego_sage_supervised"]
    fields = {"gather_rows": {}, "segment_spmm": {}}
    where = tempfile.mkdtemp(prefix="glt_real_layout_")
    t_phase = time.perf_counter()
    writer = writer or start_collab_writer(collab)

    def train_cora(d, epochs, graph, what):
        argv = ["--data_dir", d, "--features_num", str(cora_ref["features"]),
                "--nodes", str(cora_ref["nodes"]), "--classes",
                str(cora_ref["classes"]), "--epochs", str(epochs)]
        args = ego_sage_supervised.build_parser().parse_args(
            argv + (["--cpu"] if not on_card else []))
        for c in counters.values():
            c.reset()
        out = ego_sage_supervised.run(args, graph)
        store = out["graph"].store
        steps = epochs * -(-store.node_set(CORA_SPLITS[0][0]).size
                           // args.batch_size)
        evals = -(-store.node_set(CORA_SPLITS[2][0]).size
                  // args.batch_size)
        got = {k: c.count for k, c in counters.items()}
        want = {k: v * on_card for k, v in expected_launches(
            per, counters, steps, evals).items()}
        check(got == want and bool(np.isfinite(out["history"]).all()),
              "%s: launches %s, want %s (%d steps, %d evaluated batches); "
              "losses %s" % (what, got, want, steps, evals, out["history"]))
        return out, steps, evals

    try:
        # (a) the reference Cora configuration at full width
        d = os.path.join(where, "cora_ref")
        t0 = time.perf_counter()
        synthetic.cora_like(d, n=cora_ref["nodes"],
                            classes=cora_ref["classes"],
                            feat_dim=cora_ref["features"])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, steps, evals = train_cora(d, cora_ref["epochs"], None,
                                       "cora reference configuration")
        wall = time.perf_counter() - t0
        ms_step = out["train_s"] / steps * 1e3
        log("cora reference configuration (cora_like %d nodes x %d f32 "
            "features, %d classes, written in %.2f s; fanout %s, gcn, hidden "
            "128, batch %d, Adam 0.05, dropout 0.5, %d epochs = %d steps): "
            "%.1f s in all, %.3f ms a step on the host clock, loss %.4f -> "
            "%.4f, test accuracy %.4f (bar %.2f); launches a step %s over "
            "the steps and %d evaluated batches; card: %s"
            % (cora_ref["nodes"], cora_ref["features"], cora_ref["classes"],
               write_s, list(CORA_NBRS), CORA_BATCH, cora_ref["epochs"],
               steps, wall, ms_step, out["history"][0], out["history"][-1],
               out["acc"], cora_ref["bar"], per, evals, card))
        check(out["acc"] >= cora_ref["bar"], "cora reference configuration: "
              "test accuracy %.4f under %.2f" % (out["acc"],
                                                 cora_ref["bar"]))
        for k in fields:
            fields[k].update(cora_ref_launches_per_step=float(per[k]),
                             cora_ref_test_accuracy=out["acc"],
                             cora_ref_ms_step=ms_step)
        if on_card:
            for k, v in cora_step_shapes(torch, card, gather, spmm,
                                         out["graph"]).items():
                fields[k].update(v)
        del out
        gc.collect()

        # (b) Cora's raw layout through prepare_cora and load_graph
        raw, prepared = os.path.join(where, "raw"), os.path.join(where,
                                                                  "cora")
        os.makedirs(raw)
        t0 = time.perf_counter()
        ids, flags = draw_raw_cora(raw, **raw_cora)
        draw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cora.prepare_cora(raw, prepared)
        prep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g, dec = ego_sage_supervised.load_graph(prepared, raw_cora["words"],
                                                device=device)
        load_s = time.perf_counter() - t0
        nt, et = g.store.node_table("item"), g.store.edge_table("relation")
        x = flags.astype(np.float32)
        s = x.sum(axis=1, keepdims=True)
        x = (x / np.where(s == 0, 1.0, s)).astype(np.float32)
        n = raw_cora["papers"]
        splits = {name: g.store.node_set(name).size
                  for name, _, _ in CORA_SPLITS}
        check(np.array_equal(nt.raw_ids, ids)
              and nt.float_attrs.dtype == x.dtype
              and np.array_equal(nt.float_attrs, x)
              and bool(np.all(et.weights == 0))
              and uniform_cum_weights(torch, et.device(device).out)
              and splits == {name: max(min(hi, n) - min(lo, n), 0)
                             for name, lo, hi in CORA_SPLITS},
              "raw cora: ids, row-normalised features, zero weights, "
              "uniform cum_weights or splits %s differ from the raw files"
              % splits)
        t0 = time.perf_counter()
        out, steps, evals = train_cora(prepared, raw_cora["epochs"],
                                       (g, dec), "raw cora")
        log("raw cora (drawn at Cora's counts: %d papers with ids up to %d, "
            "%d citations, %d words, 7 class names; drawn in %.2f s, "
            "prepare_cora %.2f s, load_graph %.2f s): ids, row-normalised "
            "features bit-equal to the raw flags' read back, %d zero-weight "
            "edges with uniform cum_weights, splits %s; %d epochs = %d steps "
            "in %.2f s, losses %s, launches a step %s; card: %s"
            % (n, int(ids.max()), raw_cora["cites"], raw_cora["words"],
               draw_s, prep_s, load_s, et.num_edges, splits,
               raw_cora["epochs"], steps, time.perf_counter() - t0,
               [round(v, 4) for v in out["history"]], per, card))
        del out, g
        gc.collect()

        # (c) SEAL through --collab_dir at ogbl-collab's counts, on the
        # tables the writer process has written meanwhile
        t0 = time.perf_counter()
        a = seal.planted_collab(collab["nodes"], collab["train"],
                                collab["valid"], collab["test"],
                                collab["neg"], feat_dim=seal.COLLAB_FEAT)
        draw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc, d = writer
        w_out, w_err = proc.communicate(timeout=COLLAB_WRITE_TIMEOUT_S)
        wait_s = time.perf_counter() - t0
        check(proc.returncode == 0, "the collab writer process failed "
              "(%s): %s" % (proc.returncode, w_err[-2000:]))
        write_s = json.loads(w_out.splitlines()[-1])["write_s"]
        n_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for f in os.listdir(d))
        b = collab["batch"]
        for c in counters.values():
            c.reset()
        out = seal.run(["--collab_dir", d, "--steps", str(collab["steps"]),
                        "--batch_size", str(b)]
                       + (["--cpu"] if not on_card else []))
        got = gather.LAUNCHES.count
        scored = -(-len(a["test"]) // b) + -(-len(a["test_neg"]) // b)
        want = (2 * collab["steps"] + scored) * on_card
        twin = seal.build_graph(a["feats"], a["train"][:, 0],
                                a["train"][:, 1], device)
        same_store(torch, out["graph"], twin, "collab files", device)
        rng = np.random.default_rng(0)
        chance = seal.hits_at(rng.standard_normal(len(a["test"])),
                              rng.standard_normal(len(a["test_neg"])))
        hits = out["hits"]
        log("seal --collab_dir (planted communities at ogbl-collab's "
            "counts: %d nodes x %d f32, %d train, %d valid, %d test pairs, "
            "%d negatives each; drawn in %.1f s, %d bytes of tables written "
            "by write_collab_tables in %.1f s in a child process while the "
            "earlier phases ran, %.1f s waited for): init %.1f s, the store bit-equal to build_graph of "
            "the same draws; %d steps of batch %d in %.1f s; %d + %d pairs "
            "scored in %.1f s; hits@50 %.4f (random scores %.4f); %d "
            "gather_rows launches (2 a step and 1 a scored batch); card: %s"
            % (collab["nodes"], seal.COLLAB_FEAT, collab["train"],
               collab["valid"], collab["test"], collab["neg"], draw_s,
               n_bytes, write_s, wait_s, out["load_s"], collab["steps"], b,
               out["train_s"], len(a["test"]), len(a["test_neg"]),
               out["score_s"], hits, chance, got, card))
        check(got == want and np.isfinite(hits) and hits > chance,
              "seal --collab_dir: %d gather_rows launches, want %d; hits@50 "
              "%r against random scores' %.4f" % (got, want, hits, chance))
        fields["gather_rows"].update(
            collab_files_hits_at_50=hits,
            collab_files_launches_per_step=2.0 if on_card else 0.0)
        del out, twin, a
        gc.collect()
    finally:
        stop_collab_writer(writer)
        shutil.rmtree(where, ignore_errors=True)
    log("phase 23 (real layouts) in %.1f s" % (time.perf_counter() - t_phase))
    return fields


# ---------------------------------------------------------------------------
# Phase 24: the parallel store and training on torch.distributed
# ---------------------------------------------------------------------------

PAR_WARM, PAR_STEPS = 2, 10  # (a), (c): warm steps, then timed steps
PAR_PART_STEPS = 5  # (b): timed steps a routing, after PAR_WARM
PAR_TOPK_BATCHES = 3  # (b): topk batches held to the one-rank plan
PAR_GCN_DIMS, PAR_GCN_STEPS = (256, 32), 5  # (d)
PAR_RTOL = 1e-5
# (d): the largest difference of a summed gradient from the one-rank dense
# GCN's, over the gradient's largest entry, both in float64.  In float32
# the two sum in different orders, so a hidden unit within rounding of 0
# can fall on the other side of the ReLU in one and not the other, and
# one such unit moves the first layer's weight gradient by about
# 1/sqrt(nodes) of its largest entry.  The line reports both.
PAR_GRAD_RTOL = 1e-9
SHARED_CARD = "2 gloo ranks sharing one card, not NVLink collectives"
PARALLEL_TIMEOUT_S = 300
# the bench CFG store and step (graph_learn_tpu_torch/bench.py CFG)
PAR_CFG = dict(n_nodes=N_NODES, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
               hidden=HIDDEN, classes=CLASSES, batch=MICRO_BATCH,
               fanout=FANOUT, device="cuda")


def _par_query(g, cfg, strategy="random"):
    k1, k2 = cfg["fanout"]
    return (g.V("item").batch(cfg["batch"]).alias("src")
            .outV("rel").sample(k1).by(strategy).alias("hop1")
            .outV("rel").sample(k2).by(strategy).alias("hop2").values())


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _par_model(torch, dec, cfg):
    """EgoGraphSAGE [128, 256, 32] "gcn", weights from seed 0."""
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
    torch.manual_seed(0)
    return EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                        dec, agg_type="gcn", device=cfg["device"])


def _par_loss(model, batch, generator, training):
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    ego = EgoGraph.from_query_result(batch, "src", HOPS)
    return supervised_softmax_loss(model(ego, training=training,
                                         generator=generator),
                                   batch["src"].labels)


def _pre_aggregate(batch, tables):
    """The deepest hop's mean by Kernel 2, outside the gradient."""
    from graph_learn_tpu_torch.nn.data import pre_aggregate_hop
    return pre_aggregate_hop(batch, "hop2",
                             tables["nodes"]["item"].float_attrs, "mean")


class _StepClock:
    """Stamps the card-synchronised host clock at the end of each of
    ``optimizer``'s steps (a step post-hook).  ``step_ms(warm)`` divides
    the wall from the end of the last warm step to now by the steps in
    it, so each timed step is in the window whole: its seeds, plan,
    batch transform, forward, backward and update."""

    def __init__(self, torch, device, optimizer):
        self.torch, self.device, self.stamps = torch, device, []
        self.hook = optimizer.register_step_post_hook(self._stamp)

    def _stamp(self, optimizer, args, kwargs):
        _sync(self.torch, self.device)
        self.stamps.append(time.perf_counter())

    def step_ms(self, warm):
        _sync(self.torch, self.device)
        end = time.perf_counter()
        self.hook.remove()
        return (end - self.stamps[warm - 1]) / (len(self.stamps) - warm) * 1e3


def parallel_one_rank(torch, card, gather, spmm, g, dec, cfg):
    """24a: DistTrainer at mesh (1, 1) on NCCL in this process against
    LocalTrainer on the same seeds."""
    import tempfile

    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from graph_learn_tpu_torch.parallel import bootstrap
    from graph_learn_tpu_torch.parallel.mesh import make_mesh
    from graph_learn_tpu_torch.parallel.train import DistTrainer

    k1, k2 = cfg["fanout"]
    dev, on_card = cfg["device"], cfg["device"] == "cuda"
    q = _par_query(g, cfg)
    steps = PAR_WARM + PAR_STEPS
    where = tempfile.mkdtemp(prefix="glt_nccl_")
    check(bootstrap.init_cluster("file://" + os.path.join(where, "store"),
                                 1, 0, device=dev),
          "init_cluster did not start")
    try:
        import torch.distributed as dist
        check(dist.get_backend() == ("nccl" if on_card else "gloo"),
              "one rank a card: not NCCL")
        mesh = make_mesh(1, 1)
        model = _par_model(torch, dec, cfg)
        opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        clock = _StepClock(torch, dev, opt)
        gather.LAUNCHES.reset()
        spmm.LAUNCHES.reset()
        _, hist = DistTrainer(mesh, seed=0).train(
            q, model, _par_loss, opt, steps_per_epoch=steps, verbose=False,
            batch_transform=_pre_aggregate)
        step_ms = clock.step_ms(PAR_WARM)
        launches = {"gather_rows": gather.LAUNCHES.count / steps,
                    "segment_spmm": spmm.LAUNCHES.count / steps}
    finally:
        bootstrap.shutdown()
        shutil.rmtree(where, ignore_errors=True)
    ref = _par_model(torch, dec, cfg)
    _, ref_hist = LocalTrainer(seed=0, device=dev).train(
        q, ref, _par_loss, torch.optim.Adam(ref.parameters(),
                                            lr=LEARNING_RATE),
        steps_per_epoch=steps, verbose=False, batch_transform=_pre_aggregate)
    check(abs(hist[0] - ref_hist[0]) <= PAR_RTOL * abs(ref_hist[0]),
          "24a: DistTrainer (1, 1) mean loss %r, LocalTrainer %r"
          % (hist[0], ref_hist[0]))
    check(launches == ({"gather_rows": 2.0, "segment_spmm": 1.0} if on_card
                       else {"gather_rows": 0.0, "segment_spmm": 0.0}),
          "24a: launches a step %r, not 2 gather_rows + 1 segment_spmm"
          % launches)
    eps = cfg["batch"] * (k1 + k1 * k2) / (step_ms / 1e3)
    log("parallel (a) DistTrainer mesh (1, 1) on %s, one rank: %d + %d "
        "steps of batch %d, mean loss %.6f (LocalTrainer %.6f, same seeds), "
        "%.3f ms a step (host clock, card synchronised each step), %.0f "
        "edges/s, %s gather_rows + %s segment_spmm a step; card: %s"
        % ("NCCL" if on_card else "gloo", PAR_WARM, PAR_STEPS, cfg["batch"],
           hist[0], ref_hist[0], step_ms, eps, launches["gather_rows"],
           launches["segment_spmm"], card))
    return {"step_ms": step_ms, "edges_per_s": eps, "launches": launches}


def _same_bits(torch, a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def parallel_ranks(rank, world, card, cfg):
    """24b-e on each of two gloo ranks that share the card."""
    import torch

    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.core.sharding import (COLLECTIVES,
                                                     GRAPH_AXIS)
    from graph_learn_tpu_torch.examples import routing_bytes
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.gsl.compile import _execute
    from graph_learn_tpu_torch.ops.kernels import gather, spmm
    from graph_learn_tpu_torch.parallel.mesh import make_mesh
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables)
    from graph_learn_tpu_torch.parallel.train import (DistTrainer,
                                                      make_partitioned_plan)

    torch.backends.cuda.matmul.allow_tf32 = False
    gl.conf.feature_dtype = "bfloat16"
    dev, on_card = cfg["device"], cfg["device"] == "cuda"
    out = {}
    t0 = time.perf_counter()
    g, dec = bench.build_graph(cfg, dev)
    k1, k2 = cfg["fanout"]
    q = _par_query(g, cfg)
    m12, m21 = make_mesh(1, world), make_mesh(world, 1)
    out["build_s"] = time.perf_counter() - t0

    # (b) the partitioned store: this rank's block only, first on the card
    _sync(torch, dev)
    alloc = torch.cuda.memory_allocated if on_card else (lambda: 0)
    base = alloc()
    st = build_sharded_tables(q, world, shard=rank).place(m12)
    _sync(torch, dev)
    out["block_alloc"] = alloc() - base
    out["block_bytes"] = st.device_bytes()
    del st
    steps = PAR_WARM + PAR_PART_STEPS
    for routing in ("owner", "psum"):
        gl.conf.partition_routing = routing
        model = _par_model(torch, dec, cfg)
        opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        clock = _StepClock(torch, dev, opt)
        trainer = DistTrainer(m12, seed=0, partition_above_bytes=0)
        gather.LAUNCHES.reset()
        spmm.LAUNCHES.reset()
        COLLECTIVES.reset()
        _, hist = trainer.train(q, model, _par_loss, opt,
                                steps_per_epoch=steps, verbose=False)
        check(trainer.partitioned, "24b: the partitioned store was not used")
        out[routing] = dict(
            loss=hist[0], step_ms=clock.step_ms(PAR_WARM),
            graph_bytes=COLLECTIVES.total_bytes(GRAPH_AXIS) / steps,
            ops={op: [c / steps, b / steps] for op, (c, b)
                 in COLLECTIVES.by_op(GRAPH_AXIS).items()},
            gather=gather.LAUNCHES.count / steps,
            spmm=spmm.LAUNCHES.count / steps)
        del trainer, model
    gl.conf.partition_routing = "owner"
    # the ids and rows of three topk batches against the one-rank plan
    qt = _par_query(g, cfg, "topk")
    st = build_sharded_tables(qt, world, shard=rank).place(m12)
    plan = make_partitioned_plan(qt, m12, st)
    full = qt.device_tables(dev)
    out["store_bytes"] = nbytes(full)
    same = []
    for i in range(PAR_TOPK_BATCHES):
        seeds = (torch.arange(cfg["batch"], device=dev, dtype=torch.int32)
                 * 7 + i * 50_021) % cfg["n_nodes"]
        got = plan(seeds, torch.Generator(dev).manual_seed(i))
        want = _execute(qt, full, seeds, torch.Generator(dev).manual_seed(i))
        for a in ("src", "hop1", "hop2"):
            same.append(_same_bits(torch, got[a].ids, want[a].ids))
            same.append(_same_bits(torch, got[a].float_attrs,
                                   want[a].float_attrs.materialize()))
    out["topk_same"] = all(same)
    del plan, st, full

    # (c) data parallelism: the single-device plan on each data slice
    model = _par_model(torch, dec, cfg)
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    clock = _StepClock(torch, dev, opt)
    gather.LAUNCHES.reset()
    spmm.LAUNCHES.reset()
    steps = PAR_WARM + PAR_STEPS
    _, hist = DistTrainer(m21, seed=0).train(
        q, model, _par_loss, opt, steps_per_epoch=steps, verbose=False,
        batch_transform=_pre_aggregate)
    out["dp"] = dict(loss=hist[0], step_ms=clock.step_ms(PAR_WARM),
                     gather=gather.LAUNCHES.count / steps,
                     spmm=spmm.LAUNCHES.count / steps,
                     params=torch.cat([p.detach().reshape(-1)
                                       for p in model.parameters()]))
    del model

    # (d) ShardedGCN full-batch over the partitioned edges
    out["gcn"] = _parallel_gcn(torch, gather, spmm, g, m12, rank, world, cfg)
    # (e) examples/routing_bytes.py's rank function on these two ranks
    out["routing"] = routing_bytes.rank_bytes(rank, world)
    return out


def _dense_gcn(torch, model, feats, src, dst, labels):
    """The loss, the gradients of ShardedGCN's parameters and the first
    layer's pre-activations on one rank that holds the whole graph: each
    layer's mean over in-neighbours by ``index_add``, the mean
    cross-entropy over every node."""
    n = feats.shape[0]
    deg = torch.clamp(torch.bincount(dst, minlength=n), min=1)[:, None]
    h, pre = feats, None
    for i, layer in enumerate(model.dense):
        agg = torch.zeros_like(h).index_add(0, dst, h[src]) / deg.to(h.dtype)
        h = layer(torch.cat([h, agg], dim=-1))
        if i < len(model.dense) - 1:
            pre = h.detach()
            h = model.act(h)
    loss = torch.nn.functional.cross_entropy(h, labels)
    return (float(loss.detach()),
            torch.autograd.grad(loss, list(model.parameters())), pre)


def _grad_err(model, ref_grads):
    """The largest difference of each gradient from its reference, over
    the reference's largest entry."""
    return max(float((q.grad - r).abs().max() / r.abs().max())
               for q, r in zip(model.parameters(), ref_grads))


def _parallel_gcn(torch, gather, spmm, g, mesh, rank, world, cfg):
    """24d on one rank: the mean aggregation against a one-rank mean, the
    first step's summed gradients in float64 against a one-rank dense GCN
    in float64 (on rank 0), then PAR_GCN_STEPS float32 steps of
    ShardedGCN, the first step's loss against the dense one.  The float32
    gradients' difference from a float32 dense GCN's, and the hidden units
    on the other side of the ReLU in the two, are only reported.  Kernels
    1-2 are counted over every ``sharded_spmm`` and step of the case."""
    from graph_learn_tpu_torch.ops.segment import segment_sum
    from graph_learn_tpu_torch.parallel.full_graph import (
        ShardedGCN, gather_rows_over_graph, make_full_graph_train_step)
    from graph_learn_tpu_torch.parallel.halo import sharded_spmm
    from graph_learn_tpu_torch.parallel.partition import (partition_edges,
                                                          shard_features)

    et = g.store.edge_table("rel")
    nt = g.store.node_table("item")
    t0 = time.perf_counter()
    sg = partition_edges(et, world)
    part_s = time.perf_counter() - t0
    rows = sg.rows_per_shard
    feats = nt.float_attrs  # the host f32 table
    dev = cfg["device"]
    x = torch.as_tensor(shard_features(feats, world)[rank], device=dev)
    src = torch.as_tensor(et.src, device=dev).long()
    dst = torch.as_tensor(et.dst, device=dev).long()
    full = torch.as_tensor(feats, device=dev)
    n = nt.num_nodes
    labels = torch.as_tensor(np.pad(nt.labels, (0, world * rows - n))
                             .reshape(world, rows), device=dev).long()
    mask = torch.as_tensor(np.pad(np.ones(n, np.float32),
                                  (0, world * rows - n))
                           .reshape(world, rows), device=dev)
    torch.manual_seed(0)
    model = ShardedGCN(list(PAR_GCN_DIMS), sg, mesh, in_dim=cfg["feat_dim"],
                       device=dev)
    # the same parameters in float64, for the gradient check
    model64 = ShardedGCN(list(PAR_GCN_DIMS), sg, mesh,
                         in_dim=cfg["feat_dim"], device=dev).double()
    model64.load_state_dict(model.state_dict())
    dense64 = dense32 = None
    if rank == 0:  # no collective inside: the other rank does not wait
        all_labels = torch.as_tensor(nt.labels, device=dev).long()
        dense64 = _dense_gcn(torch, model64, full.double(), src, dst,
                             all_labels)
        dense32 = _dense_gcn(torch, model, full, src, dst, all_labels)

    def loss_fn(logits, lab, msk):
        ls = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), lab.reshape(-1),
            reduction="none")
        m = msk.reshape(-1)
        return (ls * m).sum() / m.sum()

    step = make_full_graph_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LEARNING_RATE), mesh,
        loss_fn)
    _sync(torch, dev)
    gather.LAUNCHES.reset()
    spmm.LAUNCHES.reset()
    agg = sharded_spmm(sg, x, mesh, agg="mean")
    # one rank's mean over the whole table: this rank's dst rows
    lo = rank * rows
    mine = (dst >= lo) & (dst < lo + rows)
    ref = segment_sum(full[src[mine]], (dst[mine] - lo), rows)
    deg = torch.bincount(dst[mine] - lo, minlength=rows)
    ref = ref / torch.clamp(deg, min=1).to(ref.dtype)[:, None]
    err = float(((agg - ref).abs() - PAR_RTOL * ref.abs()).max())
    # the first layer's pre-activations of every row, for the record
    with torch.no_grad():
        pre = gather_rows_over_graph(model.dense[0](torch.cat(
            [x, sharded_spmm(sg, x, mesh, agg="mean")], dim=-1)), mesh)
    # the first step's summed gradients in float64, through the same step
    # with a rate of 0, against the dense ones
    make_full_graph_train_step(
        model64, torch.optim.SGD(model64.parameters(), lr=0.0), mesh,
        loss_fn)(x.double(), labels, mask.double())
    losses = [float(step(x, labels, mask))]  # warm
    ref_loss = grad_err = grad_err32 = flips = None
    if rank == 0:
        ref_loss, grad_err = dense64[0], _grad_err(model64, dense64[1])
        grad_err32 = _grad_err(model, dense32[1])
        flips = int(((pre.reshape(-1, pre.shape[-1])[:n] > 0)
                     != (dense32[2] > 0)).sum())
    del model64, dense64, dense32, pre
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(PAR_GCN_STEPS - 1):
        losses.append(step(x, labels, mask))
    losses = [float(v) for v in losses]
    _sync(torch, dev)
    step_ms = (time.perf_counter() - t0) / (PAR_GCN_STEPS - 1) * 1e3
    # sharded_spmm calls: the mean, the pre-activations, the float64 step
    # and the steps
    calls = 2 + (1 + PAR_GCN_STEPS) * len(PAR_GCN_DIMS)
    return dict(losses=losses, step_ms=step_ms,
                halo_rows=int(sg.recv_offsets[rank, -1]),
                halo_max=sg.halo_max, rows=rows, partition_s=part_s,
                mean_excess=err, ref_loss=ref_loss,
                grad_err=grad_err, grad_err32=grad_err32, flips=flips,
                units=n * PAR_GCN_DIMS[0],
                gather=gather.LAUNCHES.count / calls,
                spmm=spmm.LAUNCHES.count / calls)


def parallel_path(torch, card, gather, spmm, cfg=None):
    """24: the parallel store and training; returns the kernels line's
    fields of phase 24.  ``cfg`` (default ``PAR_CFG``) sets the store,
    the step and the device, so that the phase rehearses small on the
    CPU, where no kernel launches."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import routing_bytes
    from graph_learn_tpu_torch.parallel.launch import spawn

    cfg = dict(PAR_CFG, **(cfg or {}))
    dev, on_card = cfg["device"], cfg["device"] == "cuda"
    t_phase = time.perf_counter()
    k1, k2 = cfg["fanout"]
    g, dec = bench.build_graph(cfg, dev)
    a = parallel_one_rank(torch, card, gather, spmm, g, dec, cfg)
    del g, dec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r0, r1 = spawn(parallel_ranks, 2, device=dev, backend="gloo",
                   args=(card, cfg), timeout_s=PARALLEL_TIMEOUT_S,
                   threads=None if on_card else 2)
    spawn_s = time.perf_counter() - t0
    edges = cfg["batch"] * (k1 + k1 * k2)
    # (b)
    for r in (r0, r1):
        check(r["topk_same"], "24b: a topk batch of the partitioned plan is "
              "not the one-rank plan's, bit for bit")
        for routing in ("owner", "psum"):
            b = r[routing]
            check(math.isfinite(b["loss"]), "24b: %s loss %r"
                  % (routing, b["loss"]))
            check(b["gather"] > 0 or not on_card, "24b: gather_rows never "
                  "launched in %s routing" % routing)
        check(r["block_bytes"] < r["store_bytes"],
              "24b: a block of %d bytes for a store of %d"
              % (r["block_bytes"], r["store_bytes"]))
    check(r0["owner"]["ops"] == r1["owner"]["ops"]
          and r0["psum"]["ops"] == r1["psum"]["ops"],
          "24b: the ranks counted different collectives")
    for routing in ("owner", "psum"):
        b = r0[routing]
        log("parallel (b) DistTrainer mesh (1, 2), partitioned store, %s "
            "routing: %d + %d steps of batch %d, mean loss %.6f / %.6f "
            "(ranks 0 / 1), %.1f / %.1f ms a step (%.0f edges/s), %.2f MB "
            "over the graph axis a step and rank (%s), %s gather_rows + %s "
            "segment_spmm a step; %s; card: %s"
            % (routing, PAR_WARM, PAR_PART_STEPS, cfg["batch"], b["loss"],
               r1[routing]["loss"], b["step_ms"], r1[routing]["step_ms"],
               edges / (b["step_ms"] / 1e3), b["graph_bytes"] / 1e6,
               ", ".join("%s x%g %.2f MB" % (op, c, by / 1e6)
                         for op, (c, by) in sorted(b["ops"].items())),
               b["gather"], b["spmm"], SHARED_CARD, card))
    log("parallel (b) device bytes: rank 0 / 1 hold %d / %d bytes of the "
        "store's block (%d / %d allocated by the placement) against %d for "
        "one rank's whole store; %d topk batches bit-equal to the one-rank "
        "plan (ids and feature rows of src, hop1, hop2); the store drawn "
        "in %.1f / %.1f s on each rank's host; card: %s"
        % (r0["block_bytes"], r1["block_bytes"], r0["block_alloc"],
           r1["block_alloc"], r0["store_bytes"], PAR_TOPK_BATCHES,
           r0["build_s"], r1["build_s"], card))
    # (c)
    check(torch.equal(r0["dp"]["params"], r1["dp"]["params"]),
          "24c: the two data-parallel ranks' parameters differ")
    want = (2.0, 1.0) if on_card else (0.0, 0.0)
    for r in (r0, r1):
        check((r["dp"]["gather"], r["dp"]["spmm"]) == want,
              "24c: %s gather_rows + %s segment_spmm a step, not 2 + 1"
              % (r["dp"]["gather"], r["dp"]["spmm"]))
    dp_ms = max(r0["dp"]["step_ms"], r1["dp"]["step_ms"])
    log("parallel (c) DistTrainer mesh (2, 1), data-parallel: %d + %d steps "
        "of batch %d (%d a rank), mean loss %.6f / %.6f, %.1f / %.1f ms a "
        "step (%.0f edges/s over both), %s gather_rows + %s segment_spmm a "
        "step on each rank, parameters bit-equal on both ranks after the "
        "steps; %s; card: %s"
        % (PAR_WARM, PAR_STEPS, cfg["batch"], cfg["batch"] // 2,
           r0["dp"]["loss"], r1["dp"]["loss"], r0["dp"]["step_ms"],
           r1["dp"]["step_ms"], edges / (dp_ms / 1e3), r0["dp"]["gather"],
           r0["dp"]["spmm"], SHARED_CARD, card))
    # (d)
    for r in (r0, r1):
        gcn = r["gcn"]
        check(gcn["mean_excess"] <= 1e-6, "24d: sharded_spmm's mean is off "
              "the one-rank mean by %g past rtol 1e-5" % gcn["mean_excess"])
        check(all(math.isfinite(v) for v in gcn["losses"])
              and gcn["losses"][-1] < gcn["losses"][0],
              "24d: ShardedGCN losses %r" % gcn["losses"])
        check(gcn["gather"] == 0 and gcn["spmm"] == 0,
              "24d: %s gather_rows + %s segment_spmm a sharded_spmm, not 0 "
              "(the halo path aggregates in plain torch)"
              % (gcn["gather"], gcn["spmm"]))
    check(r0["gcn"]["losses"] == r1["gcn"]["losses"],
          "24d: the ranks' losses differ")
    gcn = r0["gcn"]
    check(abs(gcn["losses"][0] - gcn["ref_loss"])
          <= PAR_RTOL * abs(gcn["ref_loss"])
          and gcn["grad_err"] <= PAR_GRAD_RTOL,
          "24d: the first step's loss %r against the one-rank dense GCN's "
          "%r (float64); its summed gradients in float64 off the dense "
          "ones by %r of their largest entry (tolerance %g)" % (gcn["losses"][0], gcn["ref_loss"],
                                            gcn["grad_err"], PAR_GRAD_RTOL))
    log("parallel (d) ShardedGCN %s full-batch over mesh (1, 2): "
        "sharded_spmm mean equal to the one-rank mean within rtol 1e-5; "
        "the first step's loss within rtol 1e-5 of a one-rank dense GCN's "
        "(%.6f, float64) and its summed gradients in float64 off the dense "
        "ones by %.3g of their largest entry (tolerance %g; in float32, "
        "not checked, %.3g, with %d of %d first-layer units on the other "
        "side of the ReLU from the float32 dense GCN's); losses %s; %.1f / %.1f ms a "
        "step; each rank owns %d rows and receives %d / %d halo rows a "
        "layer (partition_edges %.1f s on the host); %s gather_rows + %s "
        "segment_spmm a sharded_spmm; %s; card: %s"
        % (list(PAR_GCN_DIMS), gcn["ref_loss"], gcn["grad_err"],
           PAR_GRAD_RTOL, gcn["grad_err32"], gcn["flips"], gcn["units"],
           ["%.4f" % v for v in gcn["losses"]],
           gcn["step_ms"], r1["gcn"]["step_ms"], gcn["rows"],
           gcn["halo_rows"], r1["gcn"]["halo_rows"], gcn["partition_s"],
           gcn["gather"], gcn["spmm"], SHARED_CARD, card))
    # (e)
    check(r0["routing"]["psum"]["ops"] == r1["routing"]["psum"]["ops"]
          and r0["routing"]["owner"]["ops"] == r1["routing"]["owner"]["ops"],
          "24e: the ranks counted different collectives")
    for routing in ("psum", "owner"):
        rr = r0["routing"][routing]
        log("parallel (e) routing_bytes, batch %d fan-out %d D %d, 2 graph "
            "shards, %s: %s, total %.1f KiB a step and rank, %.2f ms a "
            "plan; %s; card: %s"
            % (routing_bytes.BATCH, routing_bytes.FANOUT,
               routing_bytes.WIDTH, routing,
               ", ".join("%s x%g %.1f KiB" % (op, c, by / 1024)
                         for op, (c, by) in sorted(rr["ops"].items())),
               sum(v[1] for v in rr["ops"].values()) / 1024, rr["step_ms"],
               SHARED_CARD, card))
    took = time.perf_counter() - t_phase
    log("phase 24 (parallel) in %.1f s (the two ranks %.1f s of it)"
        % (took, spawn_s))
    return {
        "gather_rows": {
            "parallel_nccl_launches_per_step": a["launches"]["gather_rows"],
            "parallel_nccl_ms_step": a["step_ms"],
            "parallel_nccl_edges_per_s": a["edges_per_s"],
            "parallel_owner_launches_per_step": r0["owner"]["gather"],
            "parallel_psum_launches_per_step": r0["psum"]["gather"],
            "parallel_owner_ms_step_shared_card": r0["owner"]["step_ms"],
            "parallel_psum_ms_step_shared_card": r0["psum"]["step_ms"],
            "parallel_owner_graph_bytes_per_step": r0["owner"]["graph_bytes"],
            "parallel_psum_graph_bytes_per_step": r0["psum"]["graph_bytes"],
            "parallel_dp_launches_per_step": r0["dp"]["gather"],
            "parallel_dp_ms_step_shared_card": dp_ms,
            "parallel_halo_launches_per_spmm": r0["gcn"]["gather"]},
        "segment_spmm": {
            "parallel_nccl_launches_per_step": a["launches"]["segment_spmm"],
            "parallel_dp_launches_per_step": r0["dp"]["spmm"],
            "parallel_halo_launches_per_spmm": r0["gcn"]["spmm"]}}


# ---------------------------------------------------------------------------
# Phase 25: partitioned serving and the sharded k-NN index across ranks
# ---------------------------------------------------------------------------

# (a): one caller's request sizes (1-2 micro-batches each) and how many of
# them (c) replays over HTTP
PSERVE_SIZES = (1, 3, 7, 1_024, 1_500, 64, 2_047, 300)
PSERVE_REPLAY = 3
PSERVE_TOPK_BATCH = 64  # micro-batch of the topk queries of (a) and (b)
PSERVE_POOL = 64  # (b): the callers' ids, plus each batch's probe source
PSERVE_PROBES = 3  # (b): heavy edges of the last, probe-only refresh
# (c): a feature of the worker's TSV store against the in-memory f32 row:
# five decimals, read back as f32
PSERVE_TEXT_TOL = 6e-6
PSERVE_TIMEOUT_S = 600
PSERVE_CFG = dict(n_nodes=N_NODES, avg_degree=AVG_DEGREE, feat_dim=FEAT_DIM,
                  classes=CLASSES, batch=MICRO_BATCH, fanout=FANOUT,
                  device="cuda", sizes=PSERVE_SIZES,
                  clients=ONLINE_CLIENTS, requests=ONLINE_REQUESTS,
                  max_ids=ONLINE_MAX_IDS, edge_batches=ONLINE_EDGE_BATCHES,
                  edge_batch=ONLINE_EDGE_BATCH,
                  knn=dict(base=KNN_BASE, queries=KNN_QUERIES,
                           check=KNN_CHECK_QUERIES, nlist=KNN_NLIST,
                           nprobe=KNN_NPROBE, k=KNN_K))


def _topk_query(g, cfg, k, alias="top"):
    return (g.V("item").batch(cfg["batch"]).alias("src")
            .outV("rel").sample(k).by("topk").alias(alias).values())


def _pserve_a(torch, g, svc, cfg):
    """25a on the leader: the fixed request sequence against a one-rank
    service on the same store, each round timed; closes the partitioned
    service."""
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.online.serving import QueryService
    from graph_learn_tpu_torch.ops.kernels import gather

    dev, n, mb = cfg["device"], cfg["n_nodes"], cfg["batch"]
    one = QueryService(g, device=dev)
    qid = svc.install(_par_query(g, cfg), micro_batch=mb)
    oid = one.install(_par_query(g, cfg), micro_batch=mb)
    iq = svc._queries[qid]
    launch, round_ms = iq._launch, []

    def timed_launch(snap, chunk):
        t0 = time.perf_counter()
        out = launch(snap, chunk)
        _sync(torch, dev)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    iq._launch = timed_launch
    rng = np.random.default_rng(25)
    reqs = [rng.integers(0, n, s) for s in cfg["sizes"]]
    # a warm request on both services (the same draws on both)
    warm = [rng.integers(0, n, 1)]
    _sync(torch, dev)
    gather.LAUNCHES.reset()  # over every round, as the follower counts
    t0 = time.perf_counter()
    svc.run(qid, warm[0])
    warm_ms = (time.perf_counter() - t0) * 1e3
    one.run(oid, warm[0])
    del round_ms[:]
    got = [svc.run(qid, ids) for ids in reqs]
    launches = gather.LAUNCHES.count
    same, replay = [], []
    nt = g.store.node_table("item")
    for i, (ids, a) in enumerate(zip(reqs, got)):
        b = one.run(oid, ids)
        for alias in ("src", "hop1", "hop2"):
            same.append(_same_bits(torch, a[alias].ids, b[alias].ids))
            same.append(_same_bits(torch, a[alias].float_attrs,
                                   b[alias].float_attrs.materialize()))
        if i < PSERVE_REPLAY:
            ans = {alias: a[alias].ids.cpu().numpy()
                   for alias in ("src", "hop1", "hop2")}
            replay.append(dict(ids=ids, ans=ans, rows={
                alias: nt.float_attrs[v.reshape(-1)]
                for alias, v in ans.items()}))
    out = dict(same=all(same), compared=len(same), rounds=len(round_ms),
               launches=launches, round_ms=round_ms, warm_ms=warm_ms,
               warm=warm, replay=replay,
               block=iq._snap.tables.device_bytes(),
               store=nbytes(one._queries[oid]._snap.tables))
    svc.close()
    one.close()
    return out


def _pserve_topk(torch, g, svc, cfg):
    """25a on the leader: a topk query from concurrent callers, each
    answer held to a one-rank service's; closes the partitioned
    service."""
    from graph_learn_tpu_torch.online.serving import QueryService

    dev, n, k1 = cfg["device"], cfg["n_nodes"], cfg["fanout"][0]
    one = QueryService(g, device=dev)
    tq = svc.install(_topk_query(g, cfg, k1), micro_batch=PSERVE_TOPK_BATCH)
    ot = one.install(_topk_query(g, cfg, k1), micro_batch=PSERVE_TOPK_BATCH)
    records, errors = [], []

    def caller(c):
        r = np.random.default_rng(250 + c)
        try:
            for _ in range(cfg["requests"]):
                ids = r.integers(0, n, int(r.integers(1, cfg["max_ids"] + 1)))
                records.append((ids, svc.run(tq, ids)["top"].ids.cpu()))
        except Exception as e:  # reported below; fails the phase
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(c,))
               for c in range(cfg["clients"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=PSERVE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          "25a: a topk caller failed: %r" % (errors[:1],))
    out = dict(same=all(torch.equal(ans, one.run(ot, ids)["top"].ids.cpu())
                        for ids, ans in records),
               requests=len(records), wall=wall, stats=svc.stats(tq))
    svc.close()
    one.close()
    return out


def _pserve_b(torch, g, svc, cfg):
    """25b on the leader: callers on a topk query while streamed edge
    batches are applied and refreshed, each answer held to the oracle of a
    snapshot live during it; then a probe-only refresh."""
    from graph_learn_tpu_torch.online.serving import QueryService
    from graph_learn_tpu_torch.online.update import (UpdateBuffer,
                                                     apply_updates)

    dev, n = cfg["device"], cfg["n_nodes"]
    k1 = cfg["fanout"][0]
    one = QueryService(g, device=dev)
    tq = svc.install(_topk_query(g, cfg, k1), micro_batch=PSERVE_TOPK_BATCH)
    pq = svc.install(_topk_query(g, dict(cfg, batch=1), k1), micro_batch=16)
    ot = one.install(_topk_query(g, cfg, k1), micro_batch=PSERVE_TOPK_BATCH)
    full = svc._queries[tq].last_refresh_upload_bytes
    rng = np.random.default_rng(26)
    batches = []
    for b in range(cfg["edge_batches"]):
        m = cfg["edge_batch"]
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        w = rng.random(m).astype(np.float32)
        w[0] = ONLINE_PROBE_WEIGHT + b  # the probe: its source's heaviest
        batches.append((src, dst, w))
    probe_src = int(rng.integers(0, n))
    probe_dst = rng.integers(0, n, PSERVE_PROBES)
    batches.append((np.full(PSERVE_PROBES, probe_src), probe_dst,
                    (2 * ONLINE_PROBE_WEIGHT + np.arange(PSERVE_PROBES)[::-1])
                    .astype(np.float32)))
    pool = np.concatenate([rng.integers(0, n, PSERVE_POOL),
                           [int(s[0]) for s, _, _ in batches]])
    oracle = [one.run(ot, pool)["top"].ids.cpu()]
    records, errors, stop = [], [], threading.Event()

    def caller(c):
        r = np.random.default_rng(260 + c)
        try:
            while not stop.is_set():
                at = r.integers(0, pool.size,
                                int(r.integers(1, cfg["max_ids"] + 1)))
                t0 = time.perf_counter()
                ans = svc.run(tq, pool[at])["top"].ids.cpu()
                records.append((t0, time.perf_counter(), at, ans))
                time.sleep(ONLINE_THINK_S)
        except Exception as e:  # reported below; fails the phase
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(c,))
               for c in range(cfg["clients"])]
    for t in threads:
        t.start()
    spans, uploads, probes = [], [], []
    try:
        for src, dst, w in batches:
            buf = UpdateBuffer()
            buf.add_edges("rel", src_ids=src, dst_ids=dst, weights=w)
            apply_updates(g, buf)
            t0 = time.perf_counter()
            svc.refresh()
            spans.append((t0, time.perf_counter()))
            uploads.append(svc._queries[tq].last_refresh_upload_bytes)
            one.refresh()
            oracle.append(one.run(ot, pool)["top"].ids.cpu())
            top = svc.run(pq, [int(src[0])])["top"].ids.cpu()
            probes.append(int(top[0, 0]) == int(dst[np.argmax(w)]))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=PSERVE_TIMEOUT_S)
    check(not errors and not any(t.is_alive() for t in threads),
          "25b: a caller failed: %r" % (errors[:1],))
    ends = np.array([e for _, e in spans])
    starts = np.array([s for s, _ in spans])
    wrong = 0
    for t0, t1, at, ans in records:
        lo = int(np.searchsorted(ends, t0))  # refreshes ended before it
        hi = int(np.searchsorted(starts, t1))  # refreshes begun before its end
        if not any(torch.equal(ans, oracle[s][at]) for s in range(lo, hi + 1)):
            wrong += 1
    out = dict(full=full, uploads=uploads, probes=probes, wrong=wrong,
               answers=len(records), refresh_s=[e - s for s, e in spans],
               stats=svc.stats(tq), edges=[s.size for s, _, _ in batches])
    svc.close()
    one.close()
    return out


def _pserve_knn(torch, rank, world, cfg):
    """25d on each rank: the k-NN data of phase 20c drawn on this rank,
    each configuration built once (trained on rank 0) and sharded over the
    ranks; rank 0 holds the check queries' answers to its one-rank
    index."""
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.ops import knn
    from graph_learn_tpu_torch.parallel.mesh import make_mesh

    kc, dev = cfg["knn"], cfg["device"]
    mesh = make_mesh(1, world)
    gen = torch.Generator(device=dev).manual_seed(KNN_SEED)
    centres = KNN_SPREAD * torch.randn((KNN_CENTRES, KNN_DIM), generator=gen,
                                       device=dev)
    base = centres[torch.randint(0, KNN_CENTRES, (kc["base"],),
                                 generator=gen, device=dev)]
    base += torch.randn(base.shape, generator=gen, device=dev)
    picks = torch.randperm(kc["base"], generator=gen, device=dev)[
        :kc["queries"]]
    queries = base[picks] + KNN_NOISE * torch.randn(
        (kc["queries"], KNN_DIM), generator=gen, device=dev)
    data, q = base.cpu().numpy(), queries.cpu().numpy()
    del centres, base, queries
    ids = np.arange(kc["base"])
    out = {}
    for kind, metric in KNN_CONFIGS:
        what = "%s/%s" % (kind, "L2" if metric == 0 else "ip")
        opt = gl.KnnOption(k=kc["k"], index_type=kind, nlist=kc["nlist"],
                           nprobe=kc["nprobe"], metric=metric)
        t0 = time.perf_counter()
        index = knn.build_index(data, ids, opt, device=dev, mesh=mesh)
        sharded = knn.shard_index(index, mesh)
        _sync(torch, dev)
        build_s = time.perf_counter() - t0
        sharded.search(q[:kc["check"]], kc["k"])  # warm
        _sync(torch, dev)
        t0 = time.perf_counter()
        got_ids, got_dist = sharded.search(q, kc["k"])
        wall = time.perf_counter() - t0
        row = dict(build_s=build_s, train_s=index.train_s,
                   ms_per_10k=wall * 1e3 * 10_000 / kc["queries"],
                   block_bytes=sum(x.numel() * x.element_size()
                                   for x in sharded.block.values()))
        if rank == 0:
            want_ids, want_dist = index.search(q[:kc["check"]], kc["k"])
            fin = np.isfinite(want_dist)
            scale = np.max(np.where(fin, np.abs(want_dist), 0), axis=1,
                           keepdims=True)
            err = np.where(fin, np.abs(got_dist[:kc["check"]] - want_dist), 0)
            row.update(
                ids_equal=bool(np.array_equal(got_ids[:kc["check"]],
                                              want_ids)),
                dist_ok=bool((np.isfinite(got_dist[:kc["check"]]) == fin)
                             .all() and (err <= KNN_DIST_RTOL * scale).all()),
                dist_err=float((err / np.maximum(scale, 1e-30)).max()))
        out[what] = row
        del index, sharded
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def partitioned_ranks(rank, world, card, cfg):
    """25a, 25b and 25d on each of two gloo ranks that share the card."""
    import torch

    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.online.serving import QueryService
    from graph_learn_tpu_torch.ops.kernels import gather, spmm

    torch.backends.cuda.matmul.allow_tf32 = False
    gl.conf.feature_dtype = "bfloat16"
    gl.conf.storage_profile = "minimal"
    dev = cfg["device"]
    t0 = time.perf_counter()
    g, _ = bench.build_graph(cfg, dev)
    out = {"build_s": time.perf_counter() - t0}
    # (a) and (b), each part on a partitioned service of its own
    for part, fn in (("a", _pserve_a), ("topk", _pserve_topk),
                     ("b", _pserve_b)):
        svc = QueryService(g, device=dev, graph_shards=world)
        if rank == 0:
            spmm.LAUNCHES.reset()
            out[part] = fn(torch, g, svc, cfg)
            out[part]["spmm"] = spmm.LAUNCHES.count
        else:
            gather.LAUNCHES.reset()
            svc.follow()
            out[part] = dict(gather=gather.LAUNCHES.count, block=(
                svc._followed[0].tables.device_bytes()))
    out["knn"] = _pserve_knn(torch, rank, world, cfg)
    return out


def _pserve_http(torch, card, cfg, files, warm, replay):
    """25c: serve_main with graph_shards 2 over gloo in a worker process
    from phase 22's files; (a)'s first requests replayed over HTTP; SIGTERM
    ends both ranks."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    dev = cfg["device"]
    conf_path = os.path.join(files, "pserve.json")
    node_dec = {"labeled": True, "attr_types": ["float"] * cfg["feat_dim"]}
    with open(conf_path, "w") as f:
        json.dump({"host": "127.0.0.1", "port": 0, "device": dev,
                   "graph_shards": 2, "backend": "gloo",
                   "nodes": [{"source": os.path.join(files, "nodes"),
                              "type": "item", "decoder": node_dec}],
                   "edges": [{"source": os.path.join(files, "edges"),
                              "type": ["item", "item", "rel"],
                              "decoder": {"weighted": True}}]}, f)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "graph_learn_tpu_torch.online.serve_main",
         "--config", conf_path], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: [lines.append(x) for x in proc.stdout], daemon=True)
    reader.start()
    try:
        while not any("[serve] listening" in x for x in lines):
            check(proc.poll() is None and time.perf_counter() - t0
                  < PSERVE_TIMEOUT_S, "25c: the worker did not start: %s"
                  % "".join(lines[-30:]))
            time.sleep(0.05)
        up_s = time.perf_counter() - t0
        line = next(x for x in lines if "[serve] listening" in x)
        port = int(line.split(":")[1].split()[0])
        pids = json.loads(line.split("pids ")[1].rstrip(")\n"))
        cg = load_gsl_client(root).Graph("127.0.0.1", port, timeout=600.0)
        k1, k2 = cfg["fanout"]
        qid = cg.install(cg.V("item").batch(cfg["batch"]).alias("src")
                         .outV("rel").sample(k1).by("random").alias("hop1")
                         .outV("rel").sample(k2).by("random").alias("hop2"),
                         micro_batch=cfg["batch"])
        t1 = time.perf_counter()
        for ids in warm:  # (a)'s warm request, for the same draws after
            cg.run(qid, ids.tolist())
        warm_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        same_ids, row_err = True, 0.0
        for r in replay:
            ans = cg.run(qid, r["ids"].tolist())
            for alias, want in r["ans"].items():
                got = np.asarray(ans[alias]["ids"])
                same_ids &= got.shape == want.shape and bool(
                    (got == want).all())
                rows = np.asarray(ans[alias]["float_attrs"],
                                  np.float64).reshape(r["rows"][alias].shape)
                row_err = max(row_err, float(np.abs(
                    rows - r["rows"][alias]).max()))
        serve_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        stop_s = time.perf_counter() - t2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    check(rc == 0 and not alive, "25c: the worker exited %s with ranks %s "
          "alive: %s" % (rc, alive, "".join(lines[-30:])))
    check(same_ids, "25c: the worker's answers' ids differ from (a)'s")
    check(row_err <= PSERVE_TEXT_TOL, "25c: the worker's rows differ from the "
          "store's by %g, over the TSV's %g" % (row_err, PSERVE_TEXT_TOL))
    log("partitioned (c) serve_main with graph_shards 2 over gloo from phase "
        "22's TSV files, in a worker process: up in %.1f s (both ranks built "
        "the graph; rank 0 started rank 1, pid %s), the random 2-hop query "
        "installed over HTTP and (a)'s warm request sent (%.1f s), (a)'s "
        "first %d requests (%s ids) answered with (a)'s ids bit for bit "
        "and the store's rows within %.1e (the TSV's five decimals; the "
        "worker keeps f32 features) in %.3f s; SIGTERM ended both ranks in "
        "%.1f s (exit %d); %s; card: %s"
        % (up_s, pids, warm_s, len(replay), [r["ids"].size for r in replay],
           row_err, serve_s, stop_s, rc, SHARED_CARD, card))


def partitioned_path(torch, card, gather, spmm, files, cfg=None):
    """25: partitioned serving and the sharded k-NN index (module note,
    phase 25); ``files`` is the directory of phase 22's TSV store.
    ``cfg`` (default ``PSERVE_CFG``) sets the sizes and the device, so
    that the phase rehearses small on the CPU, where no kernel launches.
    Returns the kernels line's fields of phase 25."""
    from graph_learn_tpu_torch.parallel.launch import spawn

    cfg = dict(PSERVE_CFG, **(cfg or {}))
    dev, on_card = cfg["device"], cfg["device"] == "cuda"
    t_phase = time.perf_counter()
    r0, r1 = spawn(partitioned_ranks, 2, device=dev, backend="gloo",
                   args=(card, cfg), timeout_s=PSERVE_TIMEOUT_S,
                   threads=None if on_card else 2)
    spawn_s = time.perf_counter() - t_phase
    a, b, topk = r0["a"], r0["b"], r0["topk"]
    # (a)
    check(a["same"], "25a: the partitioned service's answers are not the "
          "one-rank service's, bit for bit")
    check(topk["same"], "25a: a concurrent topk caller's answer is not "
          "the one-rank answer")
    check(a["rounds"] == sum(-(-s // cfg["batch"]) for s in cfg["sizes"]),
          "25a: %d rounds for requests of %s ids at micro-batch %d"
          % (a["rounds"], list(cfg["sizes"]), cfg["batch"]))
    # over the warm round and the sequence's, on both ranks
    per_round = (a["launches"] / (a["rounds"] + 1),
                 r1["a"]["gather"] / (a["rounds"] + 1))
    check(min(per_round) > 0 if on_card else per_round == (0.0, 0.0),
          "25a: gather_rows launches a round %r on ranks 0 / 1"
          % (per_round,))
    check(a["spmm"] == 0, "25a: segment_spmm launched %d times by the "
          "partitioned rounds" % a["spmm"])
    check(max(a["block"], r1["a"]["block"]) < a["store"],
          "25a: a block of %d / %d bytes for a store of %d"
          % (a["block"], r1["a"]["block"], a["store"]))
    rms = np.array(a["round_ms"])
    log("partitioned (a) QueryService(graph_shards=2) at mesh (1, 2), the "
        "random 2-hop [%d, %d] query at micro-batch %d on the %d-node "
        "store (bf16, \"minimal\"): %d requests of %s ids (%d rounds) from "
        "one caller after a warm request of 1 id (%.1f ms), ids and feature "
        "rows of src, hop1, hop2 bit-equal to a one-rank QueryService on "
        "the same store (%d tensors); round wall p50 %.1f ms, p99 %.1f ms "
        "(rank 0's host clock, synchronised; rounds %s ms); gather_rows "
        "%.1f / %.1f a round on ranks 0 / 1 (the owners' row gathers), "
        "segment_spmm 0; each rank holds %d / %d device bytes against %d "
        "for one rank's whole store; the store drawn in %.1f / %.1f s on "
        "each rank's host; %s; card: %s"
        % (cfg["fanout"][0], cfg["fanout"][1], cfg["batch"], cfg["n_nodes"],
           len(cfg["sizes"]), list(cfg["sizes"]), a["rounds"], a["warm_ms"],
           a["compared"], np.percentile(rms, 50), np.percentile(rms, 99),
           [float(round(x, 1)) for x in rms], per_round[0], per_round[1],
           a["block"], r1["a"]["block"], a["store"], r0["build_s"],
           r1["build_s"], SHARED_CARD, card))
    log("partitioned (a) topk [%d] from %d concurrent callers (%d requests "
        "of 1..%d ids, micro-batch %d): every answer the one-rank answer; "
        "p50 %.1f ms, p99 %.1f ms, %.1f requests/s; %s; card: %s"
        % (cfg["fanout"][0], cfg["clients"], topk["requests"],
           cfg["max_ids"], PSERVE_TOPK_BATCH, topk["stats"]["p50_ms"],
           topk["stats"]["p99_ms"], topk["requests"] / topk["wall"],
           SHARED_CARD, card))
    # (b)
    check(b["wrong"] == 0 and b["answers"] > 0, "25b: %d of %d answers equal "
          "no live snapshot's oracle" % (b["wrong"], b["answers"]))
    check(all(b["probes"]), "25b: a probe edge does not lead the topk "
          "answer after its refresh: %r" % b["probes"])
    shares = [u / b["full"] for u in b["uploads"]]
    check(all(s < 1.0 for s in shares[:-1]) and shares[-1] <= 0.5,
          "25b: refresh uploads %r of the full upload (the streamed batches "
          "under 1, the probe-only refresh at most 1/2)" % shares)
    log("partitioned (b) %d callers on topk while %d batches of %s edges "
        "(each with a heavy probe edge) and one of %d probe edges were "
        "applied and refreshed: %d answers, each equal to the one-rank "
        "oracle of a snapshot live during it; every probe led its source's "
        "topk after its refresh; refresh %s s; summed upload over the ranks "
        "%s bytes, %s of the first full upload of %d (the streamed batches "
        "move every edge-payload block: its rows per shard grow with the "
        "edge count); caller p99 %.1f ms; %s; card: %s"
        % (cfg["clients"], cfg["edge_batches"], cfg["edge_batch"],
           PSERVE_PROBES, b["answers"],
           [round(x, 3) for x in b["refresh_s"]], b["uploads"],
           [round(x, 3) for x in shares], b["full"], b["stats"]["p99_ms"],
           SHARED_CARD, card))
    # (c)
    _pserve_http(torch, card, cfg, files, a["warm"], a["replay"])
    # (d)
    kc = cfg["knn"]
    for what, row in r0["knn"].items():
        check(row["ids_equal"] and row["dist_ok"], "25d: k-NN %s over two "
              "ranks: ids equal %s, distances off by %g of the row's largest"
              % (what, row["ids_equal"], row["dist_err"]))
        log("partitioned (d) k-NN %s, %d x %d f32 over 2 ranks (k %d%s): %d "
            "check queries' ids equal to the one-rank index and distances "
            "within %g of the row's largest (%.2e); built and sharded in "
            "%.2f / %.2f s (train %.2f s on rank 0); %.1f / %.1f ms per "
            "10 000 queries; a rank's block %d / %d bytes; %s; card: %s"
            % (what, kc["base"], KNN_DIM, kc["k"],
               "" if what.startswith("flat") else ", nlist %d, nprobe %d"
               % (kc["nlist"], kc["nprobe"]), kc["check"], KNN_DIST_RTOL,
               row["dist_err"], row["build_s"], r1["knn"][what]["build_s"],
               row["train_s"], row["ms_per_10k"],
               r1["knn"][what]["ms_per_10k"], row["block_bytes"],
               r1["knn"][what]["block_bytes"], SHARED_CARD, card))
    log("phase 25 (partitioned serving) in %.1f s (the two ranks %.1f s of "
        "it)" % (time.perf_counter() - t_phase, spawn_s))
    return {"gather_rows": {"pserve_launches_per_round": per_round[0],
                            "pserve_follower_launches_per_round":
                                per_round[1]},
            "segment_spmm": {"pserve_launches_per_round": a["spmm"]}}


# ---------------------------------------------------------------------------
# Phase 26: the root measurement scripts (examples/gat_scale.py,
# scale_matrix.py, group_sweep.py, gather_micro.py,
# segment_softmax_probe.py, host_overlap_probe.py)
# ---------------------------------------------------------------------------

# EgoGATConv's seed_chunk in gat_scale's runs (the JAX script's default;
# on the card every chunk runs the same kernel)
A4_CHUNK = 256
# the three gat_scale variants' first step against each other on one batch
# from the same weights: the same kernels on the same inputs, but Kernel
# 3's backward adds across blocks with atomics, so gradients agree to a
# few f32 roundings of each tensor's largest value
A4_VARIANT_TOL = 1e-4
# eager against captured EgoGAT losses over two calls of K steps from the
# same state: after the first step the atomics' rounding moves the
# weights, which Adam's update does not damp
A4_CAPTURE_RTOL = 1e-3
# gather_micro's group mean on Kernel 4 against the plain f32 mean: both
# sum 10 f32 terms (bf16 or f32 rows, exact in f32), in other orders
A4_MICRO_TOL = 1e-5
# host_overlap_probe's timed steps (the JAX script's default)
A4_OVERLAP_STEPS = 30
# kernel name patterns of the paths' launches (Kernel 3: one attention
# kernel a forward, one a backward)
A4_KERNELS = {"gather_rows": "gather_rows", "segment_spmm": "segment_spmm",
              "sweep_aggregate": "sweep_aggregate",
              "gat_block": "attn_fwd_kernel",
              "gat_block_bwd": "attn_bwd_kernel"}


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-12))


def gat_scale_path(torch, card, gather, gat, graph, cfg):
    """26a, examples/gat_scale.py on phase 11's store: each variant's first
    step (one batch, the same weights) on the kernels against the plain
    versions and against the other variants, with its launches; then each
    variant's K-step form eager (two calls) and captured (a warm call and
    ``cfg["steps"] // K`` timed ones) from the same state: losses within
    A4_CAPTURE_RTOL, launches a replayed step from the profiler as derived,
    ms a step, edges/s, device busy, capture seconds and graph pool.
    Returns the kernels line's fields."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import gat_scale as gs
    from graph_learn_tpu_torch.examples.scale_demo import loss_of
    from graph_learn_tpu_torch.nn.layers import ego as ego_layers

    g, dec = graph
    K, (k1, k2), b = cfg["scan_steps"], cfg["fanout"], cfg["batch"]
    edges = b * (k1 + k1 * k2)
    q = bench.two_hop_query(g, b, (k1, k2))
    tables = q.device_tables("cuda")
    table = tables["nodes"]["item"].float_attrs
    n_rows = table.shape[0]
    counters = {"gather_rows": gather.LAUNCHES, "gat_block": gat.LAUNCHES_FWD,
                "gat_block_bwd": gat.LAUNCHES_BWD}

    def reset():
        for c in counters.values():
            c.reset()

    def counts():
        return {k: c.count for k, c in counters.items()}

    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        _, batch = bench.sample_one(q, tables, cfg["n_nodes"], gen)
    model = gs.make_model(cfg, dec, A4_CHUNK, "cuda")
    first = {}
    for pre in gs.VARIANTS:
        reset()
        first[pre] = gs.loss_and_grads(model, batch, table, pre)
        torch.cuda.synchronize()
        check(counts() == gs.launches_per_step(pre),
              "gat_scale pre=%d: one step launched %s, derived %s"
              % (pre, counts(), gs.launches_per_step(pre)))
    plain = {a: v.replace(float_attrs=table[v.ids.long().clamp(0, n_rows - 1)])
             for a, v in batch.items()}
    kernel_block = ego_layers.gat_block
    ego_layers.gat_block = gat.gat_block_plain
    try:
        ref = loss_of(model, plain)
        ref_grads = torch.autograd.grad(ref, list(model.parameters()))
    finally:
        ego_layers.gat_block = kernel_block
    names = [n for n, _ in model.named_parameters()]
    worst_plain, worst_var = 0.0, 0.0
    for pre, (loss, grads) in first.items():
        check(abs(loss.item() - ref.item()) <= STEP_LOSS_RTOL
              * abs(ref.item()), "gat_scale pre=%d: loss %g on the kernels, "
              "%g on the plain versions" % (pre, loss.item(), ref.item()))
        check(abs(loss.item() - first[0][0].item()) <= A4_VARIANT_TOL
              * abs(first[0][0].item()), "gat_scale pre=%d: first loss %g, "
              "pre=0 %g" % (pre, loss.item(), first[0][0].item()))
        for name, got, want, base in zip(names, grads, ref_grads,
                                         first[0][1]):
            rel = _rel_err(got, want)
            check(rel <= STEP_GRAD_TOL, "gat_scale pre=%d: gradient of %s "
                  "off by %g of its largest plain value" % (pre, name, rel))
            var = _rel_err(got, base)
            check(var <= A4_VARIANT_TOL, "gat_scale pre=%d: gradient of %s "
                  "off by %g of pre=0's largest value" % (pre, name, var))
            worst_plain, worst_var = max(worst_plain, rel), max(worst_var,
                                                                var)
    log("gat_scale (EgoGAT %s heads %s, chunk %d, the %d-node %d-edge "
        "store): one step of each variant on one batch: losses %s against "
        "%.7f on the plain versions (limit %g relative), worst gradient "
        "%.3g of the plain tensor's largest value (limit %g), %.3g of "
        "pre=0's (limit %g); launches a step %s; card: %s"
        % ([cfg["feat_dim"], cfg["hidden"], cfg["classes"]], list(gs.HEADS),
           A4_CHUNK, cfg["n_nodes"], cfg["n_nodes"] * cfg["avg_degree"],
           ["%.7f" % first[p][0].item() for p in gs.VARIANTS], ref.item(),
           STEP_LOSS_RTOL, worst_plain, STEP_GRAD_TOL, worst_var,
           A4_VARIANT_TOL, {p: gs.launches_per_step(p) for p in gs.VARIANTS},
           card))
    del first, ref, ref_grads, plain, model

    rows = {"gather_rows": {}, "gat_block": {}}
    for pre in gs.VARIANTS:
        want = gs.launches_per_step(pre)
        eager = gs.make_steps(q, tables, cfg, dec, pre, A4_CHUNK, "cuda",
                              capture=False)
        eager()
        eager_losses = [eager.losses.clone()]
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        eager()
        eager_losses.append(eager.losses.clone())
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / K * 1e3
        launched = counts()
        check(launched == {k: v * K for k, v in want.items()},
              "gat_scale pre=%d eager: launches %s over %d steps, derived %s "
              "a step" % (pre, launched, K, want))
        eager_work, eager_busy, _ = bench_work(torch, eager.run_eager, 1, 1,
                                               kernels=A4_KERNELS)
        del eager
        step = gs.make_steps(q, tables, cfg, dec, pre, A4_CHUNK, "cuda",
                             capture=True)
        r = bench.time_calls(step, cfg, edges)
        el = torch.cat(eager_losses).cpu().numpy()
        gl_ = np.asarray(r["losses"][:2 * K])
        check(bool(np.isfinite(r["losses"]).all()),
              "gat_scale pre=%d: a captured loss is not finite" % pre)
        diff = float(np.max(np.abs(el - gl_) / np.abs(el)))
        check(diff <= A4_CAPTURE_RTOL, "gat_scale pre=%d: eager and captured "
              "losses differ by %g relative (limit %g)"
              % (pre, diff, A4_CAPTURE_RTOL))
        work, busy, by_name = bench_work(torch, step, 1, 2,
                                         kernels=A4_KERNELS)
        per_step = {k: work[k] / K for k in want}
        check(per_step == want and work["segment_spmm"] == 0,
              "gat_scale pre=%d: kernels a replayed step %s, derived %s"
              % (pre, per_step, want))
        check({k: eager_work[k] / K for k in want} == want,
              "gat_scale pre=%d: kernels an eager step %s, derived %s"
              % (pre, {k: eager_work[k] / K for k in want}, want))
        log("gat_scale chunk=%d pre=%d: CUDA graph %.4f ms a step (%.4g "
            "edges/s; device busy %.4f ms, %.1f%%), eager %.4f ms a step "
            "(device busy %.4f ms, %.1f%%); warm call %.2f s, capture %.3f "
            "s, graph pool %.1f MB; %d losses eager and captured within %.3g "
            "relative (limit %g; %.4f -> %.4f); kernels a replayed step %s "
            "(derived); card: %s"
            % (A4_CHUNK, pre, r["step_ms"], r["edges_per_s"], busy / K,
               100.0 * busy / K / r["step_ms"], eager_ms, eager_busy / K,
               100.0 * eager_busy / K / eager_ms, r["warm_s"],
               r["capture_s"], r["graph_pool_bytes"] / 1e6, 2 * K, diff,
               A4_CAPTURE_RTOL, r["losses"][0], r["losses"][-1], per_step,
               card))
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log("  device %.4f ms per replayed step: %s"
                % (ms / K, kernel_label(kname)[:90]))
        rows["gather_rows"].update({
            "a4_gat_launches_per_step_pre%d" % pre: per_step["gather_rows"],
            "a4_gat_eager_launches_pre%d" % pre: launched["gather_rows"]})
        rows["gat_block"].update({
            "a4_gat_eager_launches_pre%d" % pre: launched["gat_block"],
            "a4_gat_eager_bwd_launches_pre%d" % pre:
                launched["gat_block_bwd"],
            "a4_gat_launches_per_step_pre%d" % pre: per_step["gat_block"],
            "a4_gat_bwd_launches_per_step_pre%d" % pre:
                per_step["gat_block_bwd"],
            "a4_gat_ms_step_pre%d" % pre: r["step_ms"],
            "a4_gat_edges_per_s_pre%d" % pre: r["edges_per_s"],
            "a4_gat_busy_share_pre%d" % pre: busy / K / r["step_ms"]})
        del step, r
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _counted(counters, fn):
    """(fn(), {name: launches of its wrapper during the call}), every
    count set to 0 first."""
    for c in counters.values():
        c.reset()
    out = fn()
    return out, {k: c.count for k, c in counters.items()}


def scale_matrix_path(torch, card, gather, spmm, graph, cfg):
    """26a, examples/scale_matrix.py on phase 11's store: the float32 and
    bfloat16 runs, each table's dtype and bytes as asked, 2 gather_rows
    and 1 segment_spmm a replayed step, and both wrappers launched.
    Returns the kernels line's fields."""
    from graph_learn_tpu_torch.examples import scale_matrix as sm
    K = cfg["scan_steps"]
    out, launched = _counted(
        {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES},
        lambda: sm.run(cfg, "cuda", graph=graph))
    check(all(launched.values()), "scale_matrix: wrapper launches %s"
          % launched)
    rows = {k: {"a4_scale_matrix_launches": v} for k, v in launched.items()}
    for r in out:
        rec, dt = r["record"], r["record"]["feature_dtype"]
        width = {"float32": 4, "bfloat16": 2}[dt]
        check(r["table_dtype"] == dt and r["table_bytes"]
              == cfg["n_nodes"] * cfg["feat_dim"] * width,
              "scale_matrix %s: the run's table is %s, %d bytes"
              % (dt, r["table_dtype"], r["table_bytes"]))
        check(bool(np.isfinite(r["bench"]["losses"]).all()),
              "scale_matrix %s: a loss is not finite" % dt)
        work, busy, _ = bench_work(torch, r["bench"]["step"], K, 2)
        check(work == {"gather_rows": 2.0, "segment_spmm": 1.0,
                       "sweep_aggregate": 0.0},
              "scale_matrix %s: kernels a replayed step %s; want 2 "
              "gather_rows and 1 segment_spmm" % (dt, work))
        log("scale_matrix: %s; table %s, %d bytes; %.4f ms a step, device "
            "busy %.4f ms a step; kernels a replayed step %s; card: %s"
            % (json.dumps(rec), r["table_dtype"], r["table_bytes"],
               r["bench"]["step_ms"], busy,
               {k: v for k, v in work.items() if v}, card))
        tag = {"float32": "f32", "bfloat16": "bf16"}[dt]
        for k in rows:
            rows[k]["a4_scale_matrix_launches_per_step_" + tag] = work[k]
        rows["gather_rows"]["a4_scale_matrix_edges_per_s_" + tag] = \
            r["bench"]["edges_per_s"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def group_sweep_path(torch, card, gather, spmm, graph, cfg):
    """26a, examples/group_sweep.py on phase 11's store: each G that
    divides K, with its launches a replayed call (2 K gather_rows, K / G
    segment_spmm) from the profiler, both wrappers launched, and each G's
    first loss within A4_VARIANT_TOL of G = 1's (the same weights and
    first batch); then, outside the counted run, Kernel 2 at each G's
    shape (the deepest hops of G sampled batches, [G * b * k1, k2] ids)
    against its plain version.  Returns the kernels line's fields."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import group_sweep as gsw
    from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
    K, (k1, k2), b = cfg["scan_steps"], cfg["fanout"], cfg["batch"]

    def inspect(G, step):
        work, busy, _ = bench_work(torch, step, 1, 2, kernels=A4_KERNELS)
        want = gsw.launches_per_call(K, G)
        check({k: work[k] for k in want} == want
              and work["sweep_aggregate"] == 0,
              "group_sweep G=%d: kernels a replayed call %s, derived %s"
              % (G, work, want))
        return work, busy

    r, launched = _counted(
        {"gather_rows": gather.LAUNCHES, "segment_spmm": spmm.LAUNCHES},
        lambda: gsw.run(cfg, "cuda", graph=graph, inspect=inspect))
    check(all(launched.values()), "group_sweep: wrapper launches %s"
          % launched)
    check([x["G"] for x in r["runs"]] == gsw.widths(K),
          "group_sweep: widths %s" % [x["G"] for x in r["runs"]])
    rows = {k: {"a4_group_sweep_launches": v} for k, v in launched.items()}
    for x in r["runs"]:
        work, busy = x["inspected"]
        check(bool(np.isfinite(x["losses"]).all()),
              "group_sweep G=%d: a loss is not finite" % x["G"])
        log("group_sweep G=%-3d %12.1f edges/s   %.4f ms/step   (warmup "
            "%.1fs; capture %.3f s, graph pool %.1f MB; device busy %.4f ms "
            "a step; kernels a replayed call of K = %d: %s); card: %s"
            % (x["G"], x["edges_per_s"], x["step_ms"], x["warm_s"],
               x["capture_s"], x["graph_pool_bytes"] / 1e6, busy / K, K,
               {k: v for k, v in work.items() if v}, card))
        for k in rows:
            rows[k]["a4_group_sweep_launches_per_call_G%d" % x["G"]] = work[k]
        rows["gather_rows"]["a4_group_sweep_ms_step_G%d" % x["G"]] = \
            x["step_ms"]
    first = r["runs"][0]["losses"][0]
    off = {x["G"]: abs(x["losses"][0] - first) / abs(first)
           for x in r["runs"]}
    check(max(off.values()) <= A4_VARIANT_TOL, "group_sweep: first losses "
          "off G = 1's by %s relative (limit %g)" % (off, A4_VARIANT_TOL))

    q = bench.two_hop_query(graph[0], b, (k1, k2))
    tables = q.device_tables("cuda")
    table = tables["nodes"]["item"].float_attrs
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    for G in gsw.widths(K):
        spmm.LAUNCHES.reset()
        with torch.no_grad():
            ids = torch.stack([
                bench.sample_one(q, tables, cfg["n_nodes"], gen)[1]["hop2"].ids
                for _ in range(G)])
            out = gather_group_agg(table, ids, "mean")
            flat = ids.reshape(-1, k2)
            deg = torch.full((flat.shape[0],), k2, dtype=torch.int32,
                             device="cuda")
            ref = spmm.segment_spmm_plain(
                table, *spmm.clip(flat, deg, table.shape[0]), "mean",
                out.dtype)
        torch.cuda.synchronize()
        # check_spmm's tolerances
        rtol, atol = ((1e-5, 1e-5) if out.dtype == torch.float32
                      else (2 ** -7, 1e-5))
        errs[G] = (out.float() - ref.float()).abs().max().item()
        out_dtype = str(out.dtype).replace("torch.", "")
        check(spmm.LAUNCHES.count == 1
              and tuple(out.shape) == (G * b * k1, table.shape[1])
              and torch.allclose(out.float(), ref.float(), rtol=rtol,
                                 atol=atol),
              "group_sweep G=%d: Kernel 2 on [%d, %d] ids (%d launches, "
              "out %s) against segment_spmm_plain: max abs err %g"
              % (G, flat.shape[0], k2, spmm.LAUNCHES.count,
                 tuple(out.shape), errs[G]))
        del ids, out, flat, deg, ref
    log("group_sweep: first losses off G = 1's by %s relative (limit %g); "
        "Kernel 2 at each width's shape ([G * %d, %d] ids of sampled "
        "deepest hops into the %s [%d, %d] table, %s out) against "
        "segment_spmm_plain within check_spmm's tolerance, max abs err %s; "
        "card: %s"
        % ({G: "%.3g" % v for G, v in off.items()}, A4_VARIANT_TOL, b * k1,
           k2, str(table.dtype).replace("torch.", ""), table.shape[0],
           table.shape[1], out_dtype,
           {G: "%.3g" % v for G, v in errs.items()}, card))
    for k in rows:
        rows[k]["a4_group_sweep_first_loss_off"] = max(off.values())
    rows["segment_spmm"]["a4_group_sweep_max_abs_err"] = max(errs.values())
    return rows


def a4_scale_path(torch, card, gather, spmm, gat, graph):
    """Phase 26a inside phase 11, on its weighted 61.25M-edge "minimal"
    store: gat_scale, scale_matrix and group_sweep at CFG_SCALE.  Returns
    the kernels line's fields."""
    from graph_learn_tpu_torch import bench
    t_phase = time.perf_counter()
    cfg = dict(bench.CFG_SCALE)
    rows = {}
    for part in (gat_scale_path(torch, card, gather, gat, graph, cfg),
                 scale_matrix_path(torch, card, gather, spmm, graph, cfg),
                 group_sweep_path(torch, card, gather, spmm, graph, cfg)):
        for k, fields in part.items():
            rows.setdefault(k, {}).update(fields)
    log("phase 26a (gat_scale, scale_matrix, group_sweep) in %.1f s"
        % (time.perf_counter() - t_phase))
    return rows


def gather_micro_path(torch, card, spmm, sweep):
    """26b, examples/gather_micro.py at its shapes, bf16 then f32: every
    variant's ms an iteration, max_abs_diff within A4_MICRO_TOL, and one
    call of each kernel route's body putting one sweep_aggregate (and its
    memset) or one segment_spmm on the card (a captured graph's nodes).
    Returns the kernels line's fields."""
    from graph_learn_tpu_torch.examples import gather_micro as gm
    counters = {"sweep_aggregate": sweep.LAUNCHES_SWEEP,
                "segment_spmm": spmm.LAUNCHES}
    rows = {"sweep_aggregate": {}, "segment_spmm": {}}
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        calls = {}

        def inspect(name, body, table, idx0):
            if name not in gm.KERNEL_ROWS:
                return
            work = captured_work(torch, lambda: body(table, idx0, 0))
            calls[name] = {k: sum(c for n, c in work.items() if k in n)
                           for k in counters}
            calls[name]["memset"] = sum(c for n, c in work.items()
                                        if n.startswith("Memset"))

        for c in counters.values():
            c.reset()
        res = gm.run(dtype=dtype, device="cuda", inspect=inspect)
        launched = {k: c.count for k, c in counters.items()}
        check(calls["kernel_sorted"]["sweep_aggregate"] == 1
              and calls["kernel_sorted"]["segment_spmm"] == 0
              and calls["kernel_sorted"]["memset"] >= 1
              and calls["kernel_unsorted"]["segment_spmm"] == 1
              and calls["kernel_unsorted"]["sweep_aggregate"] == 0,
              "gather_micro %s: one call of the sorted route put %s on the "
              "card, of the unsorted route %s" % (
                  dtype, calls["kernel_sorted"], calls["kernel_unsorted"]))
        check(launched["sweep_aggregate"] > 0 and launched["segment_spmm"] > 0,
              "gather_micro %s: launches %s" % (dtype, launched))
        check(res["max_abs_diff"] <= A4_MICRO_TOL,
              "gather_micro %s: max_abs_diff %g (limit %g)"
              % (dtype, res["max_abs_diff"], A4_MICRO_TOL))
        log("gather_micro %s D=100 (2 450 000 rows, 153 600 draws, groups "
            "of 10; ms an iteration, K = %d iterations in one CUDA graph): "
            "%s; max_abs_diff %g (limit %g); a call of kernel_sorted puts "
            "%s on the card, of kernel_unsorted %s; wrapper launches %s; "
            "card: %s"
            % (tag, gm.K, ", ".join("%s %.4f" % (n, res[n + "_ms"])
                                    for n in gm.VARIANTS + gm.KERNEL_ROWS),
               res["max_abs_diff"], A4_MICRO_TOL, calls["kernel_sorted"],
               calls["kernel_unsorted"], launched, card))
        rows["sweep_aggregate"].update({
            "micro_launches_per_call_" + tag:
                calls["kernel_sorted"]["sweep_aggregate"],
            "micro_kernel_sorted_ms_" + tag: res["kernel_sorted_ms"],
            "micro_plain_ms_" + tag: res["plain_ms"],
            "micro_sorted_seg_ms_" + tag: res["sorted_seg_ms"],
            "micro_max_abs_diff_" + tag: res["max_abs_diff"],
            "micro_launches_" + tag: launched["sweep_aggregate"]})
        rows["segment_spmm"].update({
            "micro_launches_per_call_" + tag:
                calls["kernel_unsorted"]["segment_spmm"],
            "micro_kernel_unsorted_ms_" + tag: res["kernel_unsorted_ms"],
            "micro_launches_" + tag: launched["segment_spmm"]})
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def probe_path(torch, card, gat):
    """26b, examples/segment_softmax_probe.py at its full shape: bar,
    chunked and fused (fused and chunked within 3e-3 of bar, checked by
    the probe), and Kernel 3's forward alone on the probe's inputs
    against its plain version and its bound.  Returns Kernel 3's
    fields."""
    from graph_learn_tpu_torch.examples import segment_softmax_probe as sp
    gat.LAUNCHES_FWD.reset()
    r = sp.run(small=False, steps=20, device="cuda")
    probe_launches = gat.LAUNCHES_FWD.count
    check(probe_launches > 0, "the probe's fused never launched gat_block")
    n_seeds, k2, din, h, w = r["seeds"], r["k2"], r["D"], r["heads"], \
        r["width"]
    x, wn, al, ar = sp.inputs(n_seeds, k2, din, h, w, torch.device("cuda"))
    nbr = x.reshape(n_seeds, k2, din)
    el = torch.einsum("sd,hd->hs", nbr[:, 0],
                      torch.einsum("hdw,hw->hd", wn, al[:, 0])).contiguous()
    args = (nbr, wn, ar[:, 0].contiguous(), el)
    with torch.no_grad():
        out, ref = gat.gat_block(*args), gat.gat_block_plain(*args)
        err = (out - ref).abs().max().item()
        rel = err / max(1.0, ref.abs().max().item())
        check(rel <= GAT_TOL, "gat_block on the probe's inputs: max abs err "
              "%g, %g of the largest plain value (limit %g)"
              % (err, rel, GAT_TOL))
        ms = time_ms(lambda: gat.gat_block(*args), iters=20, hold=True)
        plain_ms = time_ms(lambda: gat.gat_block_plain(*args), iters=10,
                           warmup=2, hold=True)
    io, dots, product = gat_work(n_seeds, k2, din, h, w)
    bound_ms, by = bound(io + 4 * h * n_seeds * w, dots, product)
    log("segment_softmax_probe (seeds %d, k2 %d, D %d, %d heads x %d, f32, "
        "block %d; CUDA events, chunked not held): bar %.4f ms, chunked %.4f ms, fused %.4f "
        "ms (the el term and Kernel 3's forward), fused/bar %.2fx; fused "
        "and chunked within %g of bar (max abs err %g, %g); Kernel 3's "
        "forward alone %.4f ms (plain %.4f, bound %.4f by %s, %.1f%% of "
        "it, stream held; max abs err %g); card: %s"
        % (n_seeds, k2, din, h, w, r["block"], r["bar_ms"], r["chunked_ms"],
           r["fused_ms"], r["fused_over_bar"], r["tol"],
           r["fused_max_abs_err"], r["chunked_max_abs_err"], ms, plain_ms,
           bound_ms, by, 100.0 * bound_ms / ms, err, card))
    return {"gat_block": {
        "probe_bar_ms": r["bar_ms"], "probe_chunked_ms": r["chunked_ms"],
        "probe_fused_ms": r["fused_ms"],
        "probe_fused_over_bar": r["fused_over_bar"],
        "probe_fused_max_abs_err": r["fused_max_abs_err"],
        "probe_kernel_ms": ms, "probe_kernel_plain_ms": plain_ms,
        "probe_kernel_bound_ms": bound_ms, "probe_kernel_bound_by": by,
        "probe_kernel_max_abs_err": err, "probe_launches": probe_launches}}


def host_overlap_path(torch, card, gather, spmm):
    """26b, examples/host_overlap_probe.py on the bench CFG store: t_host,
    t_dev and t_loop for windows 1, 2 and 4, Kernels 1-2 launched 0
    times.  Returns the kernels line's fields."""
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.examples import host_overlap_probe as hop
    r = hop.run(dict(bench.CFG), steps=A4_OVERLAP_STEPS, windows=(1, 2, 4),
                device="cuda")
    check(r["launches"] == {"gather_rows": 0, "segment_spmm": 0},
          "host_overlap_probe: Kernels 1-2 launched %s times" % r["launches"])
    log("host_overlap_probe (bench CFG, EgoGraphSAGE gcn, %d steps, host "
        "clock): t_host %.3f ms, t_dev %.3f ms (overlap ceiling %.3fx); %s; "
        "gather_rows and segment_spmm launched %s; card: %s"
        % (r["steps"], r["t_host_ms"], r["t_dev_ms"], r["ceiling"],
           "; ".join("window=%d t_loop %.3f ms, overlap %.3fx, %.4g edges/s"
                     % (x["window"], x["t_loop_ms"], x["overlap"],
                        x["edges_per_s"]) for x in r["windows"]),
           r["launches"], card))
    return {"gather_rows": {
                "a4_host_overlap_launches": r["launches"]["gather_rows"],
                "a4_host_overlap_t_host_ms": r["t_host_ms"],
                "a4_host_overlap_t_dev_ms": r["t_dev_ms"],
                **{"a4_host_overlap_factor_w%d" % x["window"]: x["overlap"]
                   for x in r["windows"]}},
            "segment_spmm": {
                "a4_host_overlap_launches": r["launches"]["segment_spmm"]}}


def a4_micro_path(torch, card, gather, spmm, sweep, gat):
    """Phase 26b after phase 11: gather_micro, segment_softmax_probe and
    host_overlap_probe.  Returns the kernels line's fields."""
    t_phase = time.perf_counter()
    rows = {}
    for part in (gather_micro_path(torch, card, spmm, sweep),
                 probe_path(torch, card, gat),
                 host_overlap_path(torch, card, gather, spmm)):
        for k, fields in part.items():
            rows.setdefault(k, {}).update(fields)
        gc.collect()
        torch.cuda.empty_cache()
    log("phase 26b (gather_micro, segment_softmax_probe, host_overlap_probe) "
        "in %.1f s" % (time.perf_counter() - t_phase))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import graph_learn_tpu_torch as gl
    from graph_learn_tpu_torch.ops.kernels import (build, gat, gather, spmm,
                                                   sweep)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gl.conf.feature_dtype = "bfloat16"

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))

    t0 = time.perf_counter()
    reports = build.build()
    log("kernels built in %.1f s" % (time.perf_counter() - t0))
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("%s: %s" % (name, line.strip()))

    check_gather(torch, gather)
    check_spmm(torch, spmm)
    check_group_max(torch, gl, spmm)
    check_sweep(torch, sweep)
    check_gat(torch, gat)
    check_operators(torch, gather, spmm, gat, sweep)
    rows = measure_kernels(torch, gather, spmm)
    rows["gat_block"] = measure_gat(torch, gat)
    rows["gat_block"].update(measure_gat_tgat(torch, gat))

    t0 = time.perf_counter()
    g, dec = gl.synthetic_graph(N_NODES, AVG_DEGREE, FEAT_DIM, CLASSES,
                                seed=0, device="cuda")
    log("graph (%d nodes, %d edges) built in %.1f s"
        % (N_NODES, N_NODES * AVG_DEGREE, time.perf_counter() - t0))
    launches = serving_path(torch, card, g, dec, gather, spmm)
    sage_gin_launches, gat_launches = training_path(torch, card, g, dec,
                                                    gather, spmm, gat)
    ragged_launches = full_store_queries(torch, g, spmm)
    filtered_queries(torch, g)
    from graph_learn_tpu_torch import bench
    bench_rows, _ = bench_path(torch, card, bench.CFG, (g, dec), gather,
                               spmm, sweep, "cfg", sorted_route=True)
    # phase 21e on the same graph: checkpoints and the torch bridge
    checkpoint_bridge_path(torch, card, g, dec)
    del g, dec
    gc.collect()  # the 200k graph's tables (Graph, Dag and Query form cycles)
    rows["sweep_aggregate"], rows["stream_sum"], bar = sweep_rows(
        torch, card, sweep, spmm)
    rows["segment_spmm"].update(bar)
    torch.cuda.empty_cache()
    scale_launches, sorted_launches, extra = scale_path(torch, card, gl,
                                                        gather, spmm, sweep)
    gc.collect()  # the 62M graph of scale_path
    torch.cuda.empty_cache()
    with bench.bench_conf(storage_profile="minimal"):
        scale_rows, scale_graph = bench_path(
            torch, card, bench.CFG_SCALE, None, gather, spmm, sweep,
            "cfg_scale")
        et = scale_graph[0].store.edge_table("rel")
        check(et.weights is not None and et.num_edges == 61_250_000,
              "bench cfg_scale: not the weighted 61.25M-edge graph")
        walks_rows = walks_path(torch, card, gather, scale_graph)
        # phase 19's GSL SubGraph query, on this store before it is freed
        query_rows = subgraph_query_path(torch, card, gather, scale_graph)
        # phase 21a-b: the snapshot of this store, then the host tier on
        # the restored store's CPU views
        restored, snap_dir, snap_rows = snapshot_path(
            torch, card, scale_graph,
            scale_rows["gather_rows"]["bench_cfg_scale_build_s"])
        try:
            host_rows = host_tier_path(torch, card, gather, spmm, scale_graph,
                                       restored, bench.CFG_SCALE)
        finally:
            del restored
            gc.collect()
            shutil.rmtree(snap_dir, ignore_errors=True)
        host_rows["gather_rows"].update(snap_rows)
        # phase 26a: gat_scale, scale_matrix and group_sweep on this store
        a4_rows = a4_scale_path(torch, card, gather, spmm, gat, scale_graph)
    del scale_graph, et
    gc.collect()  # the weighted 61.25M-edge graph of the bench phase
    torch.cuda.empty_cache()
    # phase 26b: gather_micro, segment_softmax_probe, host_overlap_probe
    a4_micro_rows = a4_micro_path(torch, card, gather, spmm, sweep, gat)
    gc.collect()
    torch.cuda.empty_cache()
    with bench.bench_conf(storage_profile="full"):
        bipartite_rows = bipartite_path(torch, card, gather, spmm, sweep)
    gc.collect()  # the bipartite store
    torch.cuda.empty_cache()
    with bench.bench_conf(storage_profile="minimal"):
        rgcn_rows = rgcn_path(torch, card, gather, spmm, sweep)
    gc.collect()  # the rgcn store
    torch.cuda.empty_cache()
    with bench.bench_conf(storage_profile="full"):
        temporal_rows = temporal_path(torch, card, gather, spmm, sweep)
    gc.collect()  # the temporal store
    torch.cuda.empty_cache()
    # phase 23's ogbl-collab-sized tables, written meanwhile on the host
    collab_writer = start_collab_writer(COLLAB_FILES)
    # the example's own feature dtype
    with bench.bench_conf(storage_profile="full", feature_dtype="float32"):
        tgat_rows = tgat_path(torch, card, gather, gat)
        example_rows = examples_path(torch, card, gather)
        seal_rows = seal_path(torch, card, gather)
        gc.collect()  # the ogbl-collab-sized store
        torch.cuda.empty_cache()
        sage_rows = sage_unsup_path(torch, card, gather)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 21c-d: the BFS reorder on the ogbl-collab-sized store, the
        # TSV examples
        reorder_rows = reorder_path(torch, card, gather)
        gc.collect()
        torch.cuda.empty_cache()
        tsv_rows = tsv_examples_path(torch, card, gather, spmm, gat)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 23: the examples on real layouts (the reference Cora
        # configuration, Cora's raw files, SEAL's --collab_dir)
        real_rows = real_layout_path(torch, card, gather, spmm,
                                     writer=collab_writer)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 20: file ingest and the sampler API on the TSV store, then k-NN
    with bench.bench_conf(storage_profile="full"):
        file_rows, file_graph, _ = file_tier_path(torch, card, gather, spmm)
        sampler_rows = sampler_api_path(torch, card, gather, file_graph)
    del file_graph
    gc.collect()  # the TSV store
    torch.cuda.empty_cache()
    knn_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 22: the online tier from the bench store's files, which phase
    # 25 serves from again
    import tempfile
    online_files = tempfile.mkdtemp(prefix="glt_online_")
    try:
        with bench.bench_conf(storage_profile="full"):
            online_counts = online_path(torch, card, gather, spmm,
                                        files=online_files)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 24: the parallel store and training on torch.distributed
        with bench.bench_conf(storage_profile="full"):
            parallel_rows = parallel_path(torch, card, gather, spmm)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 25: partitioned serving and the sharded k-NN index
        pserve_rows = partitioned_path(torch, card, gather, spmm,
                                       online_files)
    finally:
        shutil.rmtree(online_files, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    for part in (bench_rows, scale_rows, walks_rows, query_rows,
                 bipartite_rows, rgcn_rows, temporal_rows, tgat_rows,
                 example_rows, seal_rows, sage_rows, file_rows, sampler_rows,
                 host_rows, reorder_rows, tsv_rows, real_rows,
                 parallel_rows, pserve_rows, a4_rows, a4_micro_rows):
        for kname, fields in part.items():
            extra.setdefault(kname, {}).update(fields)
    # `launches`: each from the run of the path named, which started from
    # zero: the serving phase for gather_rows and segment_spmm, the EgoGAT
    # training run for gat_block, the sorted-gather 62M run for
    # sweep_aggregate, the harness for stream_sum
    kernels = []
    for name in ("gather_rows", "segment_spmm"):
        rows[name]["launches"] = launches[name]
        rows[name]["train_launches"] = (sage_gin_launches[name]
                                        + gat_launches[name])
        rows[name]["scale_launches"] = (scale_launches[name]
                                        + sorted_launches[name])
        kernels.append(rows[name])
    rows["segment_spmm"]["ragged_launches"] = ragged_launches
    rows["gat_block"]["launches"] = gat_launches["gat_block"]
    rows["gat_block"]["bwd_launches"] = gat_launches["gat_block_bwd"]
    check(gat_launches["gat_block"] > 0 and gat_launches["gat_block_bwd"] > 0,
          "gat_block was never launched by the training path")
    kernels.append(rows["gat_block"])
    rows["sweep_aggregate"]["launches"] = sorted_launches["sweep_aggregate"]
    # one /predict of phase 22's exported EgoGAT and sorted-route programs
    rows["gat_block"]["predict_launches"] = \
        online_counts["gat_one_predict"]["gat_block"]
    rows["sweep_aggregate"]["predict_launches"] = \
        online_counts["sorted_one_predict"]["sweep_aggregate"]
    for name in ("sweep_aggregate", "stream_sum"):
        check(rows[name]["launches"] > 0, name + " was never launched by "
              "its path")
        kernels.append(rows[name])
    for name, fields in extra.items():
        rows[name].update(fields)
    check_bounds(kernels)
    log("every phase passed in %.1f s" % (time.perf_counter() - t_start))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
