#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpqe_tpu_torch``) on one GPU.

Drives the serving path, the per-formula evaluation through the sparse
encoder, the full ranking, the dense training path, the sparse training
path (``--kernel fused`` and ``--kernel blocked``), the training
through the edge-partitioned halo layers (``--parallel halo_ring`` /
``halo_gather``), the GQE baselines, the data path (npz and GQE
pickle datasets through the CLIs, the benchmark driver ``python -m
mpqe_tpu_torch.bench`` and the quality benchmark) and reduced precision
(a bf16 model trained through K1/K2 and served through K3 from float32,
bfloat16 and int8 candidate tables; its sparse routes: K5 on bf16 rows,
K6 and K8 on bf16 leaves, the sparse evaluate, and the train CLI at
``--dtype bfloat16`` through ``--kernel fused|blocked`` and ``--parallel
halo_ring``), the sharded entity table (serving, full ranking, the
data-parallel step, two processes, the multi-part dry run) and the
train CLI's ``--trace`` window, reference checkpoint import and export,
the crash supervisor, the AM-scale quality tool and ``utils/debug.py``,
and the 17 root tools' ports (``mpqe_tpu_torch/tools/``), at the
flagship width
(d = 128, 3 R-GCN layers, TGT readout, 16 bases or full per-relation
weights, 266 relations, 4 modes, 1,000,000 entities;
random weights from a seed) and checks every
hand-written kernel on them.  The seven kernel libraries build in
parallel (one nvcc each), then:

1. ``kernel.fused_multi``: K3 (``csrc/fused_multi.cu``, products on the
   tensor cores, one launch per layer) for all 7 structures at B = 256
   and at a ragged B = 1000: vs its plain PyTorch version under
   ``ops/fused_fwd.py multi_gate`` (the output under ``chain_gate``:
   one-layer structures <= 1e-4 max|diff| / max|ref|, deeper rows <=
   2e-3, at most 10 % above 1e-4; and layer by layer from the kernel's
   own activations: each element within one bf16 step, at most 0.1 %
   moved, the last layer's rows <= 1e-4 of their own max), both
   controls of ``multi_gate_controls`` (query 0's relation on one edge
   changed, its anchor row moved 8 bf16 steps) failing it, a repeat
   launch through the serving path bit-equal, and vs the float32
   ``encode_dense_multi`` (<= 3e-2,
   the bf16 envelope); times kernel (CUDA events, L2 flushed before each
   call as a serving dispatch finds it) and its kernels' device time
   (profiler), the plain version and, as a yardstick only, the same
   products through ``torch.matmul``, beside the card's bound.
   ``kernel.fused_multi.bf16``: the same at ``cfg.dtype = bfloat16`` (the
   model's leaves rounded once; its bf16 entity table read as it is):
   the f32 output under ``multi_gate``, both controls failing, the
   output through the kernel's bf16 store bit-equal to that f32 output
   rounded and to a repeat, within 3e-2 of the f32 ``encode_dense_multi``
   of the same bf16 values; the bf16 store's kernel ms beside the f32
   store's at B = 256.
2. ``serve``: a ``QueryServer`` on the card answers a stream of sampled
   queries over all 7 structures; K3's launch count must equal one per
   layer of each eligible dispatch, and one dispatch per structure is
   recomputed: the serving layers from the kernel's own query vectors
   (the same scores, within 1e-4), and those vectors within K3's gate of
   the plain version.
3. ``kernel.fused_tgt`` / ``kernel.fused_tgt_backward``: K1 and K2
   (``csrc/fused_tgt.cu``, tensor cores, only the listed blocks of W_l)
   for all 7 structures at B = 512 and a ragged B = 1000: K1 and K2 (dA,
   every dW_l on the listed blocks and 0 off them, db_l) vs their plain
   versions under ``ops/fused_fwd.py chain_gate``, both negative controls
   (one block of W_0 zeroed, one anchor row moved 8 bf16 steps) failing
   it, a repeat launch bit-equal; K1 vs the f32 ``encode_dense`` (<=
   3e-2); K2's parameter gradients (through the differentiable weight
   assembly) vs autograd of the f32 encoder within the reference's depth
   tolerances.  K1's variants on the same batches (``kernel.fused_tgt.
   variants``): ``out_bf16`` bit-equal to K1's own f32 output rounded to
   bf16; ``fold_bias`` (layer 0's bias in W_0, biases nonzero) under
   ``chain_gate`` against its plain version, within 1e-2 of the unfolded
   K1 (the reference's own tolerance), its control (the folded bias row
   zeroed in the plain version) failing the gate; K2 on ``fold_bias``'s
   operands and block list (the folded bias row's gradient is layer 0's
   bias gradient) under ``chain_gate`` against its plain version, both
   controls failing; repeats bit-equal.
   Times both kernels (and K1's variants) at B = 512 and
   B = 131,072 (L2 flushed before each launch: the optimizer update
   between two steps streams GBs), CUDA events around the wrapper and the
   kernels' own device time (torch.profiler), beside the bound and, as a
   yardstick only, the same per-layer products through ``torch.matmul``.
   ``kernel.fused_tgt.bf16``: K1 and K2 at ``cfg.dtype = bfloat16`` at B
   = 512 and 1,000: K1's f32 output and K2's chain gradients under
   ``chain_gate`` on the bf16 model's operands, both controls failing;
   K1 through its wrapper bf16, bit-equal to that output rounded and to a
   repeat, within 3e-2 of the f32 encoder of the same bf16 values; K2's
   parameter gradients bf16, bit-equal to a repeat and within
   ``PARAM_GRAD_MEAN_BY_DEPTH`` of the plain K2's (its control, one
   basis's gradient moved by 4x the limit, failing it and passing the
   depth tolerance it replaces); times at B = 512 and 131,072.
4. ``kernel.rgcn_fused``: K5a (16-basis layer) and K5b (full-weight
   layer) of ``csrc/rgcn_fused.cu`` (tensor cores, split TF32) on the
   ``template_chunked`` layouts of the 7 structures at B = 512 and
   131,072 and on ``chunk_by_relation`` of a general graph (65,536 nodes,
   1,048,576 random typed edges, padded chunks): each vs its plain
   version (<= 1e-4) and the f32 batched oracle (<= 1e-5), a repeat
   launch bit-equal, the negative control (one chunk's coefficients or
   relation changed in the plain version) failing the plain gate, the
   transposed-weight read (the backward's dxs) vs the plain version on a
   transposed copy (<= 1e-4); times (CUDA events and profiler, L2
   flushed) beside the bound (split-TF32 route; the f32-pipe route's
   printed beside it), the plain version and the ``torch.bmm`` yardstick
   on the per-chunk weights.  ``kernel.rgcn_fused.bf16``: K5a and K5b
   on bf16 rows (the rows of a bf16 model, gathered as stored and
   widened in the kernel) on the same 7 layouts at both batches and the
   general graph: bit-equal to K5 on the f32 rows ``x.float()`` and to a
   repeat; at B = 512 and on the general graph within 1e-4 of the plain
   version and 1e-5 of the oracle, the negative control failing; then at
   K = 200 and 768 (k stages); kernel and device ms beside the f32-row
   kernel's in the same run and the bound with 2-byte rows.
5. ``kernel.rgcn_blocked``: K6a (forward and transpose layout) and K6b
   of ``csrc/rgcn_blocked.cu`` (tensor cores) on ``template_blocked`` for
   the 7 structures at both batches and ``bucket_edges_blocked`` of the
   same general graph: K6a within ``blocked_error_bound`` of its plain
   version, K6b under ``k6b_gate`` (dbasis <= 1e-4, each s_eb the plain
   one or its bf16 neighbour, at most 1 % off it, dcoeff the ordered sum
   of the kernel's own s_eb), each negative control failing (one edge, or
   one relation, removed from the plain version), a repeat launch
   bit-equal, K6a vs the f32 twin (<= 3e-2, train batch only); the edge
   lists' build time (once per batch) apart; times as for K5 beside a
   cuBLAS yardstick (the bf16 products ``xs @ [V_0 .. V_Bb]``, and for
   K6b also ``xs^T rhs``).  ``kernel.rgcn_blocked.bf16``: the blocked
   layer with bf16 leaves and rows (K6a forward and ``dx``, K6b) against
   f32 leaves of the same values at B = 512 and on the general graph:
   the output bit-equal, every gradient bf16 and equal to the f32
   leaves' rounded, a repeat bit-equal.
6. ``kernel.segment``: the K4 layout kernel and K4a / K4b
   (``csrc/segment.cu``) on the reference's chip-check shape (E = 1,000,
   S = 64), each structure's destination sum at B = 1,024 (the bucket of
   ``evaluate``'s 1,000 queries per formula) and the cap (E = 2^20, S =
   8,192): the layout equal to the plain layout and to a repeat launch;
   K4a and K4b, with the layout built in the call and given, equal to
   each other and to their plain versions (K4a <= 1e-4, K4b equal), K4a
   vs an f64 oracle (<= 1e-5), dropped out-of-range rows and empty
   segments (0, -1e30); times of each kernel with its layout built and
   given and of the layout alone, beside the bound, the plain version
   and one ``index_add_`` / ``scatter_reduce`` / stable ``argsort`` as
   the yardstick.
7. ``kernel.sddmm``: K7 (``csrc/sddmm.cu``) on N = 512 / E = 2,048, the
   final-layer node embeddings of the B = 1,024 batches over their own
   edges (K7's drive: it has no caller in the package) and N = 8,191 /
   E = 2^20: equal to its plain version (the same sum order) and within
   1e-5 of an f64 oracle, out-of-range endpoints scoring 0; times beside
   the bound, the plain version and ``torch.sparse.sampled_addmm`` as
   the yardstick, with its CSR pattern built outside the timed call and
   inside it.
8. ``kernel.ring``: K8 (``csrc/ring.cu``) over rings of P parts on one
   card: the general graph at P = 2, 3, 4, 8 and each structure's
   template layout at B = 512 on 4 parts, launched P times per layer
   call (counted from 0 over these 11 calls); each vs its plain version
   (equal), the port's ``rgcn_ring_halo`` and the single-device
   ``rgcn_sparse`` (<= 1e-5), and again with every aggregate delayed by
   ``torch.cuda._sleep`` (equal: the ack events hold the copies back);
   times (CUDA events, L2 flushed; K8's device time and the copy
   stream's from the profiler) beside the bound and the plain version.
   ``kernel.ring.bf16``: K8 at P = 4 on a bf16 layer and bf16 rows (the
   general graph and the 7 templates): bit-equal to K8 on the widened
   operands, under ``ring_gate`` against the plain version, its launches
   counted with the drive's.
9. ``eval.sparse``: ``evaluate`` on sampled validation queries through
   an adapter (``dense_to_sparse``, then ``encode_sparse`` with the
   ``"pallas"`` segment backend) for the flagship model (K4a) and a
   max-readout model (K4a, K4b): K4 launches equal to the expected
   counts (the layout once per encode for the destination sums, once
   more for a sum, mlp or max readout), per-structure AUC and APR / 100
   within 1e-3 of ``evaluate`` through the f32 ``encode_dense``, one
   formula per structure bit-equal through the plain K4; then 20 dense
   train steps with one validation round through
   ``run_train(eval_encode_fn=...)``.  ``eval.sparse.bf16``: the same
   ``evaluate`` of both models at ``cfg.dtype = bfloat16`` (f32
   activations, as the reference's ``encode_sparse``): K4 launch counts,
   one formula per structure within 1e-5 of the ``"xla"`` segment sums,
   per-structure AUC within 1e-2 of the bf16 dense encoder's.
10. ``eval.ranking``: ``full_ranking`` over the same queries against all
   1M entities; one structure's ranks recomputed by ``torch.matmul`` and
   a per-row count give the same metrics.
11. ``train``: ``run_train`` on the card with ``--kernel fused_fwd
   --fused_backward pallas`` (batch 512, 4 negatives, Adam lr 0.01, every
   structure from the first step) and one validation round through K3;
   K1 and K2 launch once per step, K3 during validation, every loss is
   finite, and one step repeated from the same state through the plain
   versions gives the same loss (<= 1e-4) and gradients (per leaf
   mean|diff| / mean|ref| <= 1e-4, the max printed beside it).  Step time p50/p95, real
   queries/s (and padded rows/s) and a ``torch.profiler`` account of 10
   steps.
12. ``train.fused``, ``train.fused_full``, ``train.blocked``:
   ``run_train`` through the sparse path (``--kernel fused`` with a
   16-basis and a full-weight model, ``--kernel blocked``), 50 steps
   each: launch counts equal to 2 K5 (or 2 K6a and 1 K6b) per layer of
   every step, finite losses, one step per structure recomputed through
   the plain versions (same loss and gradients, <= 1e-4: the segment
   sums use index_add_; ``train.blocked``'s gradients per leaf in
   mean|diff| / mean|ref|), step p50/p95 and a profile of 10 steps.
13. ``halo.train.ring``, ``halo.train.gather``: ``run_train`` through
   ``make_halo_train_step`` (``rgcn_ring_halo`` / ``rgcn_dst_partitioned``)
   on 4 parts of the card, 20 steps each: finite losses, step p50/p95
   and real queries/s, one batch per structure whose halo loss and
   gradients equal ``dense_batch_loss``'s from the same state (<= 1e-5),
   and a profile of 10 steps.
14. ``train.cli``: ``python -m mpqe_tpu_torch.train`` as a subprocess on
   a small KG with ``--kernel fused_fwd``, with ``--kernel blocked`` and
   with ``--parallel halo_ring`` (the default mesh: one part on one
   card); the final line and run dir of each; ``eval.cli``: ``python -m
   mpqe_tpu_torch.evaluate --run_dir <the first run> --ranking``;
   ``serve.cli``: ``python -m mpqe_tpu_torch.serve --run_dir <the first
   run>`` over all 7 structures.
15. ``gqe.train``: ``run_train`` of the GQE baseline (``--model gqe
   --decoder bilinear --intersection deepsets``; no kernel: the
   reference computes the GQE family outside Pallas) on the card at the
   same width and batch, 50 steps and one validation round through
   ``evaluate_batched``: finite losses, one step per structure repeated
   from the same state on a CPU copy of the model (the same loss, <=
   1e-5 relative, and gradients, per leaf mean|diff| / mean|ref| <=
   1e-4), step p50/p95, real queries/s, peak memory and a profile of 10
   steps.  ``gqe.train.variants``: 10 steps each of ``gqe_softand`` +
   TransE, DistMult + min, box, ``gqe_softand`` + bibox and bilinear
   with the neighborhood encoder (pool, fanout 8; its table built for
   the 1M-entity KG, timed): finite losses, step p50.
16. ``gqe.serve``: a ``QueryServer`` per head (bilinear, box, bibox with
   SoftAnd; random weights) answers 2 requests of 256 queries drawn
   across all 7 structures, k = 10: answers of the target's mode and
   sorted, every served score equal to ``gqe.score_queries`` of its id
   (row gathers, <= 1e-4), and for the first 8 queries of one dispatch
   per structure the top-k ids equal, and scores within 1e-4 of, a CPU
   recomputation over all 1M entities; latency p50/p95 and queries/s.
17. ``gqe.eval.ranking``: ``full_ranking`` of the bilinear and the box
   model against all 1M entities, wall time and peak memory; one
   structure's ranks recounted row by row on the card give the same
   metrics.  ``gqe.cli``: ``python -m mpqe_tpu_torch.train --model
   gqe_softand --decoder bibox --bibox_w 0.5 --gqe_encoder
   neighborhood`` on the small KG, then ``evaluate --ranking`` and
   ``serve`` of its run dir; its config read back keeps ``bibox_w``
   0.5.
18. ``data.npz``: the 1M-entity KG written by ``save_kg_npz`` and read
   back by ``load_kg_npz`` (equal arrays, both timed);
   ``stores_from_edges`` over its 2M directed edges (timed), one batch
   of 512 packed from each of the 8 largest relations' stores (every
   unmasked negative of the range mode, not its target, outside its
   head's answer set); then ``python -m mpqe_tpu_torch.train --data
   npz:<file> --kernel fused_fwd --fused_backward pallas --num_bases
   16`` in-process, 20 steps: its final line, finite losses, K1 and K2
   once a step, K3 in validation, the data's load and query sampling
   time apart from the steps.
19. ``train.bf16``: ``python -m mpqe_tpu_torch.train --dtype bfloat16
   --kernel fused_fwd --fused_backward pallas`` in-process on that KG
   file at the flagship width, 50 steps with a run dir: its final line,
   finite losses, K1 and K2 once a step, K3 in validation, every
   parameter and Adam moment of its final checkpoint in bf16; step p50 /
   p95 beside the float32 runs'.  Then ``train.bf16.fused`` (``--kernel
   fused``, K5a on bf16 rows), ``train.bf16.blocked`` (``--kernel
   blocked``) and ``halo.train.bf16`` (``--parallel halo_ring``), 50, 50
   and 20 steps on the same KG file: the final line, finite losses, K5 /
   K6 launch counts, every parameter and Adam moment of the checkpoint in
   bf16, one step per structure rechecked (the kernels against their
   plain versions, per leaf in mean|diff| / mean|ref| <= 1e-2; the halo
   loss on 4 parts of the card against the dense loss, two routes that
   round their bf16 gradients at different points, <= 2e-1), the loss
   <= 1e-3; step p50 / p95 beside the float32 runs'.
20. ``serve.bf16``: the serve CLI in-process on that run dir with
   ``--table_dtype float32``, ``bfloat16`` and ``int8``, 32 requests of
   256 queries over all 7 structures each (K3 launched; latency, queries/s,
   table bytes and peak memory printed), then a ``QueryServer`` per table
   on the same queries: each quantized table's top-10 overlap with the
   float32 table's >= 0.8 and its scores within 0.05 (the reference's
   rule), and int8 without cosine scoring refused.
21. ``data.pkl``: ``make_rule_kg(30,000 entities, 3 modes, 6 base
   relations, out-degree 2)`` prepared by ``python -m
   mpqe_tpu_torch.tools.prepare_dataset --npz --train_per_structure
   250`` (a subprocess, timed);
   the train CLI on ``--data pkl:<dir>`` at the flagship width (d = 128,
   3 layers, TGT, 16 bases, batch 512) through K1/K2, 200 steps and one
   validation round (K3), then 20 steps on a copy without
   ``train_edges.pkl`` (``raw_edge_1chain_derived`` must count 2 x the
   train triples); ``evaluate --split`` with ``--use val`` and ``--use
   test`` (both buckets, their ``n`` adding up to the evaluated
   queries, K3 launched); ``serve --answer <dir>/test_queries_3.pkl``
   (ids of each query's target mode, sorted scores, ids equal to an
   in-process ``QueryServer.answer`` of the same queries, scores within
   1e-4; wall time and queries/s).
22. ``bench``: ``python -m mpqe_tpu_torch.bench`` as a subprocess with
   ``MPQE_BENCH_MATRIX=1 MPQE_BENCH_KERNELS=1`` at
   its full shapes (K1 at B = 131,072 and its ``out_bf16`` variant, the
   dense f32 step, the four configs, the step through each of the four
   ``--kernel`` paths, each path's device time by kernel): its log (each
   row's peak memory) and its JSON line printed; the line must
   hold the reference's keys, a finite positive ``value`` and
   ``vs_baseline``, a K1 route as ``fwd_impl``, ``edge_msgs_per_fwd`` =
   131,072 x 4, a roofline fraction in (0, 1.05], no broken timing and
   every config and kernel-path row timed, none with an ``error``.
23. ``quality``: ``python -m mpqe_tpu_torch.tools.quality_bench --steps
   2000 --dim 128 --bases 16 --train_per_structure 1000
   --val_per_structure 100`` in-process: both arms' held-out macro AUC
   and APR beside the JAX package's CPU figures of the same command,
   each AUC >= 0.70.
24. The sharded entity table, on parts of the one card: ``serve.sharded``
   (after ``serve``: ``ShardedQueryServer`` on 4 parts at float32,
   bfloat16 and int8 over ``serve``'s stream, each answer equal to the
   unsharded server's of the same table dtype up to ties, K3's launches
   equal to the unsharded server's and its encodings from the compact
   anchor table bit-equal; latency, the largest score block, peak
   memory), ``eval.sharded`` (after ``eval.ranking``:
   ``full_ranking_sharded`` on 4 parts, metrics within 1e-6 of
   ``full_ranking``'s, the ranks that differ with their score gaps),
   and after ``halo.train.multistep``: ``train.spmd`` (3 data-parallel
   SGD steps on a (2, 2) mesh against the single-device step, the
   parameters' changes within 1e-4; the train CLI at ``--parallel
   spmd``, then ``evaluate --ranking`` and ``serve --run_dir`` of its
   run in-process; ``serve --shards N + 1`` refused with the reference's
   message, N the visible cards), ``multihost`` (two processes under
   ``gloo``,
   ``tools/multihost_run.py``, SGD, against one process over the global
   batch: losses within 1e-5, parameter changes within 1e-4, the two
   processes bit-equal), then ``multihost.halo`` and
   ``kernel.ring.multiprocess`` (one pair of worker processes,
   ``chip_smoke.py --multiprocess-worker``, each holding half of the
   parts, their blocks crossing by CUDA IPC: the halo step for
   ``halo_ring`` and ``halo_gather`` on 2 x 2 parts against one process
   on a (4, 1) mesh, ranks bit-equal; K8 at P = 2 and 4 across the
   processes, its sender delayed, bit-equal to one process's K8, under
   ``ring_gate`` against its plain version, the control that skips the
   receive counter different; the cross-process hop's copy and
   counter-wait ms), the ``multicard`` group (below) and ``dryrun``
   (``tools/dryrun_multichip.py`` on 8 parts of the card, or one part on
   each of the first min(4, N) cards, K8 against the ring).
   ``multicard``, over N = every visible card (at most 8), each path held
   to the same path with its parts on one card: ``multicard.shards``
   (``ShardedQueryServer`` on a (1, N) mesh of the cards at float32 and
   int8 against the unsharded server, answers equal up to ties, K3's
   launches equal; ``serve --shards N`` and ``evaluate --ranking --shards
   N`` against the unsharded CLIs), ``multicard.spmd`` (3 SGD steps on
   (N, 1) and (N / 2, 2) meshes of the cards against the same meshes on
   cuda:0: bit-equal where one card's run is bit-equal to itself, else
   within 1e-4), ``multicard.halo`` (``halo_ring`` and ``halo_gather`` on
   N cards against N parts of cuda:0), ``multicard.ring`` (K8 at P = 2
   and N, one part a card, copies delayed: bit-equal to the one-card K8,
   under ``ring_gate``, 6 + 2 P launches a card, the skipped-event
   control different; the hop copy's ms beside its NVLink bound and the
   call's ms), ``multicard.nccl`` (two processes under NCCL on cuda:0 and
   cuda:1: the spmd step, the halo step and K8, held to one process as
   ``multihost``, ``multihost.halo`` and ``kernel.ring.multiprocess``
   are) and, with four cards or more, ``multicard.procs_x_cards`` (two
   processes of two cards each: the halo step and K8).  With one card it
   prints ``multicard: not run, 1 card``.  Then ``multinode``: two node
   groups of this host (two ``torchrun --nnodes 2`` launches, each over
   its own cards, NCCL's peer-to-peer and shared-memory transports off,
   so NCCL goes by sockets between them, as between hosts without
   InfiniBand), each run held to one process as the pairs are:
   ``multinode`` (2 nodes x 1 process: the exchange cases bit-equal,
   ``multinode.spmd``, ``multinode.halo ring|gather``, ``multinode.ring``
   at P = 2 and 4 with its sender delayed, the control different, the
   hop's and the call's ms) and, with four cards,
   ``multinode.mixed.procs`` (2 nodes x 2 processes: CUDA IPC within a
   node, NCCL between; the halo step and K8 at P = 4) and
   ``multinode.mixed.cards`` (2 nodes x 1 process of two cards); every
   process on the node it was launched on, no CUDA IPC handle opened
   across nodes, ``via NET`` for every connection NCCL reported.  With
   one card it prints ``multinode: not run, 1 card``.  ``python3
   chip_smoke.py --multicard`` runs only ``train.spmd``,
   ``multihost.halo``, ``kernel.ring.multiprocess``, ``multicard``,
   ``multinode`` and ``dryrun``.

25. The last modules a single card runs: ``train.trace`` (``data.npz``'s
   train CLI run with ``--trace 5 --trace_skip 10``: ``trace_start`` at
   step 10,
   ``trace_done`` at 15, one Chrome trace under ``<run_dir>/trace``
   holding K1's kernel and K2's other passes at least once a traced
   step; its size and the window's step p50),
   ``import`` (an upstream-shaped state dict of a random model at 10^6
   entities and 4 modes, per-mode tables through a shuffled
   ``node_maps``, through ``tools/import_torch_checkpoint.py`` into a run
   dir: parameters bit-equal; ``serve --run_dir --answer`` through K3
   with the source model's ``QueryServer`` answers; export and
   re-import bit-equal), ``resilient`` (``tools/resilient_train.py``
   over the train CLI on the card, its child SIGKILLed after its first
   checkpoint: relaunched with ``--resume``, resumed at that step,
   finished with exit 0; restarts and seconds lost), ``am_scale``
   (``tools/am_scale_quality.py`` at the reference's AM shape, 2M
   entities, 10M triples, batch 65,536, cut to 100 + 100 steps and
   100,000 / 4,096 queries: the result well formed, losses finite, the
   burn-in loss falling; seconds, steps/s, APR, AUC, peak memory) and
   ``debug`` (one dense flagship step under ``utils/debug.checked``
   equal to it unchecked; a NaN entity row raising
   ``FloatingPointError`` naming an op).
26. ``tools``: the 17 root tools' ports (``mpqe_tpu_torch/tools/``), each
   once in-process through its ``main(argv)`` at the flagship width and
   a short depth (``TOOL_RUNS``; every timed loop cut to ``TOOLS_LOOP``):
   ``serve_bench`` (4 requests of 256, 2 HTTP clients), ``eval_bench``
   (B = 256), ``e2e_train_bench`` (one dispatch of 8 steps at B =
   131,072 through the C++ packer and the pipeline), ``step_breakdown
   --kernel fused_fwd --adam_probe``, ``loss_breakdown``,
   ``embed_scatter_exp``, ``gather_exp``, ``bf16_shared_bench`` (K1/K2
   in f32, and bf16 with shared negatives), ``big_kg_demo`` (10^6
   triples, 2 timed steps at B = 65,536 on 10^7 entities),
   ``fused_fwd_bench --variants --train_bwd --multi``, ``fwd_gemm_floor``,
   ``kernel_bench`` (E = 2^20; xla, fused, blocked and its gradient),
   ``scaling_bench`` (1, 2, 4, 8 parts of the card; the layer and the
   sharded rank), ``fused_bwd_diag``, ``kernel_smoke``,
   ``mlp_readout_diag`` (the ``mlp_id`` arm, 200 steps on 100 train
   and 20 held-out queries a structure) and
   ``probe_pickles`` (``data.pkl``'s graph and query pickles): exit code
   0, every JSON record with the reference's keys and finite positive
   times and rates, the tools' own checks (the four scatters' gradients
   within 1e-4, K5 within 1e-4 of the plain route and K6a within its
   bound, K1 within 3e-2 of the f32 encoder, K2 under its limits, every
   ``kernel_smoke`` check OK, every probe check OK); the tools'
   launches of K1-K7 are added to the kernels line.

Prints the card's name and power limit first, then one line per check,
a JSON line ``{"kernels": [...]}`` (K1's entry, ``tgt_mma_forward``,
carries its variants' figures under ``variants``, the bf16 model's
among them, K3's its bf16 store's, and K5a's and K5b's their bf16
rows': one kernel each, its launches counted together) and, last,
``{"ok": true, "device":
{...}}``.  Any failed check raises and the exit code is nonzero.  Needs
one CUDA card and the repository's sources (it builds the kernels); on a
machine with several cards the parts-of-one-card phases stay on cuda:0
and the ``multicard`` and ``multinode`` groups run over all of them.

Usage: python3 chip_smoke.py [--multicard]
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from mpqe_tpu_torch.ops.fused_fwd import F32_GRAD_MEAN_BY_DEPTH
from mpqe_tpu_torch.utils.profiling import (PROFILE_PAD_S, bound_times,
                                            chain_work)

TOL_PLAIN = 1e-4  # kernel vs its plain version: same function, sum order
TOL_F32 = 3e-2  # kernel vs the float32 encoder: bf16 operands
TOL_ORACLE = 1e-5  # K5 vs the f32 batched oracle: f32 both, sum order
TOL_SCORE = 1e-4  # served top-k scores vs the plain recomputation
# K2's parameter gradients vs autograd of the f32 encoder, by depth: the
# reference's own tolerances (tests/test_pallas_fused_fwd.py:261), held
# per leaf to mean|diff| / mean|ref|, the form the reference's chip check
# uses (tools/tpu_smoke.py:185-190).  Its max-element form holds at the
# reference's test width (d = 16, B = 20) but not here: ReLU masks near
# zero flip between the f32 and the bf16 forward, and at d = 128 and
# B = 512 or 1000 a flip moves single elements of layer-0 leaves by up to
# 0.14 of the leaf's max (the reference measured ~0.15 between any two
# precisions, mpqe_tpu/ops/pallas_fused_fwd.py:549-557).  The max-element
# figure is printed beside the gate.
TOL_GRAD_BY_DEPTH = F32_GRAD_MEAN_BY_DEPTH
L2_FLUSH_BYTES = 512 << 20  # > the 50 MB L2
# host idle seconds at each end of a profile's recorded step, one entry a
# try (device_ms, ring_device_ms): unpadded, a short profile sometimes
# records no device event at all (profiling.PROFILE_PAD_S)
PROFILE_PADS = (PROFILE_PAD_S, 0.25, 1.0)

FLAGSHIP = dict(n_entities=1_000_000, n_modes=4, n_rels=266, embed_dim=128,
                n_layers=3, num_bases=16)
KG = dict(n_entities=1_000_000, n_modes=4, n_base_rels=133,
          n_triples=1_000_000, seed=0)
BATCH = 256  # queries per dispatch: the server's cap at 1M entities
RAGGED = 1000
K = 10
ITERS, PLAIN_ITERS = 20, 3  # timed launches per structure
TRAIN_BATCH = 512  # train.py's default batch
TRAIN_BIG = 131_072  # the repo's flagship train batch (bench.py:42)
BIG_ITERS = 5
TRAIN_STEPS = 100
PROFILE_STEPS = 10
SPARSE_STEPS = 50  # train steps of each sparse-path run
PLAIN_ITERS_K6 = 3  # timed plain K6 calls at the train batch
# the reference's kernel-bench graph (pallas_rgcn_blocked.py:57-58)
GENERAL_NODES, GENERAL_EDGES = 65_536, 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls, each after the L2
    is flushed, as a serving dispatch finds it (the rank matmul between
    two encodes streams a GiB).  CUDA events bracket each call only; the
    flush gives the host time to enqueue the call before the device
    reaches it."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


# every kernel of csrc/fused_tgt.cu: tgt_mma_chain_kernel (K1; K2's pass
# A), tgt_mma_dw_kernel, tgt_mma_reduce_kernel, tgt_mma_reduce_db_kernel
TGT_KERNELS = ("tgt_mma_",)


def device_ms(fn, iters: int, flush: torch.Tensor,
              names=TGT_KERNELS, per_call: int = 1) -> float:
    """Mean device ms per ``fn()`` call of the kernels named in ``names``
    alone (torch.profiler; by default those of ``csrc/fused_tgt.cu``),
    each call after an L2 flush as in :func:`time_ms`: the kernels' own
    time, without the wrapper's host work or its other device work (K2's
    weight transposes, K6's bf16 casts).  The profile has a warmup step
    of the same calls, whose events it drops: late in a long run a
    profile without one lost the first 4 of its calls (46 of 50 launches
    of a small kernel recorded, 1 of 5 of a large one).  The recorded
    step has host idle time at each end (``PROFILE_PADS``): without it a
    short step sometimes recorded none of its launches, three times
    running for one K5 case.  A profile that records fewer device events
    of those kernels than calls (each call launches at least one) is
    taken again with the next, longer pad, up to ``len(PROFILE_PADS)``
    profiles in all; if none is whole, the fullest is returned and the
    log says so.
    ``per_call``: the launches of those kernels one call makes at least
    (K5a: its prologue and its messages), so that a profile that lost
    calls is not taken for a whole one."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)  # (launches recorded, device us)
    for attempt, pad in enumerate(PROFILE_PADS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            calls()  # the warmup step
            prof.step()
            time.sleep(pad)  # the recorded step, idle at each end
            calls()
            time.sleep(pad)
            prof.step()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.key for k in names)]
        got = (sum(e.count for e in rows),
               sum(e.device_time_total for e in rows))
        if got[0] >= iters * per_call and got[1] > 0:
            return got[1] / iters / 1e3
        log(f"device_ms: profile {attempt + 1} recorded {got[0]} launches "
            f"of {names} in {iters} calls")
        best = max(best, got)
    if best[1] == 0:
        raise AssertionError(f"the profiler saw none of {names} in "
                             f"{len(PROFILE_PADS)} profiles")
    log(f"device_ms: incomplete, {best[0]} launches of {names} recorded in "
        f"{iters} calls")
    return best[1] / iters / 1e3


def k3_work(cfg, structure: str, node_entity, node_mode, edge_rel_q):
    """(bytes, bf16 tensor-core FLOPs, f32 FLOPs) one K3 launch needs for
    these inputs.  Bytes: each input read once and the output written
    once, counting of the tables only what this run's data selects (the
    distinct anchor rows of the entity table; per layer the bias, the
    coefficient rows of the distinct relations, ``w_self`` only where
    some slot's self term is a product, the bases only where some
    message source is, and the premultiplied layer-0 variable rows of the
    distinct modes otherwise).  bf16 FLOPs: the products, once per
    source slot.  f32 FLOPs: the coefficient combination, norm and sums."""
    from mpqe_tpu_torch.ops.fused_fwd import _plan

    spec, steps, plan, a_slots, v_slots = _plan(cfg, structure)
    B, d, nb = node_entity.shape[0], cfg.embed_dim, cfg.num_bases

    def distinct(t, cols):
        return torch.unique(t[:, list(cols)]).numel() if cols else 0

    nbytes = (distinct(node_entity, a_slots) * d * 4
              + 2 * B * spec.n_nodes * 4 + 2 * B * spec.n_edges * 4
              + B * d * 4)
    var_modes = distinct(node_mode, v_slots)
    mma = f32 = 0
    for li, (_, out_slots, edges) in enumerate(plan):
        var0 = set() if li else set(v_slots)
        self_mm = [s for s in out_slots if s not in var0]
        srcs = {spec.edge_src[j] for j in edges}
        msg_mm = [s for s in srcs if s not in var0]
        nbytes += d * 4 + distinct(edge_rel_q, edges) * nb * 4
        nbytes += (d * d * 2 if self_mm else 0) + (
            nb * d * d * 2 if msg_mm else 0)
        if len(self_mm) < len(out_slots):
            nbytes += var_modes * d * 2
        if len(msg_mm) < len(srcs):
            nbytes += var_modes * nb * d * 2
        mma += 2 * d * d * len(self_mm) + 2 * d * nb * d * len(msg_mm)
        f32 += len(edges) * (2 * nb * d + 2 * d) + len(out_slots) * 2 * d
    return nbytes, B * mma, B * f32


def random_inputs(gen: torch.Generator, cfg, structure: str, B: int, device):
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES[structure]

    def ints(high, cols):
        return torch.randint(0, high, (B, cols), generator=gen,
                             device=gen.device, dtype=torch.int32).to(device)

    ne = ints(cfg.n_entities, spec.n_nodes)
    nm = ints(cfg.n_modes, spec.n_nodes)
    er = ints(cfg.n_rels, spec.n_edges)
    en = (0.5 + torch.rand((B, spec.n_edges), generator=gen,
                           device=gen.device)).to(device)
    return ne, nm, er, en


def library_multi(cfg, ops, structure: str, B: int, gen):
    """K3's yardstick: the same products through ``torch.matmul`` on bf16
    operands, per layer the wide ``x @ [d, Bb d]`` for each message
    source that is a product and ``x @ w_self`` for each self term that is
    one (never called by the port)."""
    from mpqe_tpu_torch.ops.fused_fwd import _plan

    spec, _, plan, _, _ = _plan(cfg, structure)
    anchors = set(spec.anchor_slots)
    pairs = []
    for li, (_, out_slots, edges) in enumerate(plan):
        srcs = {spec.edge_src[j] for j in edges}
        for w, slots in ((ops.vw[li], srcs), (ops.w_self[li], out_slots)):
            for s in slots:
                if li > 0 or s in anchors:
                    x = torch.randn((B, ops.d_pad), generator=gen,
                                    device=gen.device).to(torch.bfloat16)
                    pairs.append((x, w))
    return lambda: [torch.matmul(x, w) for x, w in pairs]


K3_KERNELS = ("fused_multi_layer",)


def phase_kernel(model, cfg, ops, device, gen, flush):
    """K3 against its plain version under ``multi_gate`` (its products run
    on the tensor cores), both controls of ``multi_gate_controls`` (on
    query 0) failing the gate and a repeat launch through the serving
    path bit-equal, and against the f32 encoder; times at the serving
    batch.  Returns the kernel's JSON fields (launches excluded)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    max_abs = 0.0
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for structure in STRUCTURE_NAMES:
        L = mpqe_mod.num_steps(cfg, structure)
        for B in (BATCH, RAGGED):
            args = random_inputs(gen, cfg, structure, B, device)
            with torch.inference_mode():
                # every layer's activations kept, for the layer gate
                got, acts = ff.fused_tgt_forward_multi_layers(
                    model, cfg, structure, *args, operands=ops)
                again = ff.fused_tgt_forward_multi(model, cfg, structure,
                                                   *args, operands=ops)
                plain = ff.fused_tgt_forward_multi_reference(
                    model, cfg, structure, *args, operands=ops)
                f32 = mpqe_mod.encode_dense_multi(model, cfg, structure,
                                                  *args)
                gate = ff.multi_gate(cfg, structure, ops, args, got, acts,
                                     want=plain)
                controls = {name: ff.multi_gate(
                    cfg, structure, o2, (ne, args[1], er, args[3]), got,
                    acts) for name, o2, ne, er in ff.multi_gate_controls(
                        cfg, structure, ops, args[0], args[2])}
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{structure} B={B}: non-finite output")
            fails = all(not c["ok"] for c in controls.values())
            repeat = bool(torch.equal(got, again))
            e_f32 = rel_err(got, f32)
            max_abs = max(max_abs, float((got - plain).abs().max()))
            ctl = " ".join(f"{name}: steps={c['steps']:.0f} "
                           f"last={c['last']:.3e}"
                           for name, c in controls.items())
            line = (f"kernel.fused_multi {structure:14s} B={B:5d} "
                    f"gate_ok={gate['ok']} ({gate_text(gate)}) "
                    f"controls_fail={fails} (query 0: {ctl}) "
                    f"repeat_equal={repeat} err_vs_f32={e_f32:.3e}")
            if not gate["ok"] or not fails or not repeat or e_f32 > TOL_F32:
                log(line + " FAIL")
                raise AssertionError(line)
            if B == BATCH:
                def kfn():
                    ff.fused_tgt_forward_multi(model, cfg, structure, *args,
                                               operands=ops)

                with torch.inference_mode():
                    ms = time_ms(kfn, ITERS, flush)
                    k_ms = device_ms(kfn, ITERS, flush, K3_KERNELS,
                                     per_call=L)
                    plain_ms = time_ms(
                        lambda: ff.fused_tgt_forward_multi_reference(
                            model, cfg, structure, *args, operands=ops),
                        PLAIN_ITERS, flush)
                    lib_ms = time_ms(library_multi(cfg, ops, structure, B,
                                                   gen), ITERS, flush)
                work = k3_work(cfg, structure, args[0], args[1], args[2])
                t_bytes, t_ops = bound_times(work)
                b_by = "bytes" if t_bytes >= t_ops else "operations"
                for k, v in (("ms", ms), ("device_ms", k_ms),
                             ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bound_ms", max(t_bytes, t_ops)),
                             ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
                    tot[k] += v
                line += (f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                         f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                         f"launches_per_call={L} blocks_per_launch="
                         f"{ff.multi_blocks(B, ops.d_pad)} "
                         f"bound_ms={max(t_bytes, t_ops):.6f} ({b_by}: "
                         f"{work[0]} B, {work[1]} bf16 FLOP, "
                         f"{work[2]} f32 FLOP)")
            log(line)
    by = "bytes" if tot.pop("bytes_ms") >= tot.pop("ops_ms") else \
        "operations"
    dev_ms = tot.pop("device_ms")
    log(f"kernel.fused_multi sum of 7 at B={BATCH}: kernel_ms={tot['ms']:.4f} "
        f"device_ms={dev_ms:.4f} plain_ms={tot['plain_ms']:.4f} "
        f"library_ms={tot['library_ms']:.4f} "
        f"bound_ms={tot['bound_ms']:.6f} ({by})")
    return {"max_abs_err": max_abs, **tot, "bound_by": by}


def bf16_twin(model, cfg):
    """The model at ``cfg.dtype = bfloat16`` (every leaf rounded once) and
    its config, beside its float32 copy of those bf16 values and that
    copy's config: ``(model16, cfg16, model32, cfg32)``."""
    import copy

    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    return model16, cfg16, copy.deepcopy(model16).float(), cfg


def phase_kernel_bf16(model, cfg, device, gen, flush):
    """K3 at ``cfg.dtype = bfloat16`` (``kernel.fused_multi.bf16``): the
    bf16 model's operands, its f32 output under ``multi_gate`` against
    the plain version, both controls failing it; the output through the
    kernel's bf16 store bit-equal to that f32 output rounded, to the plain
    version's own bf16 output where the gate saw no flip, and to a repeat;
    within TOL_F32 of the f32 ``encode_dense_multi`` of the same bf16
    values.  Times the bf16 store beside the f32 one at the serving batch.
    Returns the variant's JSON fields."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    model16, cfg16, model32, cfg32 = bf16_twin(model, cfg)
    ops = ff.prepare_fused_multi(model16, cfg16)
    acc = dict(max_abs_err=0.0, ms=0.0, f32_store_ms=0.0, plain_ms=0.0,
               library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for structure in STRUCTURE_NAMES:
        for B in (BATCH, RAGGED):
            args = random_inputs(gen, cfg, structure, B, device)
            with torch.inference_mode():
                got, acts = ff.fused_tgt_forward_multi_layers(
                    model16, cfg16, structure, *args, operands=ops)
                out16 = ff.fused_tgt_forward_multi(model16, cfg16, structure,
                                                   *args, operands=ops)
                again = ff.fused_tgt_forward_multi(model16, cfg16, structure,
                                                   *args, operands=ops)
                plain16 = ff.fused_tgt_forward_multi_reference(
                    model16, cfg16, structure, *args, operands=ops)
                f32 = mpqe_mod.encode_dense_multi(model32, cfg32, structure,
                                                  *args)
                gate = ff.multi_gate(cfg16, structure, ops, args, got, acts)
                controls = {name: ff.multi_gate(
                    cfg16, structure, o2, (ne, args[1], er, args[3]), got,
                    acts) for name, o2, ne, er in ff.multi_gate_controls(
                        cfg16, structure, ops, args[0], args[2])}
            torch.cuda.synchronize()
            if out16.dtype != torch.bfloat16 or not bool(
                    torch.isfinite(got).all()):
                raise AssertionError(f"{structure} B={B}: bf16 output "
                                     f"{out16.dtype}, finite "
                                     f"{bool(torch.isfinite(got).all())}")
            store_equal = bool(torch.equal(bits(out16),
                                           bits(got.to(torch.bfloat16))))
            repeat = bool(torch.equal(bits(out16), bits(again)))
            fails = all(not c["ok"] for c in controls.values())
            e_f32 = rel_err(out16.float(), f32)
            # the plain version rounds at the same point: its bf16 output
            # moves off the kernel's only where the f32 outputs straddle a
            # rounding boundary (printed; the gate holds the f32 outputs)
            n_off = int(out16.ne(plain16).sum())
            acc["max_abs_err"] = max(acc["max_abs_err"], float(
                (out16.float() - plain16.float()).abs().max()))
            line = (f"kernel.fused_multi.bf16 {structure:14s} B={B:5d} "
                    f"gate_ok={gate['ok']} ({gate_text(gate)}) "
                    f"controls_fail={fails} bf16_store_bit_equal="
                    f"{store_equal} repeat_equal={repeat} "
                    f"off_plain_bf16={n_off}/{out16.numel()} "
                    f"err_vs_f32={e_f32:.3e}")
            if not (gate["ok"] and fails and store_equal and repeat
                    and e_f32 <= TOL_F32):
                log(line + " FAIL")
                raise AssertionError(line)
            if B == BATCH:
                cfg_f32_out = dataclasses.replace(cfg16,
                                                  dtype=torch.float32)
                with torch.inference_mode():
                    ms = time_ms(lambda: ff.fused_tgt_forward_multi(
                        model16, cfg16, structure, *args, operands=ops),
                        ITERS, flush)
                    ms32 = time_ms(lambda: ff.fused_tgt_forward_multi(
                        model16, cfg_f32_out, structure, *args,
                        operands=ops), ITERS, flush)
                    plain_ms = time_ms(
                        lambda: ff.fused_tgt_forward_multi_reference(
                            model16, cfg16, structure, *args, operands=ops),
                        PLAIN_ITERS, flush)
                    lib_ms = time_ms(library_multi(cfg, ops, structure, B,
                                                   gen), ITERS, flush)
                nb, bf, f32_ops = k3_work(cfg16, structure, *args[:3])
                # k3_work counts an f32 output and f32 anchor rows; the
                # bf16 model's are bf16, half of each
                nb -= (B + k3_anchor_rows(cfg16, structure, args[0])) \
                    * cfg.embed_dim * 2
                t_bytes, t_ops = bound_times((nb, bf, f32_ops))
                for k, v in (("ms", ms), ("f32_store_ms", ms32),
                             ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bound_ms", max(t_bytes, t_ops)),
                             ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
                    acc[k] += v
                line += (f" kernel_ms={ms:.4f} f32_store_kernel_ms="
                         f"{ms32:.4f} plain_ms={plain_ms:.4f} "
                         f"library_ms={lib_ms:.4f} "
                         f"bound_ms={max(t_bytes, t_ops):.6f}")
            log(line)
    by = "bytes" if acc.pop("bytes_ms") >= acc.pop("ops_ms") else \
        "operations"
    log(f"kernel.fused_multi.bf16 sum of 7 at B={BATCH}: bf16 store "
        f"kernel_ms={acc['ms']:.4f} f32 store kernel_ms="
        f"{acc['f32_store_ms']:.4f} plain_ms={acc['plain_ms']:.4f} "
        f"library_ms={acc['library_ms']:.4f} bound_ms={acc['bound_ms']:.6f} "
        f"({by}) max_abs_err={acc['max_abs_err']:.3e}")
    return {**acc, "bound_by": by}


def k3_anchor_rows(cfg, structure: str, node_entity) -> int:
    """Distinct entity rows one K3 launch gathers (as :func:`k3_work`
    counts them)."""
    from mpqe_tpu_torch.ops.fused_fwd import _plan

    a_slots = _plan(cfg, structure)[3]
    return (torch.unique(node_entity[:, list(a_slots)]).numel()
            if a_slots else 0)


def sample_stream(kg, seed: int = 123, n_mixed: int = 4):
    """Requests over all 7 structures: 4 single-structure requests of
    BATCH queries per structure (shuffled), then ``n_mixed`` requests of
    BATCH queries drawn across every structure."""
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    sampler = QuerySampler(kg, seed=seed)
    batch = BATCH
    pools = {s: sampler.sample_queries(s, batch, n_neg=1)
             for s in STRUCTURE_NAMES}
    rng = np.random.default_rng(0)
    order = [s for s in STRUCTURE_NAMES for _ in range(4)]
    rng.shuffle(order)
    single = [[pools[s][int(i)] for i in rng.integers(0, batch, batch)]
              for s in order]
    union = [q for s in STRUCTURE_NAMES for q in pools[s]]
    mixed = [[union[int(i)] for i in rng.integers(0, len(union), batch)]
             for _ in range(n_mixed)]
    return single, mixed


def check_answers(server, req, answers, k: int) -> None:
    """Shape, ids in range, right mode unless -inf, scores non-increasing."""
    mode = server.entity_mode
    for q, a in zip(req, answers):
        if a.entity_ids.shape != (k,) or a.scores.shape != (k,):
            raise AssertionError(f"answer shape {a.entity_ids.shape}")
        if np.isnan(a.scores).any() or np.isposinf(a.scores).any():
            raise AssertionError(f"bad scores {a.scores}")
        ids = a.entity_ids
        if ids.min() < 0 or ids.max() >= mode.shape[0]:
            raise AssertionError(f"id out of range {ids}")
        real = np.isfinite(a.scores)
        if (mode[ids[real]] != q.formula.target_mode).any():
            raise AssertionError("a returned entity has the wrong mode")
        if (np.diff(a.scores) > 0).any():
            raise AssertionError("scores are not sorted")


def recheck_dispatch(server, model, cfg, ops, structure, req, answers):
    """Recompute one dispatch on the card, holding two things apart: the
    serving layers (normalize, the rank GEMM through ``torch.matmul``, the
    mode mask, ``top_k``) from the kernel's own query vectors, where every
    served score agrees with the recomputed score of the same id and no
    served id falls below the recomputed k-th score (ties may swap only
    within the tolerance); and the kernel's vectors, within K3's gate
    (``multi_gate``) of the plain K3 version."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.serve import top_k

    _, *arrays = server._pack(req)
    ne, nm, er, en, tm = [torch.from_numpy(a).to(server.device)
                          for a in arrays]
    with torch.inference_mode():
        qk, acts = ff.fused_tgt_forward_multi_layers(
            model, cfg, structure, ne, nm, er, en, operands=ops)
        qp = ff.fused_tgt_forward_multi_reference(model, cfg, structure, ne,
                                                  nm, er, en, operands=ops)
        gate = ff.multi_gate(cfg, structure, ops, (ne, nm, er, en), qk, acts,
                             want=qp)
        q = mpqe_mod._l2_normalize(qk)
        full = torch.matmul(q, server._ent_norm_t)
        full.masked_fill_(server._mode_dev[None, :] != tm[:, None],
                          float("-inf"))
        ref_vals, _ = top_k(full, K)
    n = len(req)
    full = full[:n]
    ids = torch.from_numpy(np.stack([a.entity_ids for a in answers])).long()
    got = torch.from_numpy(np.stack([a.scores for a in answers]))
    ref_at = full.gather(1, ids.to(full.device)).cpu()
    ref_kth = ref_vals[:n, -1:].cpu()
    finite = torch.isfinite(ref_at)
    err = float((got - ref_at)[finite].abs().max()) if finite.any() else 0.0
    worst = float((ref_kth - ref_at).clamp(min=0)[finite].max()) \
        if finite.any() else 0.0
    same_inf = bool((torch.isfinite(got) == finite).all())
    line = (f"serve.recheck {structure:14s} n={n} score_err={err:.3e} "
            f"below_kth={worst:.3e} k3_gate_ok={gate['ok']} "
            f"({gate_text(gate)})")
    log(line)
    if err > TOL_SCORE or worst > TOL_SCORE or not same_inf or \
            not gate["ok"]:
        raise AssertionError(line)


def phase_serve(model, cfg, ops, kg, device):
    """Serve the sampled stream; returns K3 launches in the stream."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.serve import QueryServer

    t0 = time.perf_counter()
    server = QueryServer(model, cfg, kg.entity_mode, device=device)
    server.warmup(STRUCTURE_NAMES, batch=BATCH, k=K)
    log(f"setup: server + warmup {time.perf_counter() - t0:.2f} s "
        f"(max_batch={server.max_batch})")
    t0 = time.perf_counter()
    single, mixed = sample_stream(kg)
    log(f"setup: sampled {sum(map(len, single + mixed))} queries "
        f"{time.perf_counter() - t0:.2f} s")

    expected = dispatches = 0  # K3 launches: one per layer of a dispatch
    for req in single + mixed:
        for s in STRUCTURE_NAMES:
            n = sum(q.formula.structure == s for q in req)
            if n and mpqe_mod.multi_kernel_eligible(cfg, s):
                dispatches += -(-n // server.max_batch)
                expected += -(-n // server.max_batch) * mpqe_mod.num_steps(
                    cfg, s)
    ff.fused_tgt_forward_multi.launches = 0
    lat = {"single": [], "mixed": []}
    served = []
    for kind, reqs in (("single", single), ("mixed", mixed)):
        for req in reqs:
            t0 = time.perf_counter()
            answers = server.answer(req, k=K)
            lat[kind].append((time.perf_counter() - t0) * 1e3)
            served.append((req, answers))
    launches = ff.fused_tgt_forward_multi.launches
    log(f"serve: K3 launches {launches}, expected {expected} (one per "
        f"layer of {dispatches} eligible dispatches)")
    if launches == 0 or launches != expected:
        raise AssertionError(f"K3 launches {launches} != {expected}")

    for req, answers in served:
        check_answers(server, req, answers, K)
    seen = set()
    for req, answers in served[:len(single)]:
        s = req[0].formula.structure
        if s not in seen:
            seen.add(s)
            recheck_dispatch(server, model, cfg, ops, s, req, answers)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    for kind, ms in lat.items():
        ms = np.asarray(ms)
        log(f"serve.{kind}: {len(ms)} requests of {BATCH} queries on {name}: "
            f"latency_ms_p50={np.percentile(ms, 50):.3f} "
            f"latency_ms_p95={np.percentile(ms, 95):.3f} "
            f"queries_per_s={len(ms) * BATCH / ms.sum() * 1e3:.1f}")
    reqs = [req for req, _ in served[:7]]
    profile_device(f"serve.profile ({len(reqs)} requests)",
                   lambda: [server.answer(r, k=K) for r in reqs])
    return launches


def shared_inputs(gen: torch.Generator, cfg, structure: str, B: int):
    """One formula's batch on the generator's device: per-query entities
    and modes, shared relations and edge norms."""
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES[structure]
    dev = gen.device

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    return (ints(cfg.n_entities, (B, spec.n_nodes)),
            ints(cfg.n_modes, (B, spec.n_nodes)),
            ints(cfg.n_rels, (spec.n_edges,)),
            0.5 + torch.rand((spec.n_edges,), generator=gen, device=dev))


def chain_operands(model, cfg, structure: str, args, fold_bias=False):
    """K1/K2's operands for a batch: (x0, ws, bs, n_anchor_cols, d_pad);
    with ``fold_bias`` K1's, layer 0's bias folded into W_0."""
    from mpqe_tpu_torch.ops import fused_fwd as ff

    with torch.no_grad():
        v_slots, d_pad, cols, Ws, bs = ff._assemble(
            model, cfg, structure, *args, None, fold_bias=fold_bias)
        x0 = ff._layer0_operand(cols, args[1], v_slots, cfg, d_pad,
                                fold_bias=fold_bias)
        ws = [W.to(torch.bfloat16).contiguous() for W in Ws]
        bs = [b.contiguous() for b in bs]
    return x0, ws, bs, len(cols), d_pad


K1_FOLD_TOL = 1e-2  # fold_bias vs the unfolded K1: the reference's own
# (tests/test_pallas_fused_fwd.py:499; the bias rounds to bf16 in W_0)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 or f32 tensor's bits (``torch.equal`` on them tells -0 from
    0)."""
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def check_k1_variants(model, cfg, structure: str, args, x0, ws, bs, got, g):
    """K1's variants on one batch, ``got`` being K1's own f32 output of
    ``(x0, ws, bs)``: ``out_bf16`` bit-equal to ``got`` rounded to bf16
    and to a repeat; ``fold_bias`` (biases nonzero) under ``chain_gate``
    against its plain version, bit-equal to a repeat, within K1_FOLD_TOL
    of ``got``, and its control (the folded bias row of W_0 zeroed in the
    plain version) failing the gate; K2 on the fold operands and block
    list (cotangent ``g``) under ``chain_gate`` against its plain
    version, bit-equal to a repeat, both of ``chain_gate_controls``
    failing it.  Returns (ok, line, figures)."""
    from mpqe_tpu_torch.ops import fused_fwd as ff

    d, bf16 = cfg.embed_dim, torch.bfloat16
    L = len(ws)
    blocks = ff.chain_blocks(cfg, structure)
    fblocks = ff.chain_blocks(cfg, structure, fold_bias=True)
    with torch.no_grad():
        ob = ff._chain_forward(x0, ws, bs, d, blocks, bf16)
        ob2 = ff._chain_forward(x0, ws, bs, d, blocks, bf16)
        fx0, fws, fbs, n_a, dp = chain_operands(model, cfg, structure, args,
                                                fold_bias=True)
        fk = ff._chain_forward(fx0, fws, fbs, d, fblocks)
        fk2 = ff._chain_forward(fx0, fws, fbs, d, fblocks)
        fplain = ff._chain_forward_plain(fx0, fws, fbs, d)
        v_slots = ff._plan(cfg, structure)[4]
        _, m8 = ff._var_layout(cfg, len(v_slots), dp)
        w0 = fws[0].clone()
        w0[n_a * dp + len(v_slots) * m8] = 0  # the folded bias row
        fctrl = ff._chain_forward_plain(fx0, [w0, *fws[1:]], fbs, d)
        fkb = ff._chain_backward(fx0, fws, fbs, g, n_a, d, dp, fblocks)
        fkb2 = ff._chain_backward(fx0, fws, fbs, g, n_a, d, dp, fblocks)
        fpb = ff._chain_backward_plain(fx0, fws, fbs, g, n_a, d, dp)
        fcb = [ff._chain_backward_plain(x, w, fbs, g, n_a, d, dp)
               for _, x, w in ff.chain_gate_controls(fx0, fws, fblocks, n_a,
                                                     d)]
    torch.cuda.synchronize()
    fleaves = [fkb[0], *fkb[1], *fkb[2]]
    for t in (fk, ob.float(), *fleaves):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{structure}: K1/K2 variant non-finite")
    obf16_equal = bool(torch.equal(bits(ob), bits(got.to(bf16))))
    repeat = bool(torch.equal(bits(ob), bits(ob2)) and torch.equal(fk, fk2)
                  and all(torch.equal(a, b) for a, b in zip(
                      fleaves, [fkb2[0], *fkb2[1], *fkb2[2]])))
    gate = ff.chain_gate(fk, fplain, L)
    control_fails = not ff.chain_gate(fk, fctrl, L)["ok"]
    bgate = ff.chain_gate(fkb, fpb, L, fblocks)
    bcontrols_fail = all(not ff.chain_gate(fkb, cb, L, fblocks)["ok"]
                         for cb in fcb)
    e_unfolded = rel_err(fk, got)
    ok = (obf16_equal and repeat and gate["ok"] and control_fails
          and e_unfolded <= K1_FOLD_TOL and bgate["ok"] and bcontrols_fail)
    line = (f"out_bf16_bit_equal={obf16_equal} fold_gate_ok={gate['ok']} "
            f"({gate_text(gate)}) fold_control_fails={control_fails} "
            f"fold_vs_unfolded={e_unfolded:.3e} (tol {K1_FOLD_TOL:g}) "
            f"fold_bwd_gate_ok={bgate['ok']} ({gate_text(bgate)}) "
            f"fold_bwd_controls_fail={bcontrols_fail} "
            f"variants_repeat_equal={repeat}")
    return ok, line, {"fold_abs_err": float((fk - fplain).abs().max()),
                      "fold_operands": (fx0, fws, fbs, fblocks),
                      "out_bf16": ob}


K1_VARIANTS = ("out_bf16", "fold_bias")


def time_k1_variants(cfg, structure: str, B: int, base, fold, lib_fwd: float,
                     acc: dict, gen, flush) -> None:
    """Kernel, plain and yardstick ms of K1's variants on one batch,
    added to ``acc[variant]`` beside each one's bound.  ``base``: (x0, ws,
    bs, blocks) of K1; ``fold``: its fold_bias operands (x0, ws, bs,
    blocks).  The yardstick of ``out_bf16`` is K1's (``lib_fwd``: the
    same bf16 products); ``fold_bias``'s multiplies its own W_0."""
    from mpqe_tpu_torch.ops import fused_fwd as ff

    d, bf16 = cfg.embed_dim, torch.bfloat16
    x0, ws, bs, blocks = base
    fx0, fws, fbs, fblocks = fold
    runs = {
        "out_bf16": (lambda: ff._chain_forward(x0, ws, bs, d, blocks, bf16),
                     lambda: ff._chain_forward_plain(x0, ws, bs, d,
                                                     out_dtype=bf16),
                     None, dict(out_bf16=True)),
        "fold_bias": (lambda: ff._chain_forward(fx0, fws, fbs, d, fblocks),
                      lambda: ff._chain_forward_plain(fx0, fws, fbs, d),
                      library_chain(fx0, fws, False, gen),
                      dict(fold_bias=True)),
    }
    for v, (kfn, pfn, lib, kw) in runs.items():
        with torch.no_grad():
            ms = time_ms(kfn, ITERS, flush)
            plain_ms = time_ms(pfn, PLAIN_ITERS, flush)
            lib_ms = lib_fwd if lib is None else time_ms(lib, ITERS, flush)
        work = chain_work(cfg, structure, B, False, **kw)
        t_bytes, t_ops = bound_times(work)
        a = acc[v]
        a["ms"] += ms
        a["plain_ms"] += plain_ms
        a["library_ms"] += lib_ms
        a["bound_ms"] += max(t_bytes, t_ops)
        a["bytes_ms"] += t_bytes
        a["ops_ms"] += t_ops
        log(f"kernel.fused_tgt.{v} {structure:14s} B={B} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={max(t_bytes, t_ops):.6f} "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{work[0]} B, {work[1]} bf16 FLOP, {work[2]} f32 FLOP)")


def library_chain(x0, ws, backward: bool, gen):
    """The yardstick: the same per-layer products through
    ``torch.matmul`` on bf16 operands (never called by the port)."""
    xs, x = [], x0
    with torch.no_grad():
        for w in ws:
            xs.append(x)
            x = torch.relu(torch.matmul(x, w))
    if not backward:
        return lambda: [torch.matmul(a, w) for a, w in zip(xs, ws)]
    gs = [torch.randn((x0.shape[0], w.shape[1]), generator=gen,
                      device=gen.device).to(torch.bfloat16) for w in ws]

    def fn():
        for a, w, g in zip(xs, ws, gs):
            torch.matmul(a, w)
            torch.matmul(a.t(), g)
            torch.matmul(g, w.t())

    return fn


def tree_rel_err(got: dict, want: dict) -> float:
    """max over leaves of max|got - want| / max|want| (leaves where want
    is zero everywhere are skipped)."""
    worst = 0.0
    for name, w in want.items():
        if w is not None and bool(w.abs().max() > 0):
            worst = max(worst, rel_err(got[name], w))
    return worst


def tree_mean_err(got: dict, want: dict) -> float:
    """max over leaves of mean|got - want| / mean|want|."""
    worst = 0.0
    for name, w in want.items():
        if w is not None and bool(w.abs().max() > 0):
            worst = max(worst, float((got[name] - w).abs().mean()
                                     / w.abs().mean()))
    return worst


def tree_change_err(got: dict, want: dict) -> float:
    """max over leaves of mean|got - want| / mean|want|, for two runs'
    changes of each parameter (tensors or arrays); a leaf that ``want``
    leaves unchanged must be unchanged in ``got`` (else inf)."""
    worst = 0.0
    for name, w in want.items():
        w, g = torch.as_tensor(w), torch.as_tensor(got[name])
        if not bool((w != 0).any()):
            if bool((g != 0).any()):
                return float("inf")
            continue
        worst = max(worst, float((g - w).abs().mean() / w.abs().mean()))
    return worst


def gate_text(gate: dict) -> str:
    return " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in gate.items() if k != "ok")


def phase_fused_tgt(model, cfg, device, gen, flush):
    """K1 and K2 against their plain versions under ``chain_gate`` (the
    kernels' products run on the tensor cores), with both negative
    controls failing it and a repeat launch bit-equal; K1 against the f32
    encoder and K2's gradients against its autograd; times at the train
    batches.  Returns both kernels' JSON fields (launches excluded)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    d = cfg.embed_dim
    names = list(dict(model.named_parameters()))
    out = {}
    for kind in ("fwd", "bwd"):
        out[kind] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                         bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                         library_ms=0.0)
    variants = {v: dict(out["fwd"]) for v in K1_VARIANTS}
    dev_ms = {"fwd": 0.0, "bwd": 0.0}
    big = {"fwd": [], "bwd": []}
    big_variants = {v: 0.0 for v in K1_VARIANTS}
    for structure in STRUCTURE_NAMES:
        depth = mpqe_mod.num_steps(cfg, structure)
        blocks = ff.chain_blocks(cfg, structure)
        for B in (TRAIN_BATCH, RAGGED):
            args = shared_inputs(gen, cfg, structure, B)
            x0, ws, bs, n_a, dp = chain_operands(model, cfg, structure, args)
            g = torch.randn((B, d), generator=gen, device=device)
            with torch.no_grad():
                got = ff._chain_forward(x0, ws, bs, d, blocks)
                again = ff._chain_forward(x0, ws, bs, d, blocks)
                plain = ff._chain_forward_plain(x0, ws, bs, d)
                f32 = mpqe_mod.encode_dense(model, cfg, structure, *args)
                kb = ff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
                kb2 = ff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
                pb = ff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp)
                controls = []
                for name, x, w in ff.chain_gate_controls(x0, ws, blocks,
                                                         n_a, d):
                    controls.append((
                        name, ff._chain_forward_plain(x, w, bs, d),
                        ff._chain_backward_plain(x, w, bs, g, n_a, d, dp)))
            dpar, den, _ = ff.fused_tgt_backward(model, cfg, structure, *args,
                                                 None, g)
            en = args[3].clone().requires_grad_()
            q = mpqe_mod.encode_dense(model, cfg, structure, *args[:3], en)
            ref = torch.autograd.grad(
                q, list(model.parameters()) + [en], g, allow_unused=True)
            torch.cuda.synchronize()
            kleaves = [kb[0], *kb[1], *kb[2]]
            for t in (got, *kleaves):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"{structure} B={B}: non-finite")
            repeat = bool(torch.equal(got, again)) and all(
                torch.equal(a, b) for a, b in zip(
                    kleaves, [kb2[0], *kb2[1], *kb2[2]]))
            L = len(ws)
            gf = ff.chain_gate(got, plain, L)
            gb = ff.chain_gate(kb, pb, L, blocks)
            fails = [not ff.chain_gate(got, cf, L)["ok"]
                     and not ff.chain_gate(kb, cb, L, blocks)["ok"]
                     for _, cf, cb in controls]
            e_f32 = rel_err(got, f32)
            got_g = {n: dpar[n] for n in names}
            want_g = dict(zip(names, ref[:-1]))
            e_grad = tree_mean_err(got_g, want_g)
            e_grad_max = tree_rel_err(got_g, want_g)
            # edge_norm's cotangent is a sum over the batch with heavy
            # cancellation, so its relative error is ill-conditioned:
            # printed, not gated (it is data, not a parameter)
            e_den = rel_err(den, ref[-1])
            masks = [blocks.mask(li).to(device) for li in range(L)]
            out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"], float(
                (got - plain).abs().max()))
            out["bwd"]["max_abs_err"] = max(
                out["bwd"]["max_abs_err"], float((kb[0] - pb[0]).abs().max()),
                *(float((a - b)[m].abs().max())
                  for a, b, m in zip(kb[1], pb[1], masks)),
                *(float((a - b).abs().max()) for a, b in zip(kb[2], pb[2])))
            tol_grad = TOL_GRAD_BY_DEPTH[depth]
            line = (f"kernel.fused_tgt {structure:14s} B={B:5d} "
                    f"fwd_gate_ok={gf['ok']} ({gate_text(gf)}) "
                    f"bwd_gate_ok={gb['ok']} ({gate_text(gb)}) "
                    f"controls_fail={all(fails)} repeat_equal={repeat} "
                    f"fwd_err_vs_f32={e_f32:.3e} "
                    f"grad_mean_err_vs_f32_autograd={e_grad:.3e} "
                    f"(tol {tol_grad:g}, depth {depth}; max-element "
                    f"{e_grad_max:.3e}; edge_norm {e_den:.3e})")
            if (not gf["ok"] or not gb["ok"] or not all(fails) or not repeat
                    or e_f32 > TOL_F32 or e_grad > tol_grad):
                log(line + " FAIL")
                raise AssertionError(line)
            log(line)
            vok, vline, vfig = check_k1_variants(model, cfg, structure, args,
                                                 x0, ws, bs, got, g)
            vline = f"kernel.fused_tgt.variants {structure:14s} B={B:5d} " \
                + vline
            if not vok:
                log(vline + " FAIL")
                raise AssertionError(vline)
            log(vline)
            variants["out_bf16"]["max_abs_err"] = max(
                variants["out_bf16"]["max_abs_err"], float(
                    (vfig["out_bf16"].float()
                     - plain.to(torch.bfloat16).float()).abs().max()))
            variants["fold_bias"]["max_abs_err"] = max(
                variants["fold_bias"]["max_abs_err"], vfig["fold_abs_err"])
            if B != TRAIN_BATCH:
                continue
            lib_fwd = 0.0
            for kind, bwd in (("fwd", False), ("bwd", True)):
                if bwd:
                    def kfn():
                        ff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)

                    def pfn():
                        ff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp)
                else:
                    def kfn():
                        ff._chain_forward(x0, ws, bs, d, blocks)

                    def pfn():
                        ff._chain_forward_plain(x0, ws, bs, d)
                with torch.no_grad():
                    ms = time_ms(kfn, ITERS, flush)
                    k_ms = device_ms(kfn, ITERS, flush)
                    plain_ms = time_ms(pfn, PLAIN_ITERS, flush)
                    lib_ms = time_ms(library_chain(x0, ws, bwd, gen), ITERS,
                                     flush)
                work = chain_work(cfg, structure, B, bwd)
                t_bytes, t_ops = bound_times(work)
                acc = out[kind]
                acc["ms"] += ms
                dev_ms[kind] += k_ms
                acc["plain_ms"] += plain_ms
                acc["library_ms"] += lib_ms
                acc["bound_ms"] += max(t_bytes, t_ops)
                acc["bytes_ms"] += t_bytes
                acc["ops_ms"] += t_ops
                lib_fwd = lib_ms if not bwd else lib_fwd
                log(f"kernel.fused_tgt{'_backward' if bwd else ''} "
                    f"{structure:14s} B={B} kernel_ms={ms:.4f} "
                    f"device_ms={k_ms:.4f} "
                    f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={max(t_bytes, t_ops):.6f} "
                    f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
                    f"{work[0]} B, {work[1]} bf16 FLOP, {work[2]} f32 FLOP)")
            time_k1_variants(cfg, structure, B, (x0, ws, bs, blocks),
                             vfig["fold_operands"], lib_fwd, variants, gen,
                             flush)
        # the flagship train batch: kernel, bound and yardstick only
        args = shared_inputs(gen, cfg, structure, TRAIN_BIG)
        x0, ws, bs, n_a, dp = chain_operands(model, cfg, structure, args)
        g = torch.randn((TRAIN_BIG, d), generator=gen, device=device)
        for kind, bwd in (("fwd", False), ("bwd", True)):
            kfn = ((lambda: ff._chain_backward(x0, ws, bs, g, n_a, d, dp,
                                               blocks))
                   if bwd else (lambda: ff._chain_forward(x0, ws, bs, d,
                                                          blocks)))
            with torch.no_grad():
                ms = time_ms(kfn, BIG_ITERS, flush)
                k_ms = device_ms(kfn, BIG_ITERS, flush)
                lib_ms = time_ms(library_chain(x0, ws, bwd, gen), BIG_ITERS,
                                 flush)
            work = chain_work(cfg, structure, TRAIN_BIG, bwd)
            t_bytes, t_ops = bound_times(work)
            big[kind].append((ms, k_ms, lib_ms, max(t_bytes, t_ops)))
            log(f"kernel.fused_tgt{'_backward' if bwd else ''} "
                f"{structure:14s} B={TRAIN_BIG} kernel_ms={ms:.4f} "
                f"device_ms={k_ms:.4f} "
                f"library_ms={lib_ms:.4f} "
                f"bound_ms={max(t_bytes, t_ops):.6f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
                f"{work[0]} B, {work[1]} bf16 FLOP, {work[2]} f32 FLOP)")
            if not bwd:
                base_ms = ms
        fx0, fws, fbs, _, _ = chain_operands(model, cfg, structure, args,
                                             fold_bias=True)
        fblocks = ff.chain_blocks(cfg, structure, fold_bias=True)
        with torch.no_grad():
            v_ms = {"out_bf16": time_ms(lambda: ff._chain_forward(
                        x0, ws, bs, d, blocks, torch.bfloat16), BIG_ITERS,
                        flush),
                    "fold_bias": time_ms(lambda: ff._chain_forward(
                        fx0, fws, fbs, d, fblocks), BIG_ITERS, flush)}
        for v, t in v_ms.items():
            big_variants[v] += t
        log(f"kernel.fused_tgt.variants {structure:14s} B={TRAIN_BIG} "
            f"kernel_ms base={base_ms:.4f} out_bf16={v_ms['out_bf16']:.4f} "
            f"fold_bias={v_ms['fold_bias']:.4f}")
        del x0, ws, bs, g, args, fx0, fws, fbs
    fields = {}
    for kind in ("fwd", "bwd"):
        acc = out[kind]
        by = "bytes" if acc.pop("bytes_ms") >= acc.pop("ops_ms") else \
            "operations"
        fields[kind] = {**acc, "bound_by": by}
        log(f"kernel.fused_tgt{'_backward' if kind == 'bwd' else ''} sum of "
            f"7 at B={TRAIN_BATCH}: kernel_ms={acc['ms']:.4f} "
            f"device_ms={dev_ms[kind]:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f} ({by}); at B={TRAIN_BIG}: "
            + " ".join(f"{name}={sum(r[i] for r in big[kind]):.4f}"
                       for i, name in enumerate(("kernel_ms", "device_ms",
                                                 "library_ms")))
            + f" bound_ms={sum(r[3] for r in big[kind]):.6f}")
    fields["fwd"]["variants"] = {}
    for v, acc in variants.items():
        by = "bytes" if acc.pop("bytes_ms") >= acc.pop("ops_ms") else \
            "operations"
        fields["fwd"]["variants"][v] = {**acc, "bound_by": by,
                                        "big_ms": big_variants[v]}
        log(f"kernel.fused_tgt.variants {v} sum of 7 at B={TRAIN_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f} ({by}) "
            f"max_abs_err={acc['max_abs_err']:.3e}; at B={TRAIN_BIG}: "
            f"kernel_ms={big_variants[v]:.4f}")
    return fields


def phase_fused_tgt_bf16(model, cfg, device, gen, flush):
    """K1 and K2 at ``cfg.dtype = bfloat16`` (``kernel.fused_tgt.bf16``):
    on the bf16 model's operands, K1's f32 output and K2's (dA, dW, db)
    under ``chain_gate`` against their plain versions, both controls of
    ``chain_gate_controls`` failing it; K1 through the wrapper returns
    bf16, bit-equal to its own f32 output rounded (the ``out_bf16``
    store) and to a repeat, within TOL_F32 of the f32 ``encode_dense`` of
    the same bf16 values; K2's parameter gradients (K2's chain gradients
    mapped by autograd through the weight assembly) come back in bf16,
    bit-equal to a repeat and, per leaf in mean|diff| / mean|ref|, within
    ``ops/fused_fwd.py PARAM_GRAD_MEAN_BY_DEPTH`` of the plain K2's, whose
    control (one basis's gradient moved by 4x that limit) fails it and
    passes the depth tolerance TOL_GRAD_BY_DEPTH it replaces.
    (``chain_gate``'s own leaf criteria hold at the chain level, where
    they were derived: the assembly sums each basis gradient over edges
    and coefficients of both signs, and on the card that cancellation
    lifted the mean form to ~5e-4 at 3-chain while the chain's leaves
    stayed ~5e-5.)  Times K1
    (bf16 store) and K2 on the bf16 model's operands at B = 512 and
    131,072.  Returns the variant's JSON fields."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    d, bf16 = cfg.embed_dim, torch.bfloat16
    model16, cfg16, model32, cfg32 = bf16_twin(model, cfg)
    acc = dict(max_abs_err=0.0, ms=0.0, bwd_ms=0.0, plain_ms=0.0,
               bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, big_ms=0.0,
               big_bwd_ms=0.0)
    for structure in STRUCTURE_NAMES:
        blocks = ff.chain_blocks(cfg16, structure)
        depth = mpqe_mod.num_steps(cfg, structure)
        tol_grad = ff.PARAM_GRAD_MEAN_BY_DEPTH[depth]
        for B in (TRAIN_BATCH, RAGGED):
            args = shared_inputs(gen, cfg, structure, B)
            x0, ws, bs, n_a, dp = chain_operands(model16, cfg16, structure,
                                                 args)
            L = len(ws)
            g16 = torch.randn((B, d), generator=gen, device=device).to(bf16)
            g = g16.float()
            with torch.no_grad():
                got = ff._chain_forward(x0, ws, bs, d, blocks)
                plain = ff._chain_forward_plain(x0, ws, bs, d)
                out16 = ff.fused_tgt_forward(model16, cfg16, structure,
                                             *args)
                again = ff.fused_tgt_forward(model16, cfg16, structure,
                                             *args)
                kb = ff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
                pb = ff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp)
                f32 = mpqe_mod.encode_dense(model32, cfg32, structure, *args)
                controls = [(ff._chain_forward_plain(x, w, bs, d),
                             ff._chain_backward_plain(x, w, bs, g, n_a, d,
                                                      dp))
                            for _, x, w in ff.chain_gate_controls(
                                x0, ws, blocks, n_a, d)]
            dk, _, _ = ff.fused_tgt_backward(model16, cfg16, structure,
                                             *args, None, g16)
            dk2, _, _ = ff.fused_tgt_backward(model16, cfg16, structure,
                                              *args, None, g16)
            dp_, _, _ = ff.fused_tgt_backward_reference(
                model16, cfg16, structure, *args, None, g16)
            torch.cuda.synchronize()
            gf = ff.chain_gate(got, plain, L)
            gb = ff.chain_gate(kb, pb, L, blocks)
            fails = all(not ff.chain_gate(got, cf, L)["ok"]
                        and not ff.chain_gate(kb, cb, L, blocks)["ok"]
                        for cf, cb in controls)
            e_param = ff.param_grad_mean_err(dk, dp_)
            e_ctrl = ff.param_grad_mean_err(
                ff.param_grad_control(dk, dp_, depth), dp_)
            ctrl_ok = tol_grad < e_ctrl <= TOL_GRAD_BY_DEPTH[depth]
            dtypes_ok = out16.dtype == bf16 and all(
                t.dtype == bf16 for t in dk.values())
            finite = bool(torch.isfinite(got).all()) and all(
                bool(torch.isfinite(t).all()) for t in dk.values())
            store_equal = bool(torch.equal(bits(out16), bits(got.to(bf16))))
            repeat = bool(torch.equal(bits(out16), bits(again))) and all(
                torch.equal(dk[n], dk2[n]) for n in dk)
            e_f32 = rel_err(out16.float(), f32)
            acc["max_abs_err"] = max(acc["max_abs_err"],
                                     float((got - plain).abs().max()))
            line = (f"kernel.fused_tgt.bf16 {structure:14s} B={B:5d} "
                    f"fwd_gate_ok={gf['ok']} ({gate_text(gf)}) "
                    f"bwd_gate_ok={gb['ok']} ({gate_text(gb)}) "
                    f"controls_fail={fails} param_grad_mean_err_vs_plain="
                    f"{e_param:.3e} (tol {tol_grad:g}; control "
                    f"{e_ctrl:.3e} fails it, passes the old "
                    f"{TOL_GRAD_BY_DEPTH[depth]:g}: {ctrl_ok}) "
                    f"bf16_out_and_grads={dtypes_ok} out_bf16_bit_equal="
                    f"{store_equal} repeat_equal={repeat} "
                    f"fwd_err_vs_f32={e_f32:.3e}")
            if not (gf["ok"] and gb["ok"] and fails and e_param <= tol_grad
                    and ctrl_ok and dtypes_ok and finite and store_equal
                    and repeat and e_f32 <= TOL_F32):
                log(line + " FAIL")
                raise AssertionError(line)
            if B == TRAIN_BATCH:
                with torch.no_grad():
                    ms = time_ms(lambda: ff._chain_forward(
                        x0, ws, bs, d, blocks, bf16), ITERS, flush)
                    bwd_ms = time_ms(lambda: ff._chain_backward(
                        x0, ws, bs, g, n_a, d, dp, blocks), ITERS, flush)
                    plain_ms = time_ms(lambda: ff._chain_forward_plain(
                        x0, ws, bs, d, out_dtype=bf16), PLAIN_ITERS, flush)
                t_bytes, t_ops = bound_times(chain_work(
                    cfg16, structure, B, False, out_bf16=True))
                for k, v in (("ms", ms), ("bwd_ms", bwd_ms),
                             ("plain_ms", plain_ms),
                             ("bound_ms", max(t_bytes, t_ops)),
                             ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
                    acc[k] += v
                line += (f" kernel_ms={ms:.4f} k2_kernel_ms={bwd_ms:.4f} "
                         f"plain_ms={plain_ms:.4f} "
                         f"bound_ms={max(t_bytes, t_ops):.6f}")
            log(line)
        args = shared_inputs(gen, cfg, structure, TRAIN_BIG)
        x0, ws, bs, n_a, dp = chain_operands(model16, cfg16, structure, args)
        g = torch.randn((TRAIN_BIG, d), generator=gen, device=device).to(
            bf16).float()
        with torch.no_grad():
            big = time_ms(lambda: ff._chain_forward(x0, ws, bs, d, blocks,
                                                    bf16), BIG_ITERS, flush)
            big_bwd = time_ms(lambda: ff._chain_backward(
                x0, ws, bs, g, n_a, d, dp, blocks), BIG_ITERS, flush)
        acc["big_ms"] += big
        acc["big_bwd_ms"] += big_bwd
        log(f"kernel.fused_tgt.bf16 {structure:14s} B={TRAIN_BIG} "
            f"kernel_ms={big:.4f} k2_kernel_ms={big_bwd:.4f}")
        del x0, ws, bs, g, args
    by = "bytes" if acc.pop("bytes_ms") >= acc.pop("ops_ms") else \
        "operations"
    log(f"kernel.fused_tgt.bf16 sum of 7 at B={TRAIN_BATCH}: K1 kernel_ms="
        f"{acc['ms']:.4f} K2 kernel_ms={acc['bwd_ms']:.4f} plain_ms="
        f"{acc['plain_ms']:.4f} bound_ms={acc['bound_ms']:.6f} ({by}); at "
        f"B={TRAIN_BIG}: K1 kernel_ms={acc['big_ms']:.4f} K2 kernel_ms="
        f"{acc['big_bwd_ms']:.4f}; max_abs_err={acc['max_abs_err']:.3e}")
    del model16, model32
    return {**acc, "bound_by": by}


def profile_device(label: str, fn, top: int = 8, also=()) -> None:
    """Device time by kernel over ``fn()`` and the device's busy share of
    its wall time (``profiling.device_profile``): the ``top`` kernels,
    then any other whose name contains one of ``also``."""
    from mpqe_tpu_torch.utils.profiling import device_profile

    wall_us, rows = device_profile(fn)
    busy = sum(r[0] for r in rows)
    log(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%)")
    shown = rows[:top] + [r for r in rows[top:]
                          if any(a in r[2] for a in also)]
    for us, count, key in shown:
        log(f"{label}:   {us / 1e3:9.3f} ms {count:5d}x "
            f"{100 * us / wall_us:5.1f}% of wall {100 * us / busy:5.1f}% "
            f"of busy {key[:90]}")


class PlainChain(torch.autograd.Function):
    """``FusedChain`` of ``mpqe_tpu_torch/ops/fused_fwd.py`` with the plain
    versions of K1 and K2 in place of the kernels: same operands, same
    rounding, gradients routed the same way (the train-step recheck)."""

    @staticmethod
    def forward(ctx, node_mode, layout, *tensors):
        from mpqe_tpu_torch.ops import fused_fwd as ff

        cfg, v_slots, d_pad, n_a, _ = layout
        L = (len(tensors) - n_a) // 2
        cols, Ws, bs = tensors[:n_a], tensors[n_a:n_a + L], tensors[n_a + L:]
        x0 = ff._layer0_operand(cols, node_mode, v_slots, cfg, d_pad)
        ws = [W.to(torch.bfloat16) for W in Ws]
        ctx.save_for_backward(x0, *ws, *bs)
        ctx.meta = (n_a, L, cfg.embed_dim, d_pad)
        return ff._chain_forward_plain(x0, ws, bs, cfg.embed_dim)

    @staticmethod
    def backward(ctx, g):
        from mpqe_tpu_torch.ops import fused_fwd as ff

        n_a, L, d, d_pad = ctx.meta
        x0, *rest = ctx.saved_tensors
        da, dws, dbs = ff._chain_backward_plain(
            x0, rest[:L], rest[L:], g.to(torch.float32), n_a, d, d_pad)
        return (None, None, *(da[:, k] for k in range(n_a)), *dws, *dbs)


def recheck_train_step(state, cfg, stores, device) -> None:
    """One step per structure from the trained state, through the kernels
    and through their plain versions (:class:`PlainChain`) on the card:
    the same loss (<= TOL_PLAIN relative) and gradients, per leaf
    mean|diff| / mean|ref| <= TOL_PLAIN (the kernels' products take the
    tensor cores' sum order, so a bf16 flip may move single elements; the
    max-element figure is printed beside the gate, as for
    ``recheck_sparse_step``)."""
    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.train import loop as loop_mod

    model = state.model
    params = dict(model.named_parameters())
    for structure, f_stores in stores.items():
        fstore = max(f_stores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(
            fstore, np.arange(fstore.n_queries), TRAIN_BATCH, 4, 11)
        t = loop_mod.batch_tensors(batch, device)
        loss_k = mpqe_mod.dense_batch_loss_kernel_fused_fwd(
            model, cfg, structure, *t, backward="pallas")
        g_k = torch.autograd.grad(loss_k, list(params.values()),
                                  allow_unused=True)
        v_slots, d_pad, cols, Ws, bs = ff._assemble(model, cfg, structure,
                                                    *t[:4], None)
        q = PlainChain.apply(t[1], (cfg, tuple(v_slots), d_pad, len(cols),
                                    None), *cols, *Ws, *bs)
        loss_p = mpqe_mod.margin_loss_from_queries(model, cfg, q, *t[4:])
        g_p = torch.autograd.grad(loss_p, list(params.values()),
                                  allow_unused=True)
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        e_loss = abs(lk - lp) / max(abs(lp), 1e-12)
        gk, gp = dict(zip(params, g_k)), dict(zip(params, g_p))
        e_grad = tree_mean_err(gk, gp)
        e_grad_max = tree_rel_err(gk, gp)
        line = (f"train.recheck {structure:14s} loss={lk:.6f} "
                f"loss_err={e_loss:.3e} grad_mean_err={e_grad:.3e} "
                f"grad_max_err={e_grad_max:.3e}")
        log(line)
        if e_loss > TOL_PLAIN or e_grad > TOL_PLAIN or not np.isfinite(lk):
            raise AssertionError(line)


def sample_train_queries(kg):
    """(train, val) queries of every structure, grouped by formula."""
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, group_queries_by_formula

    t0 = time.perf_counter()
    sampler = QuerySampler(kg, seed=7)
    train_q, val_q = [], []
    for s in STRUCTURE_NAMES:
        train_q += sampler.sample_queries(s, 256, n_neg=32)
        val_q += sampler.sample_queries(s, 64, n_neg=64)
    log(f"setup: sampled train/val queries {time.perf_counter() - t0:.2f} s")
    return group_queries_by_formula(train_q), group_queries_by_formula(val_q)


def phase_train(kg, train_q, val_q, device):
    """``run_train`` on the card through K1/K2 with one validation round
    (K3).  Returns (K1 launches, K2 launches)."""
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    # burn-in off: no structure is named "none", so every structure
    # trains from the first step
    tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                              max_steps=TRAIN_STEPS, val_every=TRAIN_STEPS,
                              burn_in_structure="none", seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device)

    real = []  # per step, the batch's real rows (the sum of query_mask)

    def loss_fn(*a):
        real.append(a[-1].sum())
        return mpqe_mod.dense_batch_loss_kernel_fused_fwd(*a,
                                                          backward="pallas")

    t0 = time.perf_counter()
    loop_mod.warmup_train_step(
        lambda opt: loop_mod.make_train_step(cfg, opt, loss_fn), cfg, tc,
        STRUCTURE_NAMES, device)
    torch.cuda.synchronize()
    log(f"setup: warmup (one throwaway step per structure) "
        f"{time.perf_counter() - t0:.2f} s")

    records = []

    ff.fused_tgt_forward.launches = 0
    ff.fused_tgt_backward.launches = 0
    ff.fused_tgt_forward_multi.launches = 0
    real.clear()
    t0 = time.perf_counter()
    loop_mod.run_train(state, cfg, tc, train_q, val_queries=val_q,
                       log_fn=records.append, batch_loss_fn=loss_fn, kg=kg)
    wall = time.perf_counter() - t0
    k1 = ff.fused_tgt_forward.launches
    k2 = ff.fused_tgt_backward.launches
    k3 = ff.fused_tgt_forward_multi.launches
    losses = [r["loss"] for r in records if "loss" in r]
    vals = [r["val"] for r in records if "val" in r]
    log(f"train: {state.step} steps in {wall:.2f} s; launches K1={k1} "
        f"K2={k2} K3={k3}; loss first={losses[0]:.6f} "
        f"last={losses[-1]:.6f}; val macro_auc="
        f"{vals[-1]['auc_macro'] if vals else float('nan'):.4f}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {len(losses)} steps, finite: "
                             f"{all(np.isfinite(losses))}")
    if not (k1 == k2 == TRAIN_STEPS) or k3 == 0 or not vals:
        raise AssertionError(f"launches K1={k1} K2={k2} K3={k3}, "
                             f"{len(vals)} validation rounds")
    # each step's seconds end with the host reading its loss
    ms = np.asarray([r["seconds"] * 1e3 for r in records if "loss" in r])
    n_real = int(torch.stack(real).sum())
    stores = build_stores(train_q, kg=kg)
    per_formula = [f.n_queries for fs in stores.values() for f in fs]
    name = torch.cuda.get_device_name(device)
    STEP_MS["train"] = (np.percentile(ms, 50), np.percentile(ms, 95))
    # a batch holds the queries of one formula; on this KG nearly every
    # sampled formula is unique, so the batches are mostly padding
    log(f"train: {len(ms)} steps of batch {TRAIN_BATCH} on {name}: "
        f"step_ms_p50={np.percentile(ms, 50):.3f} "
        f"step_ms_p95={np.percentile(ms, 95):.3f} "
        f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} "
        f"({n_real} real rows of {len(ms) * TRAIN_BATCH}; "
        f"{np.mean(per_formula):.2f} queries per formula over "
        f"{len(per_formula)} formulas) "
        f"padded_rows_per_s={len(ms) * TRAIN_BATCH / ms.sum() * 1e3:.1f}")

    recheck_train_step(state, cfg, stores, device)
    ptc = dataclasses.replace(tc, max_steps=PROFILE_STEPS, val_every=1 << 30)
    profile_device(f"train.profile ({PROFILE_STEPS} steps)",
                   lambda: loop_mod.run_train(state, cfg, ptc, train_q,
                                              batch_loss_fn=loss_fn, kg=kg),
                   also=TGT_KERNELS)
    return k1, k2


def phase_train_cli(kernel_args, then=None, label="train.cli") -> None:
    """``python -m mpqe_tpu_torch.train`` with ``kernel_args`` on the card
    as a subprocess: its final line and its run dir, handed to ``then``
    before it is deleted."""
    import os
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "mpqe_tpu_torch.train",
               "--data", "synthetic", *kernel_args, "--steps", "20",
               "--val_every", "10", "--num_bases", "16", "--n_neg", "4",
               "--syn_entities", "20000", "--syn_modes", "4",
               "--syn_rels", "20", "--syn_triples", "60000",
               "--syn_train_queries", "700", "--syn_val_queries", "140",
               "--run_dir", run_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        log(f"{label} {' '.join(kernel_args)}: rc={proc.returncode} "
            f"{time.perf_counter() - t0:.2f} s: {last}")
        if proc.returncode != 0:
            raise AssertionError(f"train CLI failed:\n{proc.stderr[-4000:]}")
        if not re.fullmatch(r"final step=20 macro_auc=\S+ macro_apr=\S+",
                            last):
            raise AssertionError(f"unexpected final line {last!r}")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
        for f in ("config.json", "model_config.json", "metrics.jsonl"):
            if not os.path.isfile(os.path.join(run_dir, f)):
                raise AssertionError(f"run dir lacks {f}")
        if "step_20" not in ckpts:
            raise AssertionError(f"run dir checkpoints: {ckpts}")
        log(f"{label}: run dir holds config.json, model_config.json, "
            f"metrics.jsonl, ckpt/{','.join(ckpts)}")
        if then is not None:
            then(run_dir)


# ----------------------------------------------------------------------
# The sparse path: K5a / K5b (relation chunks) and K6a / K6b (blocked)
# ----------------------------------------------------------------------
K5_KERNELS = ("k5_msg_kernel", "k5_combine_kernel")
K6A_KERNELS = ("k6a_messages_kernel",)
K6B_KERNELS = ("k6b_grad_kernel", "k6b_dcoeff_kernel",
               "reduce_partials_kernel", "k6b_s_")
# widths beyond what K5 and K6 stage whole in shared memory: K5 at K = 768
# (N = K, and N != K), K6 at d = 256 and 512, all with 16 bases, on the
# 3-chain_inter template batch at the train batch
WIDE_K5 = ((768, 768), (768, 256))
WIDE_K6 = (256, 512)
WIDE_BASES = 16
WIDE_STRUCTURE = "3-chain_inter"


def general_store(cfg):
    """The reference's own kernel-bench graph
    (mpqe_tpu/ops/pallas_rgcn_blocked.py:57-58): GENERAL_NODES nodes and
    GENERAL_EDGES random typed edges, relation-sorted."""
    from mpqe_tpu_torch.ops.edge_store import build_edge_store

    rng = np.random.default_rng(5)
    n, e = GENERAL_NODES, GENERAL_EDGES
    return build_edge_store(rng.integers(0, n, e), rng.integers(0, n, e),
                            rng.integers(0, cfg.n_rels, e), n, cfg.n_rels)


def template_rel_norm(gen, cfg, structure):
    from mpqe_tpu_torch.queries import STRUCTURES

    ne = STRUCTURES[structure].n_edges
    er = torch.randint(0, cfg.n_rels, (ne,), generator=gen,
                       device=gen.device, dtype=torch.int32)
    return er, 0.5 + torch.rand((ne,), generator=gen, device=gen.device)


def k5_work(n_edges_pad: int, n_real: int, n_src_rows: int, K: int, N: int,
            weight_bytes: int, coeff_bytes: int, row_bytes: int = 4) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP, TF32 FLOP) of one K5 launch: the
    ``n_src_rows`` distinct rows of x that real edges gather (``row_bytes``
    an element: 2 for bf16 rows), the src ids and norms, the coefficients
    and relation ids, the weights (the basis once, or each distinct
    relation's W once) and the f32 output, each once; 2 K N f32 FLOP per
    real edge (padding edges need none), or 3 x that in TF32 on the tensor
    cores (split TF32: f32-grade products), the route ``bound_times`` takes
    when it is faster."""
    nbytes = (n_src_rows * K * row_bytes + n_edges_pad * (4 + 4 + N * 4)
              + coeff_bytes + weight_bytes)
    f32 = 2 * n_real * K * N
    return nbytes, 0, f32, 3 * f32


def k6_work(n_edges_pad: int, n_chunks: int, n_real: int, n_rows: int,
            K: int, N: int, bb: int, n_rels: int, grad: bool) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K6a (or K6b) launch: bf16 x
    (and g), bf16 basis, f32 coeff, the per-edge src/dst/rel/norm and the
    per-chunk block ids, the f32 output (or dbasis and dcoeff), each once;
    2 E Bb K N bf16 FLOP over the real edges for K6a (the products
    ``xs @ V_b``), twice that for K6b (those and ``xs^T rhs``), plus the
    f32 work outside those products: for K6a the coefficient scaling and
    sum over bases, the norm and the destination sum; for K6b ``gn``, the
    ``s_eb`` dot products and the ``rhs`` scaling."""
    edges = n_edges_pad * 16 + n_chunks * 8
    params = bb * K * N * 2 + n_rels * bb * 4
    if not grad:
        return (n_rows * K * 2 + params + edges + n_rows * N * 4,
                2 * n_real * bb * K * N, n_real * (2 * bb * N + 2 * N))
    return (n_rows * (K + N) * 2 + params + edges + bb * K * N * 4
            + n_rels * bb * 4, 4 * n_real * bb * K * N,
            n_real * (bb * 3 * N + N))


def add_case(acc: dict, ms, plain_ms, lib_ms, work, dev_ms=0.0):
    t_bytes, t_ops = bound_times(work)
    acc["ms"] += ms
    acc["plain_ms"] += plain_ms
    acc["library_ms"] += lib_ms
    acc["device_ms"] += dev_ms
    acc["bound_ms"] += max(t_bytes, t_ops)
    acc["bytes_ms"] += t_bytes
    acc["ops_ms"] += t_ops
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def new_acc() -> dict:
    return dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                bytes_ms=0.0, ops_ms=0.0, library_ms=0.0, device_ms=0.0)


def finish_acc(acc: dict) -> dict:
    """The JSON fields of an accumulator (sums over the 7 structures at
    the train batch)."""
    acc = dict(acc)
    by = "bytes" if acc.pop("bytes_ms") >= acc.pop("ops_ms") else \
        "operations"
    acc.pop("device_ms")
    return {**acc, "bound_by": by}


def work_line(ms, dev_ms, plain_ms, lib_ms, bound, by, work) -> str:
    return (f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} "
            + (f"plain_ms={plain_ms:.4f} " if plain_ms is not None else "")
            + f"library_ms={lib_ms:.4f} bound_ms={bound:.6f} ({by}: "
            f"{work[0]} B, {work[1]} bf16 FLOP, {work[2]} f32 FLOP"
            + (f" or {work[3]} TF32 FLOP" if len(work) > 3 else "") + ")")


def k5_cases(cfg, gen, device):
    """(label, B, chunked dict on the card, n_nodes) for the 7 structures
    at the train batch and the flagship train batch, then the general
    graph (chunk_by_relation, padded chunks)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    for B in (TRAIN_BATCH, TRAIN_BIG):
        for s in STRUCTURE_NAMES:
            er, en = template_rel_norm(gen, cfg, s)
            yield s, B, tl.template_chunked(s, er, en, B), \
                B * STRUCTURES[s].n_nodes
    ch = rf.chunk_by_relation(general_store(cfg))
    yield "general", 0, {k: (torch.from_numpy(v).to(device)
                             if isinstance(v, np.ndarray) else v)
                         for k, v in ch.items()}, GENERAL_NODES


def k5_control(coeff, crel, norm, chunk: int, basis_kind: bool, R: int):
    """The negative control's chunk coefficients (K5a) or relations (K5b):
    those of the first chunk with a real edge changed (its coefficient
    row negated and shifted, or the next relation)."""
    real = (norm.view(-1, chunk) != 0).any(1)
    c = int(torch.nonzero(real)[0, 0])
    bad = coeff.clone()
    if basis_kind:
        bad[c] = 1.0 - 2.0 * bad[c]
    else:
        bad[c] = (bad[c] + 1) % R
    return bad


def k5_operands(kid, basis, coeff, w_rel, crel, R, d_in, d_out):
    """(kernel, plain version, weights, kernel args, plain args, oracle
    weights, oracle coefficients, weight bytes, coefficient bytes, the
    per-chunk W) of K5a (``basis``, ``coeff``) or K5b (``w_rel``)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    n_used = int(torch.unique(crel[crel < R]).numel())
    if kid == "K5a":
        c = rf._masked_chunk_coeff(coeff, crel, R).contiguous()
        return (rf.messages_basis, rf.messages_basis_reference, basis,
                (coeff, crel, R), c, basis, coeff, basis.numel() * 4,
                n_used * basis.shape[0] * 4 + crel.numel() * 4,
                rf.combine_basis(basis, c))
    c = crel.clamp(0, R - 1)
    return (rf.messages_wrel, rf.messages_wrel_reference, w_rel, (crel,), c,
            w_rel, torch.eye(R, device=w_rel.device),
            n_used * d_in * d_out * 4, crel.numel() * 4, w_rel[c.long()])


def phase_rgcn_fused(layer_b, layer_f, cfg, device, gen, flush):
    """K5a (basis layer) and K5b (full-weight layer) against their plain
    versions (<= TOL_PLAIN) and the f32 batched oracle (<= TOL_ORACLE), a
    repeat launch bit-equal, the negative control (the plain version with
    one chunk's coefficients or relation changed) failing the plain gate,
    the transposed-weight read (the backward's) against the plain version
    on a transposed copy (<= TOL_PLAIN); times beside the bound, the plain
    version and the torch.bmm yardstick.  Returns both kernels' JSON fields
    (launches excluded)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    d, R = cfg.embed_dim, cfg.n_rels
    basis = layer_b.basis.detach()
    coeff = layer_b.coeff.detach()
    w_rel = layer_f.w_rel.detach()
    accs = {"K5a": new_acc(), "K5b": new_acc()}
    big = {"K5a": [], "K5b": []}
    f32_bound = {"K5a": 0.0, "K5b": 0.0}
    for label, B, ch, n in k5_cases(cfg, gen, device):
        src = ch["src"].to(torch.int32).contiguous()
        norm = ch["norm"].float().contiguous()
        crel = ch["chunk_rel"].to(torch.int32).contiguous()
        chunk = ch["chunk"]
        x = torch.randn((n, d), generator=gen, device=device)
        rows = torch.randn((src.shape[0], d), generator=gen, device=device)
        real = norm != 0
        n_real = int(real.sum())
        n_src_rows = int(torch.unique(src[real].clamp(0, n - 1)).numel())
        for kid in ("K5a", "K5b"):
            (fn, ref, w, kargs, c, oracle_w, oracle_c, weight_bytes,
             coeff_bytes, w_c) = k5_operands(kid, basis, coeff, w_rel, crel,
                                             R, d, d)
            with torch.no_grad():
                got = fn(x, src, w, *kargs, norm, chunk)
                again = fn(x, src, w, *kargs, norm, chunk)
                plain = ref(x, src, w, c, norm, chunk)
                oracle = rf._edge_messages_xla(x, oracle_w, oracle_c, src,
                                               norm, crel, R, chunk)
                cut = ref(x, src, w, k5_control(c, crel, norm, chunk,
                                                kid == "K5a", R),
                          norm, chunk)
                got_t = fn(rows, None, w, *kargs, norm, chunk,
                           w_transposed=True)
                plain_t = ref(rows, None, w.transpose(1, 2), c, norm, chunk)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kid} {label} B={B}: non-finite")
            e_plain, e_orc = rel_err(got, plain), rel_err(got, oracle)
            e_cut, e_t = rel_err(got, cut), rel_err(got_t, plain_t)
            repeat = torch.equal(got, again)
            accs[kid]["max_abs_err"] = max(accs[kid]["max_abs_err"], float(
                (got - plain).abs().max()))
            line = (f"kernel.rgcn_fused {kid} {label:14s} B={B:6d} "
                    f"E={src.shape[0]} err_vs_plain={e_plain:.3e} "
                    f"err_vs_f32_oracle={e_orc:.3e} repeat_equal={repeat} "
                    f"control_err={e_cut:.3e} transposed_err={e_t:.3e}")
            if (e_plain > TOL_PLAIN or e_orc > TOL_ORACLE or not repeat
                    or e_cut <= TOL_PLAIN or e_t > TOL_PLAIN):
                log(line + " FAIL")
                raise AssertionError(line)
            del again, cut, got_t, plain_t
            iters = ITERS if B == TRAIN_BATCH else BIG_ITERS
            xs_c = x[src.long().clamp(0, n - 1)].view(-1, chunk, d)
            with torch.no_grad():
                ms = time_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                             iters, flush)
                k_ms = device_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                                 iters, flush, K5_KERNELS,
                                 2 if kid == "K5a" else 1)
                plain_ms = time_ms(lambda: ref(x, src, w, c, norm, chunk),
                                   PLAIN_ITERS if B == TRAIN_BATCH else 1,
                                   flush)
                lib_ms = time_ms(lambda: torch.bmm(xs_c, w_c), iters, flush)
            work = k5_work(src.shape[0], n_real, n_src_rows, d, d,
                           weight_bytes, coeff_bytes)
            f32_ms = max(bound_times(work[:3]))  # the f32-pipe route
            if B == TRAIN_BATCH:
                bound, by = add_case(accs[kid], ms, plain_ms, lib_ms, work,
                                     k_ms)
                f32_bound[kid] += f32_ms
            else:
                t_b, t_o = bound_times(work)
                bound, by = max(t_b, t_o), ("bytes" if t_b >= t_o
                                            else "operations")
                big[kid].append((label, ms, k_ms, lib_ms, bound, f32_ms))
            log(line + " " + work_line(ms, k_ms, plain_ms, lib_ms, bound, by,
                                       work)
                + f" f32_route_bound_ms={f32_ms:.6f}")
            del got, plain, oracle, xs_c, w_c
        del x, rows
    fields = {}
    for kid, acc in accs.items():
        t7 = [v for v in big[kid] if v[0] != "general"]
        log(f"kernel.rgcn_fused {kid} sum of 7 at B={TRAIN_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f} "
            f"f32_route_bound_ms={f32_bound[kid]:.6f}; at B={TRAIN_BIG}: "
            + " ".join(f"{k}={sum(v[i] for v in t7):.4f}" for i, k in (
                (1, "kernel_ms"), (2, "device_ms"), (3, "library_ms"),
                (4, "bound_ms"), (5, "f32_route_bound_ms"))))
        fields[kid] = finish_acc(acc)
    wide_rgcn_fused(cfg, device, gen, flush)
    return fields


def wide_rgcn_fused(cfg, device, gen, flush):
    """K5a and K5b at the widths of WIDE_K5 (k in stages on the card), on
    the WIDE_STRUCTURE template at the train batch, random weights: the
    gates, repeat and negative control of :func:`phase_rgcn_fused`, and
    times beside the bound."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURES

    R, s, B = cfg.n_rels, WIDE_STRUCTURE, TRAIN_BATCH
    er, en = template_rel_norm(gen, cfg, s)
    ch = tl.template_chunked(s, er, en, B)
    n = B * STRUCTURES[s].n_nodes
    src = ch["src"].to(torch.int32).contiguous()
    norm = ch["norm"].float().contiguous()
    crel = ch["chunk_rel"].to(torch.int32).contiguous()
    chunk = ch["chunk"]
    real = norm != 0
    n_real = int(real.sum())
    n_src_rows = int(torch.unique(src[real].clamp(0, n - 1)).numel())
    for K, N in WIDE_K5:
        x = torch.randn((n, K), generator=gen, device=device)
        basis = torch.randn((WIDE_BASES, K, N), generator=gen,
                            device=device) / K ** 0.5
        coeff = torch.randn((R, WIDE_BASES), generator=gen, device=device)
        w_rel = torch.einsum("rb,bio->rio", coeff, basis).contiguous()
        for kid in ("K5a", "K5b"):
            (fn, ref, w, kargs, c, oracle_w, oracle_c, weight_bytes,
             coeff_bytes, _) = k5_operands(kid, basis, coeff, w_rel, crel, R,
                                           K, N)
            with torch.no_grad():
                got = fn(x, src, w, *kargs, norm, chunk)
                again = fn(x, src, w, *kargs, norm, chunk)
                plain = ref(x, src, w, c, norm, chunk)
                oracle = rf._edge_messages_xla(x, oracle_w, oracle_c, src,
                                               norm, crel, R, chunk)
                cut = ref(x, src, w, k5_control(c, crel, norm, chunk,
                                                kid == "K5a", R),
                          norm, chunk)
            torch.cuda.synchronize()
            e_plain, e_orc = rel_err(got, plain), rel_err(got, oracle)
            e_cut, repeat = rel_err(got, cut), torch.equal(got, again)
            line = (f"kernel.rgcn_fused.wide {kid} {s} B={B} K={K} N={N} "
                    f"E={src.shape[0]} err_vs_plain={e_plain:.3e} "
                    f"err_vs_f32_oracle={e_orc:.3e} repeat_equal={repeat} "
                    f"control_err={e_cut:.3e}")
            if (e_plain > TOL_PLAIN or e_orc > TOL_ORACLE or not repeat
                    or e_cut <= TOL_PLAIN
                    or not bool(torch.isfinite(got).all())):
                log(line + " FAIL")
                raise AssertionError(line)
            del again, plain, oracle, cut
            with torch.no_grad():
                ms = time_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                             ITERS, flush)
                k_ms = device_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                                 ITERS, flush, K5_KERNELS,
                                 2 if kid == "K5a" else 1)
            work = k5_work(src.shape[0], n_real, n_src_rows, K, N,
                           weight_bytes, coeff_bytes)
            t_b, t_o = bound_times(work)
            log(line + f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                f"bound_ms={max(t_b, t_o):.6f} ("
                f"{'bytes' if t_b >= t_o else 'operations'})")
            del got
        del x, basis, coeff, w_rel


def k6_cases(cfg, gen, device):
    """(label, B, bucketed dict, n_nodes): template_blocked for the 7
    structures at both batches, then bucket_edges_blocked of the general
    graph at the defaults (off-diagonal buckets, padding chunks)."""
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    for B in (TRAIN_BATCH, TRAIN_BIG):
        for s in STRUCTURE_NAMES:
            er, en = template_rel_norm(gen, cfg, s)
            yield s, B, tl.template_blocked(s, er, en, B), \
                B * STRUCTURES[s].n_nodes
    yield "general", 0, rb.bucket_edges_blocked(general_store(cfg)), \
        GENERAL_NODES


def k6a_check(rb, got, again, x, w, coeff, lay, R, n):
    """K6a on one layout held to its plain version under
    ``blocked_error_bound``, its repeat launch to the same bits, and the
    negative control (the plain result with one real edge's message
    removed) to a failing gate.  Returns (gate, control failed, max|diff|)."""
    msg = rb._edge_messages(x, w, coeff, lay, R)
    plain = rb._dst_sum(msg, lay, n)
    bound = rb.blocked_error_bound(x, w, coeff, lay, R, n, msg)
    gate = rb.k6a_gate(got, plain, bound)
    gate["repeat_equal"] = torch.equal(got, again)
    real = torch.nonzero(rb._real_edges(lay, n)[2]).squeeze(1)
    e = real[real.numel() // 2:][:1]
    cut = rb._dst_sum(msg.index_fill(0, e, 0.0), lay, n)
    gate["control_fails"] = not rb.k6a_gate(got, cut, bound)["ok"]
    return gate, float((got - plain).abs().max())


def phase_rgcn_blocked(layer_b, cfg, device, gen, flush):
    """K6a (forward and transpose layout) within its stated bound of its
    plain version and K6b under its gate (``ops/rgcn_blocked.py``
    ``k6a_gate``, ``k6b_gate``), each negative control failing, repeat
    launches bit-equal, K6a against the f32 twin (<= TOL_F32, small cases
    only: the twin materializes [E, Bb, d]); the edge lists' build time
    apart, times beside the bound, the plain version and a cuBLAS
    yardstick.  Returns both kernels' JSON fields (launches excluded)."""
    from mpqe_tpu_torch.ops import rgcn_blocked as rb

    d, R = cfg.embed_dim, cfg.n_rels
    basis = layer_b.basis.detach()
    coeff = layer_b.coeff.detach()
    bb = basis.shape[0]
    v_cat = basis.permute(1, 0, 2).reshape(d, bb * d).to(torch.bfloat16)
    accs = {"K6a": new_acc(), "K6b": new_acc()}
    big = {"K6a": [], "K6b": []}
    for label, B, bk, n in k6_cases(cfg, gen, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay, t_lay = rb.layouts_on(bk, device)
        torch.cuda.synchronize()
        lists_ms = (time.perf_counter() - t0) * 1e3
        x = torch.randn((n, d), generator=gen, device=device)
        g = torch.randn((n, d), generator=gen, device=device)
        E = lay["src_local"].shape[0]
        n_chunks = lay["chunk_dst_blk"].shape[0]
        n_real = int(lay["part_ptr"][-1])
        basis_t = basis.transpose(1, 2)
        with torch.no_grad():
            got = rb.messages_blocked(x, basis, coeff, lay, R)
            got2 = rb.messages_blocked(x, basis, coeff, lay, R)
            got_t = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_t2 = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_g = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            got_g2 = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            torch.cuda.synchronize()
            for t in (got, got_t, *got_g):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"K6 {label} B={B}: non-finite")
            ga, err_a = k6a_check(rb, got, got2, x, basis, coeff, lay, R, n)
            gt, err_t = k6a_check(rb, got_t, got_t2, g, basis_t, coeff,
                                  t_lay, R, n)
            plain_g = rb.grad_blocked_reference_parts(x, g, basis, coeff,
                                                      lay, R)
            s_bound = rb.grad_s_bound(x, g, basis, lay)
            gb = rb.k6b_gate(got_g, plain_g, s_bound, lay["rel"], R)
            gb["repeat_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got_g, got_g2))
            r = int(lay["edges"][0, 2])
            cut_lay = dict(lay, norm=torch.where(lay["rel"] == r, 0.0,
                                                 lay["norm"]))
            bad = rb.k6b_gate(got_g, rb.grad_blocked_reference_parts(
                x, g, basis, coeff, cut_lay, R), s_bound, lay["rel"], R)
            gb["control_fails"] = not bad["dbasis_ok"] and \
                not bad["dcoeff_ok"]
        accs["K6a"]["max_abs_err"] = max(accs["K6a"]["max_abs_err"], err_a,
                                         err_t)
        accs["K6b"]["max_abs_err"] = max(accs["K6b"]["max_abs_err"], *(
            float((a - b).abs().max()) for a, b in zip(got_g[:2],
                                                       plain_g[:2])))
        line = (f"kernel.rgcn_blocked {label:14s} B={B:6d} E={E} "
                f"real={n_real} lists_ms={lists_ms:.3f} ")
        for tag, gate in (("K6a", ga), ("K6a_t", gt)):
            line += (f"{tag}: flip_share={gate['flip_share']:.3e} "
                     f"rel_err={gate['rel_err']:.3e} "
                     f"diff_over_bound={gate['bound_ratio']:.3e} "
                     f"control_fails={gate['control_fails']} "
                     f"repeat_equal={gate['repeat_equal']} ")
        line += (f"K6b: dbasis_err={gb['dbasis_err']:.3e} "
                 f"s_flip_share={gb['s_flip_share']:.3e} "
                 f"s_beyond_neighbour={gb['s_beyond_neighbour']} "
                 f"dcoeff_err={gb['dcoeff_err']:.3e} "
                 f"control_fails={gb['control_fails']} "
                 f"repeat_equal={gb['repeat_equal']}")
        ok = all(gate["ok"] and gate["control_fails"]
                 and gate["repeat_equal"] for gate in (ga, gt, gb))
        if B == TRAIN_BATCH:
            with torch.no_grad():
                twin = rb._messages_xla_twin(
                    x, basis, coeff, *(lay[k] for k in (
                        "src_local", "dst_local", "rel", "norm",
                        "chunk_src_blk", "chunk_dst_blk")), R,
                    lay["node_block"], lay["chunk"])
            e_twin = rel_err(got, twin)
            line += f" K6a_err_vs_f32_twin={e_twin:.3e}"
            ok = ok and e_twin <= TOL_F32
            del twin
        if not ok:
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del plain_g, got2, got_t2, got_g2, s_bound
        iters = ITERS if B == TRAIN_BATCH else BIG_ITERS
        row, okr = rb._global_rows(lay, lay["src_local"], "chunk_src_blk", n)
        xs16 = torch.where(okr[:, None], x[row], 0.0).to(torch.bfloat16)
        rhs16 = torch.randn((E, bb * d), generator=gen, device=device).to(
            torch.bfloat16)
        cases = (
            ("K6a", False, lambda: rb.messages_blocked(x, basis, coeff, lay,
                                                       R),
             lambda: rb.messages_blocked_reference(x, basis, coeff, lay, R,
                                                   n),
             lambda: torch.matmul(xs16, v_cat), K6A_KERNELS),
            ("K6b", True, lambda: rb.grad_blocked(x, g, basis, coeff, lay, R),
             lambda: rb.grad_blocked_reference(x, g, basis, coeff, lay, R),
             lambda: (torch.matmul(xs16, v_cat),
                      torch.matmul(xs16.t(), rhs16)), K6B_KERNELS))
        for kid, grad, kfn, pfn, lfn, names in cases:
            with torch.no_grad():
                ms = time_ms(kfn, iters, flush)
                k_ms = device_ms(kfn, iters, flush, names)
                # the plain version is timed at the train batch only: at
                # 131,072 rows and on the general graph a call takes
                # seconds (PERF.md's kernel table keeps its earlier figures)
                plain_ms = (time_ms(pfn, PLAIN_ITERS_K6, flush)
                            if B == TRAIN_BATCH else None)
                lib_ms = time_ms(lfn, iters, flush)
            work = k6_work(E, n_chunks, n_real, n, d, d, bb, R, grad)
            if B == TRAIN_BATCH:
                bound, by = add_case(accs[kid], ms, plain_ms, lib_ms, work,
                                     k_ms)
            else:
                t_b, t_o = bound_times(work)
                bound, by = max(t_b, t_o), ("bytes" if t_b >= t_o
                                            else "operations")
                big[kid].append((label, ms, k_ms))
            log(f"kernel.rgcn_blocked {kid} {label:14s} B={B:6d} "
                + work_line(ms, k_ms, plain_ms, lib_ms, bound, by, work))
        del x, g, got, got_t, got_g, xs16, rhs16, lay, t_lay
    fields = {}
    for kid, acc in accs.items():
        tpl = [(m, k) for lb, m, k in big[kid] if lb != "general"]
        log(f"kernel.rgcn_blocked {kid} sum of 7 at B={TRAIN_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f}; at B={TRAIN_BIG}: kernel_ms="
            f"{sum(m for m, _ in tpl):.4f} device_ms="
            f"{sum(k for _, k in tpl):.4f}")
        fields[kid] = finish_acc(acc)
    wide_rgcn_blocked(cfg, device, gen, flush)
    return fields


def wide_rgcn_blocked(cfg, device, gen, flush):
    """K6a (both layouts) and K6b at the widths of WIDE_K6 with
    WIDE_BASES bases (the basis streamed, dbasis in tiles, s_eb in column
    tiles on the card), on the WIDE_STRUCTURE template at the train batch,
    random weights: the gates, controls and repeats of
    :func:`phase_rgcn_blocked`, and times beside the bound."""
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURES

    R, s, B, bb = cfg.n_rels, WIDE_STRUCTURE, TRAIN_BATCH, WIDE_BASES
    er, en = template_rel_norm(gen, cfg, s)
    lay, t_lay = rb.layouts_on(tl.template_blocked(s, er, en, B), device)
    n = B * STRUCTURES[s].n_nodes
    E = lay["src_local"].shape[0]
    n_chunks = lay["chunk_dst_blk"].shape[0]
    n_real = int(lay["part_ptr"][-1])
    for d in WIDE_K6:
        basis = torch.randn((bb, d, d), generator=gen, device=device) \
            / d ** 0.5
        coeff = torch.randn((R, bb), generator=gen, device=device)
        x = torch.randn((n, d), generator=gen, device=device)
        g = torch.randn((n, d), generator=gen, device=device)
        basis_t = basis.transpose(1, 2)
        with torch.no_grad():
            got = rb.messages_blocked(x, basis, coeff, lay, R)
            got2 = rb.messages_blocked(x, basis, coeff, lay, R)
            got_t = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_t2 = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_g = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            got_g2 = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all())
                         for t in (got, got_t, *got_g))
            ga, _ = k6a_check(rb, got, got2, x, basis, coeff, lay, R, n)
            gt, _ = k6a_check(rb, got_t, got_t2, g, basis_t, coeff, t_lay,
                              R, n)
            plain_g = rb.grad_blocked_reference_parts(x, g, basis, coeff,
                                                      lay, R)
            s_bound = rb.grad_s_bound(x, g, basis, lay)
            gb = rb.k6b_gate(got_g, plain_g, s_bound, lay["rel"], R)
            gb["repeat_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got_g, got_g2))
            r = int(lay["edges"][0, 2])
            cut_lay = dict(lay, norm=torch.where(lay["rel"] == r, 0.0,
                                                 lay["norm"]))
            bad = rb.k6b_gate(got_g, rb.grad_blocked_reference_parts(
                x, g, basis, coeff, cut_lay, R), s_bound, lay["rel"], R)
            gb["control_fails"] = not bad["dbasis_ok"] and \
                not bad["dcoeff_ok"]
        line = f"kernel.rgcn_blocked.wide {s} B={B} d={d} bases={bb} E={E} "
        for tag, gate in (("K6a", ga), ("K6a_t", gt)):
            line += (f"{tag}: flip_share={gate['flip_share']:.3e} "
                     f"rel_err={gate['rel_err']:.3e} "
                     f"diff_over_bound={gate['bound_ratio']:.3e} "
                     f"control_fails={gate['control_fails']} "
                     f"repeat_equal={gate['repeat_equal']} ")
        line += (f"K6b: dbasis_err={gb['dbasis_err']:.3e} "
                 f"s_flip_share={gb['s_flip_share']:.3e} "
                 f"s_beyond_neighbour={gb['s_beyond_neighbour']} "
                 f"dcoeff_err={gb['dcoeff_err']:.3e} "
                 f"control_fails={gb['control_fails']} "
                 f"repeat_equal={gb['repeat_equal']}")
        if not finite or not all(
                gate["ok"] and gate["control_fails"] and gate["repeat_equal"]
                for gate in (ga, gt, gb)):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del got2, got_t2, got_g2, plain_g, s_bound, got, got_t, got_g
        for kid, grad, kfn, names in (
                ("K6a", False,
                 lambda: rb.messages_blocked(x, basis, coeff, lay, R),
                 K6A_KERNELS),
                ("K6b", True,
                 lambda: rb.grad_blocked(x, g, basis, coeff, lay, R),
                 K6B_KERNELS)):
            with torch.no_grad():
                ms = time_ms(kfn, ITERS, flush)
                k_ms = device_ms(kfn, ITERS, flush, names)
            work = k6_work(E, n_chunks, n_real, n, d, d, bb, R, grad)
            t_b, t_o = bound_times(work)
            log(f"kernel.rgcn_blocked.wide {kid} {s} B={B} d={d} "
                f"kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                f"bound_ms={max(t_b, t_o):.6f} "
                f"({'bytes' if t_b >= t_o else 'operations'})")
        del x, g, basis, coeff, basis_t


# ----------------------------------------------------------------------
# K4a / K4b (segment sum and max) and K7 (SDDMM)
# ----------------------------------------------------------------------
K4_KERNELS = ("segment_kernel",)  # the reduce, not the layout kernels
K4L_KERNELS = ("segment_layout",)  # the layout: one kernel, or three
K7_KERNELS = ("sddmm_kernel",)
EVAL_BATCH = 1024  # evaluate's bucket for its 1,000 queries per formula
CAP_ROWS, CAP_SEGMENTS = 1 << 20, 8192  # K4's cap: 512 MiB of f32 rows
K7_CAP_NODES = 8191


def k4_work(E: int, d: int, S: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K4 call from the ids: the f32
    rows and the int32 ids read once, the [S, d] f32 output written once;
    one add (or compare) per input element."""
    return E * d * 4 + E * 4 + S * d * 4, 0, E * d


def k4_given_work(E: int, d: int, S: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K4 launch on a given layout:
    the rows, perm [E] and offs [S + 1] (int32) read once, the output
    written once; one add (or compare) per input element."""
    return E * d * 4 + E * 4 + (S + 1) * 4 + S * d * 4, 0, E * d


def layout_work(E: int, S: int, id_bytes: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one layout: the ids read once, perm
    [E] and offs [S + 1] (int32) written once; integer work only."""
    return E * id_bytes + E * 4 + (S + 1) * 4, 0, 0


def bound_of(work) -> tuple:
    t_b, t_o = bound_times(work)
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def k7_work(N: int, d: int, E: int, same: bool = False) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K7 launch: x and y once (one
    read when ``same``, y being x), the int32 src and dst and the f32
    scores (12 E bytes); 2 E d f32 FLOP."""
    return (1 if same else 2) * N * d * 4 + 12 * E, 0, 2 * E * d


def sddmm_pattern(x, src, dst, check: bool):
    """The CSR pattern of the unique in-range (src, dst) pairs, sorted by
    row (``torch.unique``, ``bincount``, ``cumsum``), and its rows and
    columns."""
    n = x.shape[0]
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    key = torch.unique(src[ok].long() * n + dst[ok].long())
    rows, cols = key // n, key % n
    crow = torch.zeros(n + 1, dtype=torch.int32, device=x.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    pattern = torch.sparse_csr_tensor(
        crow, cols.to(torch.int32), torch.zeros(key.numel(), device=x.device),
        (n, n), check_invariants=check)
    return pattern, rows, cols


def sddmm_library(x, y, src, dst):
    """K7's library yardstick: ``torch.sparse.sampled_addmm`` over the CSR
    pattern of :func:`sddmm_pattern`.  Returns (the call with its pattern
    built here, outside it; the call that builds its pattern itself; the
    pattern's rows and columns)."""
    pattern, rows, cols = sddmm_pattern(x, src, dst, True)
    yt = y.t()

    def with_build():
        p, _, _ = sddmm_pattern(x, src, dst, False)
        return torch.sparse.sampled_addmm(p, x, yt, beta=0.0)

    return (lambda: torch.sparse.sampled_addmm(pattern, x, yt, beta=0.0),
            with_build, rows, cols)


def eval_batches(cfg, gen_np, capacity_pad: int = 0):
    """(structure, SparseQueryBatch) of every structure at EVAL_BATCH
    random queries, flattened by ``dense_to_sparse`` (``capacity_pad``
    padding edges, whose dst lies out of range)."""
    from mpqe_tpu_torch.data.batcher import (DenseQueryBatch,
                                             dense_to_sparse,
                                             template_edge_norm)
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    B = EVAL_BATCH
    for s in STRUCTURE_NAMES:
        spec = STRUCTURES[s]
        rels = gen_np.integers(0, cfg.n_rels, spec.n_edges).astype(np.int32)
        b = DenseQueryBatch(
            s, B, gen_np.integers(0, cfg.n_entities, (B, spec.n_nodes)
                                  ).astype(np.int32),
            gen_np.integers(0, cfg.n_modes, (B, spec.n_nodes)
                            ).astype(np.int32),
            rels, template_edge_norm(spec, rels), np.zeros(B, np.int32),
            np.zeros((B, 1), np.int32), np.ones((B, 1), np.float32),
            np.ones(B, np.float32))
        yield s, dense_to_sparse(b, cfg.n_rels,
                                 B * spec.n_edges + capacity_pad)


def segment_cases(cfg, device):
    """(label, data, ids, S) for K4: (i) the reference's chip check
    (tools/tpu_smoke.py:39-53) with some ids out of range and segment 7
    emptied, (ii) each structure's destination sum at EVAL_BATCH (the
    flattened batch's edge dst, 64 padding edges out of range; the data
    random rows), (iii) the cap, E = 2^20 random ids over 8,192 segments
    with some out of range and segment 7 emptied."""
    rng = np.random.default_rng(11)
    d = cfg.embed_dim

    def t(a):
        return torch.from_numpy(a).to(device)

    def knocked(E, S):
        ids = rng.integers(0, S, E).astype(np.int32)
        ids[ids == 7] = S + 1
        bad = rng.choice(E, max(E // 100, 4), replace=False)
        ids[bad[::2]] = -1
        ids[bad[1::2]] = S
        return ids

    yield "tpu_smoke", t(rng.normal(size=(1000, d)).astype(np.float32)), \
        t(knocked(1000, 64)), 64
    for s, sb in eval_batches(cfg, rng, capacity_pad=64):
        E = sb.edges.capacity
        yield s, t(rng.normal(size=(E, d)).astype(np.float32)), \
            t(sb.edges.dst), sb.n_nodes
    yield "cap", torch.randn((CAP_ROWS, d), device=device,
                             generator=torch.Generator(device).manual_seed(3)), \
        t(knocked(CAP_ROWS, CAP_SEGMENTS)), CAP_SEGMENTS


def phase_segment(cfg, device, flush):
    """The layout kernel against the plain layout (equal, and equal again
    on a repeat launch); K4a and K4b, with the layout built in the call
    and with it given, against their plain versions (K4a <= TOL_PLAIN and
    equal with and without a given layout, K4b exactly equal), K4a
    against an f64 oracle (<= TOL_ORACLE), the out-of-range and
    empty-segment semantics.  Times (CUDA events and profiler, L2
    flushed) of each kernel with its layout built and given, and of the
    layout alone, beside the bound, the plain version and the library
    yardstick (one ``index_add_``, one ``scatter_reduce`` amax; for the
    layout one stable ``torch.argsort`` of the ids with out-of-range ids
    mapped to S, which gives ``perm`` but not ``offs``).  Returns the
    JSON fields (launches excluded) of K4a, K4b (layout given) and the
    layout: sums over the 7 structures' destination sums at EVAL_BATCH."""
    from mpqe_tpu_torch.ops import segment_kernels as sk

    accs = {k: new_acc() for k in ("K4a", "K4b", "K4a.built", "K4b.built",
                                   "layout")}
    for label, data, ids, S in segment_cases(cfg, device):
        E, d = data.shape
        with torch.no_grad():
            layout = sk.segment_layout(ids, S)
            again = sk.segment_layout(ids, S)
            plain_layout = sk.segment_layout_reference(ids, S)
            got_s = sk.segment_sum_kernel(data, ids, S)
            got_m = sk.segment_max_kernel(data, ids, S)
            given_s = sk.segment_sum_kernel(data, ids, S, layout=layout)
            given_m = sk.segment_max_kernel(data, ids, S, layout=layout)
            plain_s = sk.segment_sum_reference(data, ids, S)
            plain_m = sk.segment_max_reference(data, ids, S)
        ok = (ids >= 0) & (ids < S)
        ids_ok, data_ok = ids[ok].long(), data[ok]
        oracle = torch.zeros((S, d), dtype=torch.float64, device=device)
        oracle.index_add_(0, ids_ok, data_ok.double())
        torch.cuda.synchronize()
        empty = torch.bincount(ids_ok, minlength=S) == 0
        lay_same = all(torch.equal(a, b) for a, b in zip(layout,
                                                         plain_layout))
        lay_repeat = all(torch.equal(a, b) for a, b in zip(layout, again))
        given_same = torch.equal(given_s, got_s) and torch.equal(given_m,
                                                                 got_m)
        e_s, e_m = rel_err(got_s, plain_s), rel_err(got_m, plain_m)
        e_orc = float((got_s.double() - oracle).abs().max()
                      / oracle.abs().max())
        same_m = torch.equal(got_m, plain_m)
        sem = (bool((got_s[empty] == 0).all())
               and bool((got_m[empty] == sk.NEG_INF).all())
               and bool(torch.isfinite(got_s).all()))
        for kid, got, plain in (("K4a", got_s, plain_s),
                                ("K4b", got_m, plain_m)):
            err = float((got - plain).abs().max())
            for key in (kid, f"{kid}.built"):
                accs[key]["max_abs_err"] = max(accs[key]["max_abs_err"], err)
        line = (f"kernel.segment {label:14s} E={E} S={S} "
                f"layout_equal_plain={lay_same} "
                f"layout_repeat_equal={lay_repeat} "
                f"given_layout_equal={given_same} "
                f"K4a_err_vs_plain={e_s:.3e} K4b_err_vs_plain={e_m:.3e} "
                f"K4a_err_vs_f64_oracle={e_orc:.3e} "
                f"dropped={int((~ok).sum())} empty={int(empty.sum())}")
        if (e_s > TOL_PLAIN or not same_m or e_orc > TOL_ORACLE or not sem
                or not (lay_same and lay_repeat and given_same)):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del plain_s, plain_m, oracle, again, plain_layout
        big = E > 100_000
        iters, p_iters = (BIG_ITERS, 1) if big else (ITERS, PLAIN_ITERS)
        idx = ids_ok[:, None].expand(-1, d)
        key = torch.where(ok, ids.long(), S)
        both = K4_KERNELS + K4L_KERNELS
        lib_s = lambda: torch.zeros((S, d), device=device).index_add_(  # noqa
            0, ids_ok, data_ok)
        lib_m = lambda: torch.full(  # noqa: E731
            (S, d), sk.NEG_INF, device=device).scatter_reduce_(
                0, idx, data_ok, "amax")
        cases = (
            # (accumulator, kernel call, profiler names, plain call,
            #  library call, work)
            ("K4a.built", lambda: sk.segment_sum_kernel(data, ids, S), both,
             lambda: sk.segment_sum_reference(data, ids, S), lib_s,
             k4_work(E, d, S)),
            ("K4a", lambda: sk.segment_sum_kernel(data, ids, S,
                                                  layout=layout),
             K4_KERNELS,
             lambda: sk.segment_sum_reference(data, ids, S, layout=layout),
             lib_s, k4_given_work(E, d, S)),
            ("K4b.built", lambda: sk.segment_max_kernel(data, ids, S), both,
             lambda: sk.segment_max_reference(data, ids, S), lib_m,
             k4_work(E, d, S)),
            ("K4b", lambda: sk.segment_max_kernel(data, ids, S,
                                                  layout=layout),
             K4_KERNELS,
             lambda: sk.segment_max_reference(data, ids, S, layout=layout),
             lib_m, k4_given_work(E, d, S)),
            ("layout", lambda: sk.segment_layout(ids, S), K4L_KERNELS,
             lambda: sk.segment_layout_reference(ids, S),
             lambda: torch.argsort(key, stable=True),
             layout_work(E, S, ids.element_size())))
        for kid, kfn, names, pfn, lfn, work in cases:
            with torch.no_grad():
                ms = time_ms(kfn, iters, flush)
                k_ms = device_ms(kfn, iters, flush, names)
                plain_ms = time_ms(pfn, p_iters, flush)
                lib_ms = time_ms(lfn, iters, flush)
            if label in ("tpu_smoke", "cap"):
                bound, by = bound_of(work)
            else:
                bound, by = add_case(accs[kid], ms, plain_ms, lib_ms, work,
                                     k_ms)
            log(f"kernel.segment {kid:9s} {label:14s} E={E} S={S} "
                + work_line(ms, k_ms, plain_ms, lib_ms, bound, by, work))
        del data, ids, got_s, got_m, given_s, given_m, data_ok, idx, key
        del layout
    fields = {}
    for kid, acc in accs.items():
        log(f"kernel.segment {kid} sum of 7 at B={EVAL_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f}")
        fields[kid] = finish_acc(acc)
    for kid in ("K4a", "K4b"):
        fields[kid]["built_ms"] = fields.pop(f"{kid}.built")["ms"]
    return fields


def final_layer_nodes(model, cfg, sb, device):
    """The node embeddings after the last R-GCN layer of a sparse batch
    (``encode_sparse``'s layers, K4a destination sums over one layout),
    ``[N, d]``."""
    from mpqe_tpu_torch.models import embeddings as emb_mod
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import segment_kernels as sk

    def t(a):
        return torch.from_numpy(a).to(device)

    e = sb.edges
    with torch.no_grad():
        x = emb_mod.embed_nodes_sparse(model.emb, t(sb.node_entity),
                                       t(sb.node_mode), t(sb.node_is_var))
        dst = t(e.dst)
        layout = sk.segment_layout(dst, x.shape[0])
        for li, lp in enumerate(model.layers):
            x = rgcn_ops.rgcn_sparse(x, lp, t(e.src), dst, t(e.rel),
                                     t(e.norm), cfg.n_rels,
                                     segment_backend="pallas", layout=layout)
            if li < len(model.layers) - 1:
                x = torch.relu(x)
    return x


def phase_sddmm(model, cfg, device, flush):
    """K7 against its plain version (equal: the same sum order) and an f64
    oracle (<= TOL_ORACLE), out-of-range endpoints scoring 0, times beside
    the bound, the plain version and the library yardstick
    (``torch.sparse.sampled_addmm``, see :func:`sddmm_library`).
    K7 has no caller in the package: its main-path drive is the scoring of
    the 7 structures' final-layer node embeddings at EVAL_BATCH over their
    own edges, counted from 0.  Returns (launches of that drive, the JSON
    fields: sums over those 7)."""
    from mpqe_tpu_torch.ops import sddmm as sd

    d = cfg.embed_dim
    rng = np.random.default_rng(12)
    gen = torch.Generator(device).manual_seed(4)

    def t(a):
        return torch.from_numpy(a).to(device)

    def rand_case(n, E):
        x = torch.randn((n, d), device=device, generator=gen)
        y = torch.randn((n, d), device=device, generator=gen)
        return x, y, t(rng.integers(0, n, E).astype(np.int32)), \
            t(rng.integers(0, n, E).astype(np.int32))

    batches = [(s, final_layer_nodes(model, cfg, sb, device), sb)
               for s, sb in eval_batches(cfg, rng)]
    sd.sddmm_kernel.launches = 0
    with torch.no_grad():
        for _, x, sb in batches:
            sd.sddmm_kernel(x, x, t(sb.edges.src), t(sb.edges.dst))
    torch.cuda.synchronize()
    launches = sd.sddmm_kernel.launches
    log(f"kernel.sddmm: the 7 batches' edges at B={EVAL_BATCH} scored by "
        f"K7: launches {launches}")
    if launches != len(batches):
        raise AssertionError(f"K7 launches {launches} != {len(batches)}")
    cases = [("tpu_smoke", *rand_case(512, 2048))]
    cases += [(s, x, x, t(sb.edges.src), t(sb.edges.dst))
              for s, x, sb in batches]
    cases.append(("cap", *rand_case(K7_CAP_NODES, CAP_ROWS)))
    acc = new_acc()
    for label, x, y, src, dst in cases:
        n, E = x.shape[0], src.shape[0]
        src, dst = src.clone(), dst.clone()
        src[:3] = torch.tensor([-1, n, 3 * n], device=device)
        dst[3] = n + 5  # four edges out of range: they score 0
        with torch.no_grad():
            got = sd.sddmm_kernel(x, y, src, dst)
            plain = sd.sddmm_reference(x, y, src, dst)
            oracle = sd.sddmm_xla(x.double(), y.double(), src, dst)
        torch.cuda.synchronize()
        e_plain = rel_err(got, plain)
        equal = bool(torch.equal(got, plain))
        e_orc = float((got.double() - oracle).abs().max()
                      / oracle.abs().max())
        zero = bool((got[:4] == 0).all())
        acc["max_abs_err"] = max(acc["max_abs_err"], float(
            (got - plain).abs().max()))
        line = (f"kernel.sddmm {label:14s} N={n} E={E} "
                f"err_vs_plain={e_plain:.3e} equal_plain={equal} "
                f"err_vs_f64_oracle={e_orc:.3e} out_of_range_zero={zero}")
        if not equal or e_orc > TOL_ORACLE or not zero or \
                not bool(torch.isfinite(got).all()):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        big = E > 100_000
        iters, p_iters = (BIG_ITERS, 1) if big else (ITERS, PLAIN_ITERS)
        lfn, lfn_built, rows, cols = sddmm_library(x, y, src, dst)
        with torch.no_grad():
            lib = lfn().values()
            lib_orc = sd.sddmm_xla(x.double(), y.double(), rows, cols)
            e_lib = float((lib.double() - lib_orc).abs().max()
                          / lib_orc.abs().max())
            ms = time_ms(lambda: sd.sddmm_kernel(x, y, src, dst), iters, flush)
            k_ms = device_ms(lambda: sd.sddmm_kernel(x, y, src, dst), iters,
                             flush, K7_KERNELS)
            plain_ms = time_ms(lambda: sd.sddmm_reference(x, y, src, dst),
                               p_iters, flush)
            lib_ms = time_ms(lfn, iters, flush)
            lib_built_ms = time_ms(lfn_built, iters, flush)
        work = k7_work(n, d, E, same=y is x)
        if label in ("tpu_smoke", "cap"):
            t_b, t_o = bound_times(work)
            bound, by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        else:
            bound, by = add_case(acc, ms, plain_ms, lib_ms, work, k_ms)
        log(f"kernel.sddmm {label:14s} N={n} E={E} kernel_ms={ms:.4f} "
            f"device_ms={k_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (sampled_addmm, {rows.numel()} pairs, "
            f"err_vs_f64_oracle={e_lib:.3e}; with its pattern built in the "
            f"call {lib_built_ms:.4f}) "
            f"bound_ms={bound:.6f} ({by}: {work[0]} B, {work[2]} f32 FLOP)")
        del got, plain, oracle, lib, lib_orc, lfn, lfn_built
    log(f"kernel.sddmm sum of 7 at B={EVAL_BATCH}: kernel_ms={acc['ms']:.4f} "
        f"device_ms={acc['device_ms']:.4f} plain_ms={acc['plain_ms']:.4f} "
        f"library_ms={acc['library_ms']:.4f} "
        f"bound_ms={acc['bound_ms']:.6f}")
    return launches, finish_acc(acc)


class SparseEncode:
    """``evaluate``'s ``encode_fn`` through the sparse path:
    ``dense_to_sparse``, then ``encode_sparse(segment_backend="pallas")``
    (K4a in every layer's destination sum and the sum / mlp readouts, K4b
    in the max readout, over one layout of the destinations and one of the
    readout's query ids), or with ``backend="xla"`` the plain segment
    sums.  Counts the K4 launches its calls should make."""

    def __init__(self):
        self.want = {"K4a": 0, "K4b": 0, "layout": 0}
        self.calls = 0

    def __call__(self, model, cfg, structure, ne, nm, er, en,
                 backend="pallas"):
        from mpqe_tpu_torch.data.batcher import (DenseQueryBatch,
                                                 dense_to_sparse)
        from mpqe_tpu_torch.models import mpqe as mpqe_mod

        B, dev = ne.shape[0], ne.device
        z = np.zeros(B, np.int32)
        b = DenseQueryBatch(structure, B,
                            *(a.cpu().numpy() for a in (ne, nm, er, en)),
                            z, z[:, None], np.ones((B, 1), np.float32),
                            np.ones(B, np.float32))
        sb = dense_to_sparse(b, cfg.n_rels)
        e = sb.edges
        self.calls += 1
        steps = mpqe_mod.num_steps(cfg, structure)
        if backend == "pallas":
            self.want["K4a"] += steps + (cfg.readout in ("sum", "mlp"))
            self.want["K4b"] += cfg.readout == "max"
            self.want["layout"] += (steps > 0) + (
                cfg.readout in ("sum", "mlp", "max"))
        return mpqe_mod.encode_sparse(
            model, cfg, structure,
            *(torch.from_numpy(a).to(dev) for a in (
                sb.node_entity, sb.node_mode, sb.node_is_var, e.src, e.dst,
                e.rel, e.norm, sb.node_query, sb.target_node)), B,
            segment_backend=backend)


def k4_counters():
    from mpqe_tpu_torch.ops import segment_kernels as sk

    return {"K4a": sk.segment_sum_kernel, "K4b": sk.segment_max_kernel,
            "layout": sk.segment_layout}


def recheck_eval_formulas(model, cfg, val_q, device, label):
    """One formula per structure (its largest) encoded through the sparse
    path with the kernels and with their plain versions: bit-equal query
    vectors."""
    from mpqe_tpu_torch.data.batcher import bucket_size, make_dense_batch

    enc = SparseEncode()
    for structure, by_formula in val_q.items():
        formula, qs = max(by_formula.items(), key=lambda kv: len(kv[1]))
        b = make_dense_batch(formula, qs[:1000], bucket_size(len(qs[:1000])),
                             n_neg=64, rng=np.random.default_rng(0))
        args = [torch.from_numpy(getattr(b, f)).to(device) for f in (
            "node_entity", "node_mode", "edge_rel", "edge_norm")]
        with torch.no_grad():
            q_k = enc(model, cfg, structure, *args)
            with plain_sparse_kernels():
                q_p = enc(model, cfg, structure, *args)
        torch.cuda.synchronize()
        same = torch.equal(q_k, q_p)
        line = (f"{label}.recheck {structure:14s} B={b.batch_size} "
                f"query_vectors_bit_equal={same} "
                f"max_abs_diff={float((q_k - q_p).abs().max()):.3e}")
        log(line)
        if not same or not bool(torch.isfinite(q_k).all()):
            raise AssertionError(line)


def eval_sparse_run(model, cfg, val_q, device, label, profile=False):
    """``evaluate`` on ``val_q`` through :class:`SparseEncode` (K4 launch
    counts from 0 must equal the expected counts) and through the f32
    ``encode_dense``: per-structure AUC and APR / 100 within 1e-3; with
    ``profile``, a device profile of the sparse run on one structure.
    Returns the K4 launches of the sparse run."""
    from mpqe_tpu_torch.train import evaluation

    enc = SparseEncode()
    counters = k4_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = evaluation.evaluate(model, cfg, val_q, n_neg=64, encode_fn=enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_q = sum(min(len([q for q in qs if q.neg_samples]), 1000)
              for by_f in val_q.values() for qs in by_f.values())
    log(f"{label}: evaluate through the sparse path (readout "
        f"{cfg.readout}): {enc.calls} encode calls, {n_q} queries in "
        f"{wall:.3f} s ({n_q / wall:.1f} queries/s); launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" (expected {' '.join(f'{k}={v}' for k, v in enc.want.items())})")
    if launches != enc.want or launches["K4a"] == 0 or \
            launches["layout"] == 0:
        raise AssertionError(f"{label}: launches {launches} != {enc.want}")
    t0 = time.perf_counter()
    dense = evaluation.evaluate(model, cfg, val_q, n_neg=64)
    torch.cuda.synchronize()
    log(f"{label}: evaluate through encode_dense (f32) "
        f"{time.perf_counter() - t0:.3f} s")
    worst = 0.0
    for name, scale in (("auc_by_structure", 1.0), ("apr_by_structure", 100.0),
                        ("hard_auc_by_structure", 1.0)):
        a, b = getattr(res, name), getattr(dense, name)
        if set(a) != set(b):
            raise AssertionError(f"{label}: {name} keys differ")
        for s in a:
            worst = max(worst, abs(a[s] - b[s]) / scale)
    line = (f"{label}: sparse vs dense evaluate: macro_auc "
            f"{res.macro_auc:.6f} vs {dense.macro_auc:.6f}, macro_apr "
            f"{res.macro_apr:.4f} vs {dense.macro_apr:.4f}; worst "
            f"per-structure |diff| (AUC, APR / 100) {worst:.3e}")
    log(line)
    if worst > 1e-3:
        raise AssertionError(line)
    recheck_eval_formulas(model, cfg, val_q, device, label)
    if profile:
        part = {"3-chain_inter": val_q["3-chain_inter"]}
        profile_device(f"{label}.profile (3-chain_inter formulas)",
                       lambda: evaluation.evaluate(model, cfg, part, n_neg=64,
                                                   encode_fn=SparseEncode()),
                       also=K4_KERNELS + K4L_KERNELS)
    return launches


def phase_eval_sparse(model, cfg, kg, train_q, val_q, device):
    """The per-formula evaluation through the sparse path on the flagship
    model (TGT readout: K4a) and a flagship-width max-readout model (K4a
    and K4b), then ``run_train`` for 20 dense steps with one validation
    round through ``eval_encode_fn``.  Returns the K4 launches of these
    runs."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    total = eval_sparse_run(model, cfg, val_q, device, "eval.sparse",
                            profile=True)
    mcfg = mpqe_mod.MPQEConfig(**dict(FLAGSHIP, readout="max"))
    gen = torch.Generator(device=device).manual_seed(6)
    mmodel = mpqe_mod.init_mpqe(gen, mcfg, device=device)
    for k, v in eval_sparse_run(mmodel, mcfg, val_q, device,
                                "eval.sparse_max").items():
        total[k] += v
    del mmodel

    tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                              max_steps=20, val_every=20,
                              burn_in_structure="none", seed=0)
    gen = torch.Generator(device=device).manual_seed(7)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device)
    enc = SparseEncode()
    counters = k4_counters()
    for fn in counters.values():
        fn.launches = 0
    records = []
    t0 = time.perf_counter()
    loop_mod.run_train(state, cfg, tc, train_q, val_queries=val_q,
                       log_fn=records.append, eval_encode_fn=enc, kg=kg)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    vals = [r for r in records if "val" in r]
    log(f"eval.sparse.train: {state.step} dense steps and {len(vals)} "
        f"validation round through eval_encode_fn in "
        f"{time.perf_counter() - t0:.2f} s; launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" (expected {' '.join(f'{k}={v}' for k, v in enc.want.items())})"
        f"; val macro_auc "
        f"{vals[-1]['val']['auc_macro'] if vals else float('nan'):.4f}")
    if len(vals) != 1 or launches != enc.want or launches["K4a"] == 0 or \
            launches["layout"] == 0:
        raise AssertionError(f"eval.sparse.train: {len(vals)} rounds, "
                             f"launches {launches} != {enc.want}")
    for k, v in launches.items():
        total[k] += v
    return total


def phase_eval_ranking(model, cfg, kg, val_q, device):
    """``full_ranking`` on the flagship model over ``val_q`` (every
    entity of the target's mode, 1M entities); one structure's ranks
    recomputed by ``torch.matmul`` and a per-row count must give the same
    metrics."""
    from mpqe_tpu_torch.data.batcher import bucket_size
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops.fused_fwd import prepare_fused_multi
    from mpqe_tpu_torch.train import evaluation

    t0 = time.perf_counter()
    rk = evaluation.full_ranking(model, cfg, val_q, kg.entity_mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for s, m in rk.items():
        log(f"eval.ranking {s:14s} " + " ".join(
            f"{k}={v:.6f}" for k, v in m.items()))
    es = evaluation.make_eval_set(val_q, 200, require_negatives=False)
    n_q = sum(d["target"].shape[0] for d in es.by_structure.values())
    log(f"eval.ranking: {n_q} queries against {cfg.n_entities} entities in "
        f"{wall:.3f} s ({n_q / wall:.1f} queries/s)")
    structure = "3-chain_inter"
    data = es.by_structure[structure]
    n = data["target"].shape[0]
    B = bucket_size(n)
    pad = [evaluation._pad_chunk(data[k], 0, n, B, device, fill)
           for k, fill in (("node_entity", 0), ("node_mode", 0),
                           ("edge_rel", 0), ("edge_norm", 1))]
    emode = torch.from_numpy(kg.entity_mode.astype(np.int32)).to(device)
    with torch.no_grad():
        q = mpqe_mod.encode_dense_multi_auto(
            model, cfg, structure, *pad,
            operands=prepare_fused_multi(model, cfg))
        e = mpqe_mod._l2_normalize(model.emb.ent)
        scores = torch.matmul(mpqe_mod._l2_normalize(q), e.t())
    ranks = []
    for i, t in enumerate(data["target"].tolist()):
        row = scores[i]
        ranks.append(1 + int(((row > row[t]) & (emode == emode[t])).sum()))
    want = evaluation._rank_metrics(np.asarray(ranks, np.float64),
                                    (1, 3, 10))
    line = (f"eval.ranking.recheck {structure}: {n} ranks recomputed by "
            f"torch.matmul and a per-row count: equal={want == rk[structure]}")
    log(line)
    if want != rk[structure]:
        raise AssertionError(f"{line}: {want} != {rk[structure]}")
    return rk


def phase_eval_cli(run_dir: str) -> None:
    """``python -m mpqe_tpu_torch.evaluate --run_dir <run_dir> --ranking``
    as a subprocess: its lines (one metrics line, one per structure)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpqe_tpu_torch.evaluate", "--run_dir",
         run_dir, "--ranking"], capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    log(f"eval.cli: rc={proc.returncode} {time.perf_counter() - t0:.2f} s, "
        f"{len(lines)} lines")
    for ln in lines:
        log(f"eval.cli: {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"evaluate CLI failed:\n{proc.stderr[-4000:]}")
    head = json.loads(lines[0])
    ranks = [json.loads(ln) for ln in lines[1:]]
    if not {"checkpoint", "step", "use", "auc_macro", "apr_macro"} <= set(
            head) or head["step"] != 20 or not ranks or not all(
            "mrr" in r for r in ranks):
        raise AssertionError(f"unexpected evaluate CLI output {lines}")


def phase_serve_cli(run_dir: str) -> None:
    """``python -m mpqe_tpu_torch.serve --run_dir <run_dir>`` as a
    subprocess: it restores the run's latest checkpoint (step 20) over
    the KG rebuilt from the run's config and serves a sampled stream of
    every structure on the card."""
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpqe_tpu_torch.serve", "--run_dir",
         run_dir, "--requests", "21", "--batch", "8", "--structures",
         ",".join(STRUCTURE_NAMES)], capture_output=True, text=True,
        timeout=600)
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    log(f"serve.cli --run_dir: rc={proc.returncode} "
        f"{time.perf_counter() - t0:.2f} s: {last}")
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI failed:\n{proc.stderr[-4000:]}")
    out = json.loads(last)
    if not (str(out.get("checkpoint", "")).endswith("step_20")
            and out.get("device") == torch.cuda.get_device_name(0)
            and out.get("requests") == 21
            and np.isfinite(out.get("latency_ms_p50", np.nan))
            and 0.0 <= out.get("hit_at_k", -1.0) <= 1.0):
        raise AssertionError(f"unexpected serve CLI output {last!r}")


def _plain_k5a(x, src, basis, coeff, chunk_rel, n_rels, norm, chunk,
               w_transposed=False):
    """K5a's plain version under the wrapper's signature (``w_transposed``:
    the weights read transposed, as ``EdgeMessages.backward`` asks)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    return rf.messages_basis_reference(
        x, src, basis.transpose(1, 2) if w_transposed else basis,
        rf._masked_chunk_coeff(coeff, chunk_rel, n_rels), norm, chunk)


def _plain_k5b(x, src, w_rel, chunk_rel, norm, chunk, w_transposed=False):
    """K5b's plain version under the wrapper's signature."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    return rf.messages_wrel_reference(
        x, src, w_rel.transpose(1, 2) if w_transposed else w_rel, chunk_rel,
        norm, chunk)


class plain_sparse_kernels:
    """Within the block, the K4, K5 and K6 wrappers that ``ops/segment.py``,
    ``encode_sparse`` (the K4 layout) and the autograd Functions of
    ``ops/rgcn_fused.py`` and ``ops/rgcn_blocked.py`` call are their plain
    versions, on the card (the train-step and eval.sparse rechecks)."""

    def __enter__(self):
        from mpqe_tpu_torch.ops import rgcn_blocked as rb
        from mpqe_tpu_torch.ops import rgcn_fused as rf
        from mpqe_tpu_torch.ops import segment_kernels as sk

        self.saved = (rf.messages_basis, rf.messages_wrel,
                      rb.messages_blocked, rb.grad_blocked,
                      sk.segment_sum_kernel, sk.segment_max_kernel,
                      sk.segment_layout)
        rf.messages_basis = _plain_k5a
        rf.messages_wrel = _plain_k5b
        rb.messages_blocked = lambda x, basis, coeff, lay, n_rels: \
            rb.messages_blocked_reference(x, basis, coeff, lay, n_rels,
                                          x.shape[0])
        rb.grad_blocked = rb.grad_blocked_reference
        sk.segment_sum_kernel = sk.segment_sum_reference
        sk.segment_max_kernel = sk.segment_max_reference
        sk.segment_layout = sk.segment_layout_reference
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import rgcn_blocked as rb
        from mpqe_tpu_torch.ops import rgcn_fused as rf
        from mpqe_tpu_torch.ops import segment_kernels as sk

        (rf.messages_basis, rf.messages_wrel, rb.messages_blocked,
         rb.grad_blocked, sk.segment_sum_kernel, sk.segment_max_kernel,
         sk.segment_layout) = self.saved
        return False


SPARSE_RUNS = {
    # name: (kernel, num_bases, loss function name)
    "train.fused": ("fused", 16, "dense_batch_loss_kernel_fused"),
    "train.fused_full": ("fused", None, "dense_batch_loss_kernel_fused"),
    "train.blocked": ("blocked", 16, "dense_batch_loss_kernel_blocked"),
}


def sparse_counters():
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    return {"K5a": rf.messages_basis, "K5b": rf.messages_wrel,
            "K6a": rb.messages_blocked, "K6b": rb.grad_blocked}


def recheck_sparse_step(state, cfg, stores, device, loss_name, label):
    """One step per structure from the trained state through the kernels
    and through their plain versions on the card: same loss and gradients
    (<= TOL_PLAIN relative, per leaf; the segment sums and the dx scatter
    go through index_add_, whose atomics vary the last bits; for
    ``train.blocked`` the gradients per leaf in mean|diff| / mean|ref|)."""
    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    model = state.model
    params = dict(model.named_parameters())
    loss_fn = getattr(mpqe_mod, loss_name)
    for structure, f_stores in stores.items():
        fstore = max(f_stores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(
            fstore, np.arange(min(fstore.n_queries, TRAIN_BATCH)),
            TRAIN_BATCH, 4, 11)
        t = loop_mod.batch_tensors(batch, device)
        loss_k = loss_fn(model, cfg, structure, *t)
        g_k = torch.autograd.grad(loss_k, list(params.values()),
                                  allow_unused=True)
        with plain_sparse_kernels():
            loss_p = loss_fn(model, cfg, structure, *t)
            g_p = torch.autograd.grad(loss_p, list(params.values()),
                                      allow_unused=True)
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        e_loss = abs(lk - lp) / max(abs(lp), 1e-12)
        gk, gp = dict(zip(params, g_k)), dict(zip(params, g_p))
        e_grad = tree_rel_err(gk, gp)
        line = (f"{label}.recheck {structure:14s} loss={lk:.6f} "
                f"loss_err={e_loss:.3e} grad_err={e_grad:.3e}")
        if label == "train.blocked":
            # K6 takes its products on the tensor cores: a message can
            # land one bf16 step from the plain one, and a ReLU mask
            # downstream can flip with it, so single gradient elements
            # move; held per leaf to mean|diff| / mean|ref|, the form K2's
            # check uses, with the max-element figure beside it
            e_max, e_grad = e_grad, tree_mean_err(gk, gp)
            line = (f"{label}.recheck {structure:14s} loss={lk:.6f} "
                    f"loss_err={e_loss:.3e} grad_mean_err={e_grad:.3e} "
                    f"grad_max_err={e_max:.3e}")
        log(line)
        if e_loss > TOL_PLAIN or e_grad > TOL_PLAIN or not np.isfinite(lk):
            raise AssertionError(line)


def phase_train_sparse(kg, train_q, device, label):
    """``run_train`` on the card through the sparse path of ``label``
    (:data:`SPARSE_RUNS`): launch counts equal to the expected counts,
    finite losses, the plain-version recheck, step p50/p95 and a profile.
    Returns the launches by kernel id."""
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.train import loop as loop_mod

    kernel, nb, loss_name = SPARSE_RUNS[label]
    cfg = mpqe_mod.MPQEConfig(**dict(FLAGSHIP, num_bases=nb))
    tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                              max_steps=SPARSE_STEPS, val_every=1 << 30,
                              burn_in_structure="none", seed=0)
    gen = torch.Generator(device=device).manual_seed(2)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device)
    real = []
    loss_impl = getattr(mpqe_mod, loss_name)

    def loss_fn(*a):
        real.append(a[-1].sum())
        return loss_impl(*a)

    t0 = time.perf_counter()
    loop_mod.warmup_train_step(
        lambda opt: loop_mod.make_train_step(cfg, opt, loss_fn), cfg, tc,
        STRUCTURE_NAMES, device)
    torch.cuda.synchronize()
    log(f"{label}: setup: warmup (one throwaway step per structure) "
        f"{time.perf_counter() - t0:.2f} s")
    counters = sparse_counters()
    for fn in counters.values():
        fn.launches = 0
    real.clear()
    records = []
    t0 = time.perf_counter()
    loop_mod.run_train(state, cfg, tc, train_q, log_fn=records.append,
                       batch_loss_fn=loss_fn, kg=kg)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = [r for r in records if "loss" in r]
    losses = [r["loss"] for r in steps]
    # per step, each of the structure's num_steps layers launches K5 twice
    # (forward, dxs) or K6a twice (forward, dx) and K6b once
    layers = sum(mpqe_mod.num_steps(cfg, r["structure"]) for r in steps)
    if kernel == "fused":
        want = {"K5a": 2 * layers if nb else 0,
                "K5b": 0 if nb else 2 * layers, "K6a": 0, "K6b": 0}
    else:
        want = {"K5a": 0, "K5b": 0, "K6a": 2 * layers, "K6b": layers}
    log(f"{label}: {state.step} steps in {wall:.2f} s; launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" (expected {' '.join(f'{k}={v}' for k, v in want.items())}); "
        f"loss first={losses[0]:.6f} last={losses[-1]:.6f}")
    if len(losses) != SPARSE_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: {len(losses)} steps, finite: "
                             f"{all(np.isfinite(losses))}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    ms = np.asarray([r["seconds"] * 1e3 for r in steps])
    STEP_MS[label] = (np.percentile(ms, 50), np.percentile(ms, 95))
    n_real = int(torch.stack(real).sum())
    log(f"{label}: {len(ms)} steps of batch {TRAIN_BATCH} on "
        f"{torch.cuda.get_device_name(device)}: "
        f"step_ms_p50={np.percentile(ms, 50):.3f} "
        f"step_ms_p95={np.percentile(ms, 95):.3f} "
        f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} "
        f"({n_real} real rows of {len(ms) * TRAIN_BATCH}) "
        f"padded_rows_per_s={len(ms) * TRAIN_BATCH / ms.sum() * 1e3:.1f}")
    stores = build_stores(train_q, kg=kg)
    recheck_sparse_step(state, cfg, stores, device, loss_name, label)
    ptc = dataclasses.replace(tc, max_steps=PROFILE_STEPS)
    profile_device(f"{label}.profile ({PROFILE_STEPS} steps)",
                   lambda: loop_mod.run_train(state, cfg, ptc, train_q,
                                              batch_loss_fn=loss_fn, kg=kg),
                   also=K5_KERNELS + K6A_KERNELS + K6B_KERNELS)
    return launches


# ----------------------------------------------------------------------
# K8 (the ring-halo R-GCN layer) and training through the halo layers
# ----------------------------------------------------------------------
K8_KERNELS = ("ring_sum_kernel", "ring_keys_kernel", "ring_bounds_kernel",
              "ring_runs_kernel", "ring_rows_kernel", "ring_dst_kernel",
              "k5_msg_kernel", "k5_combine_kernel")
RING_SIZES = (2, 3, 4, 8)
RING_TEMPLATE_PARTS = 4
RING_SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clock, per aggregate
HALO_PARTS = 4
HALO_STEPS = 10  # short: the multiprocess phases share the time limit


def k8_work(N: int, d: int, d_out: int, bb: int, n_rels: int, E: int,
            n_parts: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP, TF32 FLOP) of one K8 layer call (all P
    hops): x, the E real edges' src, dst, rel and norm (16 B each), the
    basis and coeff read once, the [N, d_out] aggregate written once; the
    least f32 work of three routes: per edge and basis (2 d d_out Bb an
    edge), per held source row (2 d d_out Bb for each of the P N rows a
    part holds over the ring), each plus the basis sum (2 Bb an output),
    the norm and the destination add; per relation (2 d d_out an edge,
    plus the combine, R Bb d d_out multiplies and adds, plus the norm and
    the add).  The TF32 entry is the per-relation route's products in
    split TF32 (3 x 2 d d_out an edge), which ``bound_times`` takes when
    it is faster, as for K5."""
    nbytes = (N * d * 4 + E * 16 + bb * d * d_out * 4 + n_rels * bb * 4
              + N * d_out * 4)
    tail = E * d_out * (2 * bb + 2)
    f32 = min(2 * d * d_out * bb * E + tail,
              2 * d * d_out * bb * n_parts * N + tail,
              2 * d * d_out * E + 2 * n_rels * bb * d * d_out
              + 2 * E * d_out)
    return nbytes, 0, f32, 3 * 2 * d * d_out * E


def k8_work_pr5(N: int, d: int, d_out: int, bb: int, n_rels: int, E: int,
                n_parts: int) -> tuple:
    """PR 5's count, printed beside: the cheaper of per edge and per held
    row (min(E, P N)), f32 only."""
    nbytes = k8_work(N, d, d_out, bb, n_rels, E, n_parts)[0]
    f32 = 2 * d * d_out * bb * min(E, n_parts * N) + E * d_out * (2 * bb + 2)
    return nbytes, 0, f32


def ring_cases(cfg, gen, device):
    """One dict per K8 case (label, P, mesh, x, the ring's edge arrays on
    the card, the single-device graph's (src, dst, rel, norm), its node
    and edge counts): the reference's general graph for every ring size
    (the same x), then each structure's template layout at TRAIN_BATCH
    on RING_TEMPLATE_PARTS parts."""
    from mpqe_tpu_torch.parallel import halo
    from mpqe_tpu_torch.parallel import halo_train as ht
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    def t(a):
        return torch.from_numpy(a).to(device)

    st = general_store(cfg)
    m = st.pad_mask
    single = tuple(t(a[m]) for a in (st.src, st.dst, st.rel, st.norm))
    x0 = torch.randn((st.n_nodes, cfg.embed_dim), generator=gen,
                     device=device)
    for P in RING_SIZES:
        pr = halo.partition_edges_ring(st, P)
        x = torch.zeros((pr.n_nodes_padded, cfg.embed_dim), device=device)
        x[:st.n_nodes] = x0
        yield dict(label="general", P=P, x=x, n=st.n_nodes, E=int(m.sum()),
                   mesh=make_mesh((P, 1), devices=[device] * P),
                   edges=[t(a) for a in (pr.src_local, pr.dst_local, pr.rel,
                                         pr.norm)], single=single)
    B, P = TRAIN_BATCH, RING_TEMPLATE_PARTS
    for s in STRUCTURE_NAMES:
        spec = STRUCTURES[s]
        lay = ht._template_layout(s, B, P, "ring", device)
        er, en = template_rel_norm(gen, cfg, s)
        slot = lay["slot_ordered"]
        rel = torch.full((lay["total"],), cfg.n_rels, dtype=torch.int32,
                         device=device)
        rel[lay["flat"]] = er[slot]
        norm = torch.zeros((lay["total"],), device=device)
        norm[lay["flat"]] = en[slot]
        offs = torch.arange(B, device=device)[:, None] * spec.n_nodes
        src = (offs + torch.tensor(spec.edge_src, device=device)).reshape(-1)
        dst = (offs + torch.tensor(spec.edge_dst, device=device)).reshape(-1)
        yield dict(label=s, P=P, n=B * spec.n_nodes, E=B * spec.n_edges,
                   x=torch.randn((lay["n_pad"], cfg.embed_dim),
                                 generator=gen, device=device),
                   mesh=make_mesh((P, 1), devices=[device] * P),
                   edges=[lay["o_src"], lay["o_dst"],
                          rel.reshape(lay["shape"]),
                          norm.reshape(lay["shape"])],
                   single=(src, dst, er.repeat(B), en.repeat(B)))


def ring_device_ms(fn, iters: int, flush: torch.Tensor) -> tuple:
    """(K8's device ms, the copy stream's busy ms, its operations, the
    layouts' sort ms) per ``fn()`` call, each call after an L2 flush
    (torch.profiler): K8's kernels alone; every device operation on a
    stream that ran no K8 (the ring's copies; the slot set-up and the flush
    run on K8's stream); the ``torch.sort`` kernels on K8's stream.  Each
    profile is padded and retried as in :func:`device_ms`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt, pad in enumerate(PROFILE_PADS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        k8 = [e for e in dev if any(k in e.name for k in K8_KERNELS)]
        if k8:
            streams = {e.device_resource_id for e in k8}
            side = [e for e in dev if e.device_resource_id not in streams]
            sort = [e for e in dev if e.device_resource_id in streams
                    and "sort" in e.name.lower()]
            return (sum(e.time_range.elapsed_us() for e in k8) / iters / 1e3,
                    sum(e.time_range.elapsed_us() for e in side)
                    / iters / 1e3, len(side) // iters,
                    sum(e.time_range.elapsed_us() for e in sort)
                    / iters / 1e3)
        log(f"ring_device_ms: profile {attempt + 1} recorded no K8")
    raise AssertionError(f"the profiler saw no K8 in {len(PROFILE_PADS)} "
                         "profiles")


class delayed_receivers:
    """Within the block, every K8 launch is preceded on its stream by
    ``torch.cuda._sleep``: each receiver's aggregate runs late, and only
    the ack events keep the copy stream from overwriting a slot before it
    has been read."""

    def __enter__(self):
        from mpqe_tpu_torch.ops import ring

        self.saved = ring._launch_hop

        def late(*a):
            torch.cuda._sleep(RING_SLEEP_CYCLES)
            return self.saved(*a)

        ring._launch_hop = late
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import ring

        ring._launch_hop = self.saved
        return False


def ring_library(c, layer, R: int):
    """K8's yardstick, several PyTorch calls (no single call computes
    K8): per hop one ``torch.bmm`` of the relation-chunked source rows by
    their relations' combined W and one ``index_add_`` of the messages
    into their destinations, on the operands of K8's own layouts gathered
    before the timing (as K5's yardstick)."""
    from mpqe_tpu_torch.ops import ring

    P, x = c["P"], c["x"]
    block = x.shape[0] // P
    devs = c["mesh"].axis_devices("data")
    g = ring._groups(devs, layer, x, c["edges"], block, R,
                     "plain")[devs[0]]
    rt, dev = g.route, x.device
    w = ring.combined_weights(g.basis, g.coeff)
    L, _, N = g.out.shape
    live = rt.live.tolist()
    hops = []
    for s_, nl in enumerate(live):
        if nl == 0:  # no edge reaches a part at this hop
            continue
        rows = nl * rt.chunk
        xs = g.comm_rows[rt.src[s_, :rows].long()].view(nl, rt.chunk,
                                                         x.shape[1])
        wc = w[rt.crel[s_, :nl].long()]
        drow, doffs = rt.drow[s_].long(), rt.doffs[s_].long()
        pos = torch.arange(drow.shape[1], device=dev).expand(L, -1)
        r = torch.searchsorted(doffs[:, 1:].contiguous(), pos.contiguous(),
                               right=True)
        ok = pos < doffs[:, -1:]
        dest = torch.zeros(rows + 1, dtype=torch.long, device=dev)
        at = torch.where(ok, drow, rows)
        dest[at.reshape(-1)] = (r + torch.arange(L, device=dev)[:, None]
                                * block).reshape(-1)
        hops.append((xs, wc, dest[:rows]))
    out = torch.zeros((L * block, N), device=dev)

    def fn():
        for xs, wc, dest in hops:
            out.index_add_(0, dest, torch.bmm(xs, wc).view(-1, N))

    return fn


def phase_ring(layer, cfg, device, gen, flush):
    """K8's drive (counted from 0: 6 + 2 P launches per layer call), then
    for each case K8 against its plain version and the f32 oracles, the
    port's ``rgcn_ring_halo`` and the single-device ``rgcn_sparse``, under
    ``ops/ring.py ring_gate``; its two negative controls (the plain version
    with one edge's rel changed, with one edge's src moved) failing it; a
    repeat and a run with delayed receivers equal to the first; times
    beside the bound (and PR 5's count of it), the copy stream's busy
    time, the plain version and the yardstick.  Returns (launches of the
    drive, the JSON fields: sums over the 7 template layouts)."""
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel import halo

    d, R, bb = cfg.embed_dim, cfg.n_rels, layer.basis.shape[0]
    cases = list(ring_cases(cfg, gen, device))

    def k8(c):
        return ring.rgcn_ring_halo_rdma(c["mesh"], layer, c["x"],
                                        *c["edges"], R)

    ring.rgcn_ring_halo_rdma.launches = 0
    with torch.no_grad():
        outs = [k8(c) for c in cases]
    torch.cuda.synchronize()
    launches = ring.rgcn_ring_halo_rdma.launches
    want = sum(6 + 2 * c["P"] for c in cases)
    log(f"kernel.ring: launches {launches} in {len(cases)} layer calls "
        f"(expected {want}: 6 + 2 P per call)")
    if launches != want:
        raise AssertionError(f"K8 launches {launches} != {want}")
    acc = new_acc()
    general_ref = None
    for c, got in zip(cases, outs):
        label, P, x, edges, n = c["label"], c["P"], c["x"], c["edges"], c["n"]
        block = x.shape[0] // P
        with torch.no_grad():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            plain = ring.rgcn_ring_halo_rdma_reference(c["mesh"], layer, x,
                                                       *edges, R)
            b.record()
            xla = halo.rgcn_ring_halo(c["mesh"], layer, x, *edges, R)
            if label != "general" or general_ref is None:
                ref1 = rgcn_ops.rgcn_sparse(x[:n], layer, *c["single"], R)
                if label == "general":
                    general_ref = ref1
            else:  # the same graph and x at every ring size
                ref1 = general_ref
            again = k8(c)
            with delayed_receivers():
                late = k8(c)
            controls = [ring.rgcn_ring_halo_rdma_reference(
                c["mesh"], layer, x, *ce, R)
                for ce in ring.ring_controls(edges, R, block)]
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        gate = ring.ring_gate(got, plain, [(got, xla), (got[:n], ref1)])
        ctl = [ring.ring_gate(got, cp) for cp in controls]
        repeat, same_late = torch.equal(again, got), torch.equal(late, got)
        line = (f"kernel.ring {label:14s} P={P} N={x.shape[0]} E={c['E']} "
                f"gate_ok={gate['ok']} err_vs_plain="
                f"{gate['err_vs_plain']:.3e} err_vs_rgcn_ring_halo="
                f"{gate['err_vs_oracles'][0]:.3e} err_vs_rgcn_sparse="
                f"{gate['err_vs_oracles'][1]:.3e} controls_fail="
                f"{not any(g['ok'] for g in ctl)} (rel "
                f"{ctl[0]['err_vs_plain']:.3e}, src "
                f"{ctl[1]['err_vs_plain']:.3e}) repeat_equal={repeat} "
                f"delayed_receivers_equal={same_late}")
        if (not gate["ok"] or any(g["ok"] for g in ctl) or not repeat
                or not same_late):
            log(line + " FAIL")
            raise AssertionError(line)
        acc["max_abs_err"] = max(acc["max_abs_err"],
                                 float((got - plain).abs().max()))
        del plain, xla, late, again, controls
        devs = c["mesh"].axis_devices("data")
        with torch.no_grad():  # the layout kernels against ring_route
            lay_k, lay_p = (ring._groups(devs, layer, x, edges, block, R,
                                         kind)[devs[0]].route
                            for kind in ("kernel", "plain"))
        lay_ok = ring.route_matches(lay_k, lay_p)
        line += f" layout_equal_plain={lay_ok}"
        if not lay_ok:
            log(line + " FAIL")
            raise AssertionError(line)
        del lay_k, lay_p
        iters = BIG_ITERS if label == "general" else ITERS
        with torch.no_grad():
            ms = time_ms(lambda: k8(c), iters, flush)
            k_ms, copy_ms, n_copies, sort_ms = ring_device_ms(
                lambda: k8(c), iters, flush)
            lib_fn = ring_library(c, layer, R)
            lib_ms = time_ms(lib_fn, iters, flush)
            del lib_fn
        work = k8_work(x.shape[0], d, d, bb, R, c["E"], P)
        old = max(bound_times(k8_work_pr5(x.shape[0], d, d, bb, R, c["E"],
                                          P)))
        if label == "general":
            t_b, t_o = bound_times(work)
            bound, by = max(t_b, t_o), ("bytes" if t_b >= t_o
                                        else "operations")
        else:
            bound, by = add_case(acc, ms, plain_ms, lib_ms, work, k_ms)
        log(line + f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
            f"sort_ms={sort_ms:.4f} "
            f"copy_stream_ms={copy_ms:.4f} ({n_copies} operations; the "
            f"ring's copies carry {(P - 1) * x.shape[0] * d * 4} B) plain_ms="
            f"{plain_ms:.4f} library_ms={lib_ms:.4f} (several calls: "
            f"torch.bmm and index_add_ per hop) bound_ms={bound:.6f} ({by}: "
            f"{work[0]} B, {work[2]} f32 FLOP or {work[3]} TF32 FLOP) "
            f"pr5_bound_ms={old:.6f}")
    del outs, cases, general_ref
    log(f"kernel.ring sum of 7 at B={TRAIN_BATCH} P={RING_TEMPLATE_PARTS}: "
        f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
        f"plain_ms={acc['plain_ms']:.4f} library_ms={acc['library_ms']:.4f} "
        f"(several calls) bound_ms={acc['bound_ms']:.6f}")
    return launches, finish_acc(acc)


def recheck_halo_step(state, cfg, stores, device, loss_fn, label):
    """One batch per structure from the trained state through the halo
    loss and through ``dense_batch_loss``: the same loss and gradients
    (<= TOL_ORACLE relative; f32 both, other sum orders)."""
    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    model = state.model
    params = dict(model.named_parameters())
    for structure, f_stores in stores.items():
        fstore = max(f_stores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(
            fstore, np.arange(min(fstore.n_queries, TRAIN_BATCH)),
            TRAIN_BATCH, 4, 11)
        t = loop_mod.batch_tensors(batch, device)
        loss_h = loss_fn(model, cfg, structure, *t)
        g_h = torch.autograd.grad(loss_h, list(params.values()),
                                  allow_unused=True)
        loss_d = mpqe_mod.dense_batch_loss(model, cfg, structure, *t)
        g_d = torch.autograd.grad(loss_d, list(params.values()),
                                  allow_unused=True)
        lh, ld = float(loss_h.detach()), float(loss_d.detach())
        e_loss = abs(lh - ld) / max(abs(ld), 1e-12)
        e_grad = tree_rel_err(dict(zip(params, g_h)), dict(zip(params, g_d)))
        line = (f"{label}.recheck {structure:14s} loss={lh:.6f} "
                f"loss_err_vs_dense={e_loss:.3e} "
                f"grad_err_vs_dense={e_grad:.3e}")
        log(line)
        if e_loss > TOL_ORACLE or e_grad > TOL_ORACLE or not np.isfinite(lh):
            raise AssertionError(line)


def phase_halo_train(kg, train_q, device):
    """``run_train`` on the card through ``make_halo_train_step``'s loss
    (``rgcn_ring_halo`` and ``rgcn_dst_partitioned``) on HALO_PARTS parts
    of one card, HALO_STEPS steps each: finite losses, step p50/p95 and
    real queries/s, one recheck per structure against the dense loss and
    a profile of PROFILE_STEPS steps."""
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import halo_train as ht
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    mesh = make_mesh((HALO_PARTS, 1), devices=[device] * HALO_PARTS)
    stores = build_stores(train_q, kg=kg)
    for kind in ("ring", "gather"):
        label = f"halo.train.{kind}"
        tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                                  max_steps=HALO_STEPS, val_every=1 << 30,
                                  burn_in_structure="none", seed=0)
        gen = torch.Generator(device=device).manual_seed(3)
        state = ht.init_halo_train_state(gen, cfg, tc, mesh)
        step = ht.make_halo_train_step(cfg, state.optimizer, mesh,
                                       layer_kind=kind)
        real = []  # per step, the batch's real rows

        def counted(*a):
            real.append(a[-1].sum())
            return step(*a)

        records = []
        t0 = time.perf_counter()
        loop_mod.run_train(state, cfg, tc, train_q, log_fn=records.append,
                           train_step=counted, kg=kg, train_stores=stores)
        wall = time.perf_counter() - t0
        steps = [r for r in records if "loss" in r]
        losses = [r["loss"] for r in steps]
        ms = np.asarray([r["seconds"] * 1e3 for r in steps])
        if len(losses) != HALO_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: {len(losses)} steps, finite: "
                                 f"{all(np.isfinite(losses))}")
        n_real = int(torch.stack(real).sum())
        STEP_MS[label] = (np.percentile(ms, 50), np.percentile(ms, 95))
        log(f"{label}: {state.step} steps in {wall:.2f} s on "
            f"{HALO_PARTS} parts of {torch.cuda.get_device_name(device)}: "
            f"loss first={losses[0]:.6f} last={losses[-1]:.6f} "
            f"step_ms_p50={np.percentile(ms, 50):.3f} "
            f"step_ms_p95={np.percentile(ms, 95):.3f} "
            f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} "
            f"({n_real} real rows of {len(ms) * TRAIN_BATCH}) "
            f"padded_rows_per_s={len(ms) * TRAIN_BATCH / ms.sum() * 1e3:.1f}")
        recheck_halo_step(state, cfg, stores, device,
                          ht.halo_batch_loss_fn(mesh, layer_kind=kind), label)
        ptc = dataclasses.replace(tc, max_steps=PROFILE_STEPS)
        profile_device(f"{label}.profile ({PROFILE_STEPS} steps)",
                       lambda: loop_mod.run_train(
                           state, cfg, ptc, train_q, train_step=step, kg=kg,
                           train_stores=stores))
        del state, step
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# The GQE baselines: training, serving, full ranking and the CLIs (no
# kernel: the reference computes them outside Pallas)
# ----------------------------------------------------------------------
GQE_STEPS = 30  # gqe.train; short, as HALO_STEPS
GQE_VARIANT_STEPS = 10  # each run of gqe.train.variants
GQE_SERVE_REQUESTS = 2
GQE_RECHECK_QUERIES = 8  # per structure, recomputed over every entity
GQE_TOL_LOSS = 1e-5  # card vs CPU copy: float32 both, sum order only
# gqe.train.variants: (label, --model, GQEConfig fields)
GQE_VARIANTS = (
    ("gqe_softand+transe", "gqe_softand", dict(decoder="transe")),
    ("gqe+distmult+min", "gqe", dict(decoder="distmult",
                                     intersection="min")),
    ("gqe+box", "gqe", dict(decoder="box")),
    ("gqe_softand+bibox", "gqe_softand", dict(decoder="bibox")),
    ("gqe+bilinear+neighborhood(pool, fanout 8)", "gqe",
     dict(decoder="bilinear", encoder="neighborhood", aggregator="pool")),
)
GQE_FANOUT = 8


def gqe_config(**kw):
    """A GQE config at the flagship KG's width (d = 128, 266 relations, 4
    modes, 1,000,000 entities)."""
    from mpqe_tpu_torch.models import gqe as gqe_mod

    base = {k: FLAGSHIP[k] for k in ("n_entities", "n_modes", "n_rels",
                                     "embed_dim")}
    return gqe_mod.GQEConfig(**base, **kw)


def gqe_train_config(steps: int):
    from mpqe_tpu_torch.train import loop as loop_mod

    # burn-in off: every structure trains from the first step
    return loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                                max_steps=steps, val_every=steps,
                                burn_in_structure="none", seed=0)


def gqe_run(kg, train_q, cfg, steps, device, val_q=None, table=None,
            seed=5):
    """``run_train`` of a fresh GQE model on the card for ``steps`` steps
    (one validation round through ``evaluate_batched`` with ``val_q``):
    (state, loss fn, records, real rows per step)."""
    import functools

    from mpqe_tpu_torch.models import gqe as gqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    tc = gqe_train_config(steps)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device,
                                      init_fn=gqe_mod.init_gqe)
    loss = functools.partial(gqe_mod.dense_batch_loss, neighbor_table=table)
    real = []

    def counted(*a):
        real.append(a[-1].sum())
        return loss(*a)

    records = []
    loop_mod.run_train(state, cfg, tc, train_q, val_queries=val_q,
                       log_fn=records.append, batch_loss_fn=counted, kg=kg,
                       neighbor_table=table)
    losses = [r["loss"] for r in records if "loss" in r]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{len(losses)} steps, finite: "
                             f"{all(np.isfinite(losses))}")
    return state, loss, records, real


def step_line(records, real) -> str:
    """Step p50/p95 (each step's seconds end with the host reading its
    loss) and the real queries per second."""
    ms = np.asarray([r["seconds"] * 1e3 for r in records if "loss" in r])
    n_real = int(torch.stack(real).sum())
    return (f"step_ms_p50={np.percentile(ms, 50):.3f} "
            f"step_ms_p95={np.percentile(ms, 95):.3f} "
            f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} "
            f"({n_real} real rows of {len(ms) * TRAIN_BATCH})")


def recheck_gqe_step(model, cfg, stores, device, loss_fn) -> None:
    """One step per structure from the trained state on the card and on
    a CPU copy of the model: the same loss (<= GQE_TOL_LOSS relative) and
    gradients (per leaf mean|diff| / mean|ref| <= TOL_PLAIN; the
    max-element figure printed beside it)."""
    import copy

    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.train import loop as loop_mod

    cpu = copy.deepcopy(model).to("cpu")
    for structure, f_stores in stores.items():
        fstore = max(f_stores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(fstore, np.arange(fstore.n_queries),
                                    TRAIN_BATCH, 4, 11)
        grads = []
        for m, dev in ((model, device), (cpu, torch.device("cpu"))):
            params = dict(m.named_parameters())
            loss = loss_fn(m, cfg, structure,
                           *loop_mod.batch_tensors(batch, dev))
            g = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
            grads.append((float(loss.detach()), {
                n: None if v is None else v.cpu()
                for n, v in zip(params, g)}))
        (lk, gk), (lp, gp) = grads
        e_loss = abs(lk - lp) / max(abs(lp), 1e-12)
        e_grad, e_max = tree_mean_err(gk, gp), tree_rel_err(gk, gp)
        line = (f"gqe.train.recheck {structure:14s} loss={lk:.6f} "
                f"loss_err_vs_cpu={e_loss:.3e} grad_mean_err={e_grad:.3e} "
                f"grad_max_err={e_max:.3e}")
        log(line)
        if e_loss > GQE_TOL_LOSS or e_grad > TOL_PLAIN or \
                not np.isfinite(lk):
            raise AssertionError(line)
    del cpu


def phase_gqe_train(kg, train_q, val_q, device):
    """``run_train`` of ``--model gqe --decoder bilinear --intersection
    deepsets`` on the card, GQE_STEPS steps and one validation round;
    the recheck against a CPU copy; a profile of PROFILE_STEPS steps."""
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = gqe_config(decoder="bilinear", intersection="deepsets")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state, loss, records, real = gqe_run(kg, train_q, cfg, GQE_STEPS,
                                         device, val_q=val_q)
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in records if "loss" in r]
    vals = [r["val"] for r in records if "val" in r]
    if len(vals) != 1:
        raise AssertionError(f"gqe.train: {len(vals)} validation rounds")
    name = torch.cuda.get_device_name(device)
    log(f"gqe.train: {state.step} steps of batch {TRAIN_BATCH} in "
        f"{wall:.2f} s on {name}: loss first={losses[0]:.6f} "
        f"last={losses[-1]:.6f}; val macro_auc={vals[0]['auc_macro']:.4f} "
        f"apr_macro={vals[0]['apr_macro']:.2f}; {step_line(records, real)}; "
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    stores = build_stores(train_q, kg=kg)
    recheck_gqe_step(state.model, cfg, stores, device, loss)
    ptc = dataclasses.replace(gqe_train_config(PROFILE_STEPS),
                              val_every=1 << 30)
    profile_device(f"gqe.train.profile ({PROFILE_STEPS} steps)",
                   lambda: loop_mod.run_train(state, cfg, ptc, train_q,
                                              batch_loss_fn=loss, kg=kg,
                                              train_stores=stores))
    del state
    torch.cuda.empty_cache()


def phase_gqe_variants(kg, train_q, device):
    """GQE_VARIANT_STEPS steps of each of GQE_VARIANTS on the card: finite
    losses and step p50 (the neighborhood table built for the 1M-entity
    KG, its build timed)."""
    from mpqe_tpu_torch.models import aggregators as agg_mod

    for label, model_flag, kw in GQE_VARIANTS:
        cfg = gqe_config(soft_and=model_flag == "gqe_softand", **kw)
        table = None
        if cfg.encoder == "neighborhood":
            t0 = time.perf_counter()
            table = agg_mod.build_neighbor_table_device(
                kg, fanout=GQE_FANOUT, seed=0, device=device)
            torch.cuda.synchronize()
            log(f"gqe.train.variants {label}: neighbor table "
                f"[{kg.n_entities}, {GQE_FANOUT}] built in "
                f"{time.perf_counter() - t0:.2f} s")
        try:
            state, _, records, real = gqe_run(kg, train_q, cfg,
                                              GQE_VARIANT_STEPS, device,
                                              table=table)
        except AssertionError as e:
            raise AssertionError(f"gqe.train.variants {label}: {e}") from e
        losses = [r["loss"] for r in records if "loss" in r]
        log(f"gqe.train.variants {label}: {state.step} steps, loss "
            f"first={losses[0]:.6f} last={losses[-1]:.6f}; "
            f"{step_line(records, real)}")
        del state, table
        torch.cuda.empty_cache()


def gqe_serving_models(device):
    """(label, cfg, model) of the three served heads: bilinear (cosine),
    box, and bibox with SoftAnd; random weights from seeds."""
    from mpqe_tpu_torch.models import gqe as gqe_mod

    out = []
    for i, (label, kw) in enumerate((
            ("bilinear", dict(decoder="bilinear")),
            ("box", dict(decoder="box")),
            ("bibox_softand", dict(decoder="bibox", soft_and=True)))):
        cfg = gqe_config(**kw)
        gen = torch.Generator(device=device).manual_seed(20 + i)
        out.append((label, cfg, gqe_mod.init_gqe(gen, cfg, device=device)))
    return out


def gqe_cpu_top_k(model_cpu, cfg, structure, arrays, emode_cpu, k):
    """Top-k over every entity of one packed dispatch's rows, recomputed
    on the CPU (the normalized table built once; the box distance in
    cache-sized entity chunks: the chunk changes no score)."""
    from mpqe_tpu_torch.models import gqe as gqe_mod
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.serve import top_k

    ne, _, er, _, tm = arrays
    ent_t = None
    if cfg.decoder != "box":
        ent_t = mpqe_mod._l2_normalize(model_cpu.emb.ent.detach()).t()
    saved = gqe_mod.BOX_CHUNK_BYTES
    gqe_mod.BOX_CHUNK_BYTES = 4 << 20
    try:
        with torch.inference_mode():
            scores = gqe_mod.rank_scores(model_cpu, cfg, structure, ne, er,
                                         None, ent_t)
            scores.masked_fill_(emode_cpu[None, :] != tm[:, None],
                                float("-inf"))
            return top_k(scores, k)
    finally:
        gqe_mod.BOX_CHUNK_BYTES = saved


def recheck_gqe_dispatch(server, model_cpu, cfg, structure, req, answers):
    """One dispatch of ``structure``: every served score equals
    ``gqe.score_queries`` of the returned ids (row gathers, not the rank
    matrix) within TOL_SCORE; for its first GQE_RECHECK_QUERIES queries
    the top-k ids and scores equal a CPU recomputation over every
    entity (scores within TOL_SCORE)."""
    from mpqe_tpu_torch.models import gqe as gqe_mod

    qs = [q for q in req if q.formula.structure == structure]
    pos = [i for i, q in enumerate(req) if q.formula.structure == structure]
    got_ids = np.stack([answers[i].entity_ids for i in pos])
    got_sc = np.stack([answers[i].scores for i in pos])
    _, *arrays = server._pack(qs)
    n = len(qs)
    ne, er = (torch.from_numpy(arrays[i][:n]).to(server.device)
              for i in (0, 2))
    with torch.inference_mode():
        rows = gqe_mod.score_queries(
            server.model, cfg, structure, ne, er,
            torch.from_numpy(got_ids).to(server.device)).cpu().numpy()
    row_err = float(np.abs(rows - got_sc).max())
    m = min(GQE_RECHECK_QUERIES, n)
    cpu_arrays = [torch.from_numpy(a[:m]) for a in arrays]
    emode = torch.from_numpy(server.entity_mode)
    t0 = time.perf_counter()
    ref_sc, ref_ids = gqe_cpu_top_k(model_cpu, cfg, structure, cpu_arrays,
                                    emode, got_ids.shape[1])
    cpu_s = time.perf_counter() - t0
    ids_equal = bool(np.array_equal(ref_ids.numpy(), got_ids[:m]))
    top_err = float(np.abs(ref_sc.numpy() - got_sc[:m]).max())
    line = (f"gqe.serve.recheck {structure:14s} n={n} "
            f"score_queries_err={row_err:.3e} cpu_top_k: ids_equal="
            f"{ids_equal} score_err={top_err:.3e} ({m} queries, "
            f"{cpu_s:.2f} s on the CPU)")
    log(line)
    if row_err > TOL_SCORE or top_err > TOL_SCORE or not ids_equal:
        raise AssertionError(line)


def phase_gqe_serve(kg, device):
    """A ``QueryServer`` per served head answers GQE_SERVE_REQUESTS
    requests of BATCH queries drawn across all 7 structures: answers
    checked, one dispatch per structure rechecked, latency printed."""
    import copy

    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.serve import QueryServer

    t0 = time.perf_counter()
    _, reqs = sample_stream(kg, seed=321, n_mixed=GQE_SERVE_REQUESTS)
    log(f"setup: gqe.serve sampled {sum(map(len, reqs))} queries "
        f"{time.perf_counter() - t0:.2f} s")
    name = torch.cuda.get_device_name(device)
    for label, cfg, model in gqe_serving_models(device):
        server = QueryServer(model, cfg, kg.entity_mode, device=device)
        server.warmup(STRUCTURE_NAMES, batch=1, k=K)
        lat, served = [], []
        for req in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers = server.answer(req, k=K)
            lat.append((time.perf_counter() - t0) * 1e3)
            served.append((req, answers))
        for req, answers in served:
            check_answers(server, req, answers, K)
        ms = np.asarray(lat)
        log(f"gqe.serve {label}: {len(ms)} requests of {BATCH} queries on "
            f"{name}: latency_ms_p50={np.percentile(ms, 50):.3f} "
            f"latency_ms_p95={np.percentile(ms, 95):.3f} "
            f"queries_per_s={len(ms) * BATCH / ms.sum() * 1e3:.1f} "
            f"(max_batch={server.max_batch})")
        model_cpu = copy.deepcopy(model).to("cpu")
        req, answers = served[0]
        for s in STRUCTURE_NAMES:
            recheck_gqe_dispatch(server, model_cpu, cfg, s, req, answers)
        del server, model, model_cpu
        torch.cuda.empty_cache()


def phase_gqe_ranking(kg, val_q, device):
    """``full_ranking`` of the bilinear and the box model against every
    entity; one structure's ranks recounted row by row on the card."""
    from mpqe_tpu_torch.data.batcher import bucket_size
    from mpqe_tpu_torch.models import gqe as gqe_mod
    from mpqe_tpu_torch.train import evaluation

    es = evaluation.make_eval_set(val_q, 200, require_negatives=False)
    n_q = sum(d["target"].shape[0] for d in es.by_structure.values())
    emode = torch.from_numpy(kg.entity_mode.astype(np.int32)).to(device)
    for label, cfg, model in gqe_serving_models(device)[:2]:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        rk = evaluation.full_ranking(model, cfg, val_q, kg.entity_mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        for s, m in rk.items():
            log(f"gqe.eval.ranking {label} {s:14s} " + " ".join(
                f"{k}={v:.6f}" for k, v in m.items()))
        log(f"gqe.eval.ranking {label}: {n_q} queries against "
            f"{cfg.n_entities} entities in {wall:.3f} s "
            f"({n_q / wall:.1f} queries/s); max_memory_allocated="
            f"{peak:.2f} GiB")
        structure = "3-chain_inter"
        data = es.by_structure[structure]
        n = data["target"].shape[0]
        pad = [evaluation._pad_chunk(data[k], 0, n, bucket_size(n), device)
               for k in ("node_entity", "edge_rel")]
        with torch.no_grad():
            scores = gqe_mod.rank_scores(model, cfg, structure, *pad)
        ranks = []
        for i, t in enumerate(data["target"].tolist()):
            row = scores[i]
            ranks.append(1 + int(((row > row[t]) & (emode == emode[t])).sum()))
        want = evaluation._rank_metrics(np.asarray(ranks, np.float64),
                                        (1, 3, 10))
        line = (f"gqe.eval.ranking.recheck {label} {structure}: {n} ranks "
                f"recounted row by row: equal={want == rk[structure]}")
        log(line)
        if want != rk[structure]:
            raise AssertionError(f"{line}: {want} != {rk[structure]}")
        del model, scores
        torch.cuda.empty_cache()


def check_bibox_w(run_dir: str) -> None:
    """The run dir's model config, read as the serve and evaluate CLIs
    read it, keeps ``--bibox_w 0.5``."""
    import os

    from mpqe_tpu_torch.serve import config_from_json

    with open(os.path.join(run_dir, "model_config.json")) as f:
        cfg = config_from_json(json.load(f))
    log(f"gqe.cli: served config decoder={cfg.decoder} "
        f"soft_and={cfg.soft_and} encoder={cfg.encoder} "
        f"bibox_w={cfg.bibox_w}")
    if (cfg.decoder, cfg.soft_and, cfg.encoder, cfg.bibox_w) != (
            "bibox", True, "neighborhood", 0.5):
        raise AssertionError(f"gqe.cli: served config {cfg}")


# ----------------------------------------------------------------------
# The data path: npz and pickle datasets through the CLIs, and quality
# ----------------------------------------------------------------------
DATA_STEPS = 20  # the npz run and the raw-edge pkl run
PKL_STEPS = 200  # the pkl run, one validation round at its end
PKL_TRAIN_PER_STRUCTURE = 250  # prepare_dataset's multi-hop train queries
DATA_PACK_RELATIONS = 8  # raw-edge stores packed and checked
DATA_NEG = 16  # negatives per packed raw-edge query
# the pickle phase's KG: 30,000 entities on three 100 x 100 tori,
# 120,000 triples (the reference tool writes one Python query object per
# directed train edge, so the 10^6-triple KG stays in the npz phase)
RULE_KG = dict(n_entities=30_000, n_modes=3, n_base_rels=6, out_degree=2,
               seed=0)
DATA_CLI = ["--kernel", "fused_fwd", "--fused_backward", "pallas",
            "--embed_dim", "128", "--n_layers", "3", "--readout", "tgt",
            "--num_bases", "16", "--batch_size", str(TRAIN_BATCH),
            "--n_neg", "4"]
QUALITY_ARGS = ["--steps", "2000", "--dim", "128", "--bases", "16",
                "--train_per_structure", "1000", "--val_per_structure",
                "100"]
# held-out macro AUC gate of both quality arms: under the lowest of the
# JAX package's CPU runs of the same command (seeds 0-2: MPQE 0.786-0.859,
# GQE 0.895-0.928) by 0.086, well above chance (0.5); the port's initial
# weights come from torch generators, so its figures are not the JAX ones
QUALITY_GATE = 0.70
JAX_CPU_QUALITY = {"mpqe": (0.786, "0.786-0.859"),
                   "gqe": (0.895, "0.895-0.928")}


# step time p50 / p95 (ms) of the train runs, by label, for the bf16
# run's line
STEP_MS = {}


def tgt_counters(reset: bool = False) -> tuple:
    """(K1, K2, K3) launch counts, set to 0 first with ``reset``."""
    from mpqe_tpu_torch.ops import fused_fwd as ff

    fns = (ff.fused_tgt_forward, ff.fused_tgt_backward,
           ff.fused_tgt_forward_multi)
    if reset:
        for fn in fns:
            fn.launches = 0
    return tuple(fn.launches for fn in fns)


# what the last in-process CLI's main returned (the train CLI: its state)
CLI_RESULT = {}


def run_cli(main, argv, label: str) -> list:
    """``main(argv)`` of a CLI in-process (so its launches can be read),
    its standard output captured: the output lines.  Its return value is
    kept in ``CLI_RESULT[label]``."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        CLI_RESULT[label] = main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    log(f"{label}: {time.perf_counter() - t0:.2f} s, {len(lines)} lines")
    return lines


def train_cli_run(argv, label: str,
                  counted_loss: str = "dense_batch_loss_kernel_fused_fwd"
                  ) -> tuple:
    """The train CLI in-process on the card: its final line checked, K1
    and K2 once a step (each call of ``models.mpqe.<counted_loss>`` is
    one step), K3 in validation, every loss finite, the C++ packer
    feeding it (``"native_packer": true``).  A record of K steps a call
    (``--steps_per_call``) counts K steps, its seconds spread over them.
    Returns (the run's metrics records, (K1, K2, K3))."""
    import os
    import re

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import __main__ as train_cli

    real = []  # per step, the batch's real rows (the sum of query_mask)
    loss_fn = getattr(mpqe_mod, counted_loss)

    def counted(*a, **kw):
        real.append(a[-1].sum())
        return loss_fn(*a, **kw)

    setattr(mpqe_mod, counted_loss, counted)
    tgt_counters(reset=True)
    try:
        lines = run_cli(train_cli.main, argv, label)
    finally:
        setattr(mpqe_mod, counted_loss, loss_fn)
    k1, k2, k3 = tgt_counters()
    run_dir = argv[argv.index("--run_dir") + 1]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    steps = [r for r in records if "loss" in r]
    n_steps = sum(r.get("k", 1) for r in steps)
    vals = [r for r in records if "val" in r]
    loaded = [r for r in records if r.get("event") == "data_loaded"]
    ms = np.concatenate([[r["seconds"] * 1e3 / r.get("k", 1)]
                         * r.get("k", 1) for r in steps])
    STEP_MS[label] = (np.percentile(ms, 50), np.percentile(ms, 95))
    n_real = int(torch.stack(real).sum()) if real else 0
    log(f"{label}: {n_steps} steps in {len(steps)} calls; data loaded in "
        f"{loaded[0]['seconds']:.2f} s ({loaded[0]['n_entities']} entities, "
        f"{loaded[0]['n_triples']} triples; native_packer="
        f"{loaded[0].get('native_packer')}); launches K1={k1} K2={k2} "
        f"K3={k3}; loss first={steps[0]['loss']:.6f} "
        f"last={steps[-1]['loss']:.6f}; step_ms_p50="
        f"{np.percentile(ms, 50):.3f} step_ms_p95={np.percentile(ms, 95):.3f} "
        f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} ({n_real} real "
        f"rows of {len(ms) * TRAIN_BATCH}); {lines[-1]}")
    if not re.fullmatch(rf"final step={n_steps} macro_auc=\S+ "
                        rf"macro_apr=\S+", lines[-1]):
        raise AssertionError(f"{label}: final line {lines[-1]!r}")
    if not all(np.isfinite([r["loss"] for r in steps])):
        raise AssertionError(f"{label}: a loss is not finite")
    if loaded[0].get("native_packer") is not True:
        raise AssertionError(f"{label}: the C++ packer did not feed the "
                             f"run: {loaded[0]}")
    if not (k1 == k2 == n_steps == len(real)) or k3 == 0 or not vals:
        raise AssertionError(f"{label}: launches K1={k1} K2={k2} K3={k3} "
                             f"over {n_steps} steps, {len(vals)} "
                             "validation rounds")
    return records, (k1, k2, k3)


def check_raw_edge_batches(stores, kg, pack=None,
                           label: str = "data.npz") -> None:
    """One batch of TRAIN_BATCH from each of the DATA_PACK_RELATIONS
    largest raw-edge stores, by ``pack`` (the numpy packer unless given):
    every unmasked negative of the range mode, not its query's target and
    outside its head's answer set."""
    from mpqe_tpu_torch.data.store import pack_dense_batch_np

    pack_dense_batch_np = pack or pack_dense_batch_np
    rng = np.random.default_rng(0)
    largest = sorted(stores, key=lambda s: -s.n_queries)
    n_neg = n_masked = 0
    t0 = time.perf_counter()
    for i, s in enumerate(largest[:DATA_PACK_RELATIONS]):
        pick = rng.integers(0, s.n_queries, size=TRAIN_BATCH).astype(np.int64)
        b = pack_dense_batch_np(s, pick, TRAIN_BATCH, DATA_NEG, seed=i)
        mode = s.formula.node_modes[1]
        for qi, tgt, row, m in zip(pick, b.target, b.negatives,
                                   b.neg_mask):
            g = s.ans_idx[qi]
            answers = s.ans_pool[s.ans_ptr[g]:s.ans_ptr[g + 1]]
            negs = row[m > 0]
            n_neg += negs.size
            n_masked += int((m == 0).sum())
            if (kg.entity_mode[negs] != mode).any() or (negs == tgt).any() \
                    or np.isin(negs, answers).any():
                raise AssertionError(
                    f"raw-edge batch of relation {s.formula.rels[0]}: "
                    f"query {qi} has a negative of another mode, its "
                    "target or one of its answers")
    log(f"{label}: {DATA_PACK_RELATIONS} batches of {TRAIN_BATCH} packed "
        f"in {time.perf_counter() - t0:.2f} s: {n_neg} negatives of the "
        f"range mode, none a target or an answer of its head; {n_masked} "
        "slots masked")


def phase_data_npz(kg, tmp: str, device) -> tuple:
    """``data.npz``: the flagship KG through ``save_kg_npz`` /
    ``load_kg_npz`` (equal arrays), ``stores_from_edges`` over its 2M
    directed edges with packed batches checked, then the train CLI on
    ``--data npz:`` with a trace window (:func:`check_train_trace`).
    Returns its (K1, K2, K3) launches."""
    import os

    from mpqe_tpu_torch.data import loader
    from mpqe_tpu_torch.data.store import stores_from_edges

    path = os.path.join(tmp, "kg.npz")
    t0 = time.perf_counter()
    loader.save_kg_npz(path, kg)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = loader.load_kg_npz(path)
    t_load = time.perf_counter() - t0
    for f in ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
              "tails"):
        if not np.array_equal(getattr(back, f), getattr(kg, f)):
            raise AssertionError(f"data.npz: {f} differs after the round "
                                 "trip")
    log(f"data.npz: save_kg_npz {t_save:.2f} s, load_kg_npz {t_load:.2f} s "
        f"({os.path.getsize(path) / 2**20:.1f} MiB; {back.n_entities} "
        f"entities, {back.n_triples} triples): arrays equal")
    t0 = time.perf_counter()
    stores = stores_from_edges(back)["1-chain"]
    t_st = time.perf_counter() - t0
    n_q = sum(s.n_queries for s in stores)
    log(f"data.npz: stores_from_edges {t_st:.2f} s: {len(stores)} stores, "
        f"{n_q} edge queries, {len({id(s.fallback_pool) for s in stores})} "
        "fallback pools")
    if n_q != 2 * kg.n_triples:
        raise AssertionError(f"data.npz: {n_q} edge queries for "
                             f"{kg.n_triples} triples")
    check_raw_edge_batches(stores, back)
    del stores, back
    run = os.path.join(tmp, "npz_run")
    records, launches = train_cli_run(
        ["--data", f"npz:{path}", *DATA_CLI, "--device", str(device),
         "--steps", str(DATA_STEPS),
         "--val_every", str(DATA_STEPS), *TRACE_ARGS, "--run_dir", run],
        "data.npz train.cli")
    check_train_trace(records, run)
    return launches


def phase_data_pkl(tmp: str, device) -> tuple:
    """``data.pkl``: a rule KG prepared into a GQE-layout directory by
    ``python -m mpqe_tpu_torch.tools.prepare_dataset``, trained on with
    ``--data pkl:`` (and without its ``train_edges.pkl``: the raw-edge
    stores), evaluated with ``--split`` and ``--use test``, and answered
    in bulk by ``serve --answer``.  Returns its (K1, K2, K3) launches."""
    import os
    import shutil

    from mpqe_tpu_torch import evaluate as eval_cli
    from mpqe_tpu_torch.data import loader
    from mpqe_tpu_torch.data.sampler import make_rule_kg

    t0 = time.perf_counter()
    rule = make_rule_kg(**RULE_KG)
    npz = os.path.join(tmp, "rule.npz")
    loader.save_kg_npz(npz, rule)
    log(f"data.pkl: make_rule_kg {time.perf_counter() - t0:.2f} s "
        f"({rule.n_entities} entities, {rule.n_triples} triples)")
    data = os.path.join(tmp, "rule")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpqe_tpu_torch.tools.prepare_dataset",
         "--npz", npz, "--out", data, "--train_per_structure",
         str(PKL_TRAIN_PER_STRUCTURE)], capture_output=True, text=True,
        timeout=900)
    t_prep = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"prepare_dataset failed:\n{proc.stderr[-4000:]}")
    for ln in proc.stdout.strip().splitlines():
        log(f"data.pkl: prepare_dataset: {ln}")
    with open(os.path.join(data, "dataset.json")) as f:
        meta = json.load(f)
    log(f"data.pkl: prepare_dataset {t_prep:.2f} s (subprocess)")

    run = os.path.join(tmp, "pkl_run")
    _, (k1, k2, k3) = train_cli_run(
        ["--data", f"pkl:{data}", *DATA_CLI, "--device", str(device),
         "--steps", str(PKL_STEPS),
         "--val_every", str(PKL_STEPS), "--run_dir", run],
        "data.pkl train.cli")

    bare = os.path.join(tmp, "rule_no_train_edges")
    shutil.copytree(data, bare)
    os.remove(os.path.join(bare, "train_edges.pkl"))
    records, launches = train_cli_run(
        ["--data", f"pkl:{bare}", *DATA_CLI, "--device", str(device),
         "--steps", str(DATA_STEPS),
         "--val_every", str(DATA_STEPS), "--run_dir",
         os.path.join(tmp, "pkl_raw_run")], "data.pkl.raw_edges train.cli")
    k1, k2, k3 = k1 + launches[0], k2 + launches[1], k3 + launches[2]
    derived = [r["edge_queries"] for r in records
               if r.get("event") == "raw_edge_1chain_derived"]
    log(f"data.pkl.raw_edges: raw_edge_1chain_derived edge_queries="
        f"{derived} (2 x {meta['train_triples']} train triples)")
    if derived != [2 * meta["train_triples"]]:
        raise AssertionError(f"data.pkl.raw_edges: derived {derived}")

    kg, _, _ = loader.load_graph_pickle(os.path.join(data,
                                                     "graph_data.pkl"))
    for use in ("val", "test"):
        tgt_counters(reset=True)
        lines = run_cli(eval_cli.main, ["--run_dir", run, "--split",
                                        "--use", use, "--device",
                                        str(device)],
                        f"data.pkl eval.cli --split --use {use}")
        n3 = tgt_counters()[2]
        k3 += n3
        for ln in lines:
            log(f"data.pkl eval.cli: {ln}")
        head, buckets = json.loads(lines[0]), [json.loads(ln)
                                               for ln in lines[1:]]
        queries = loader.load_split_queries(data, kg, use)
        n_eval = sum(len(qs) for by_f in queries.values()
                     for qs in by_f.values())
        names = [b["bucket"] for b in buckets]
        log(f"data.pkl eval.cli --use {use}: K3 launches {n3}; buckets "
            f"{[(b['bucket'], b['n']) for b in buckets]} of {n_eval} "
            "evaluated queries")
        if (head["use"] != use or names != ["seen_edges", "one_new_edge"]
                or sum(b["n"] for b in buckets) != n_eval or n3 == 0
                or not all(np.isfinite(b["auc_macro"]) for b in buckets)):
            raise AssertionError(f"data.pkl eval.cli --use {use}: {lines}")

    k3 += check_serve_answer(run, data, kg, tmp, device)
    return k1, k2, k3


def check_serve_answer(run, data, kg, tmp, device) -> int:
    """``serve --answer <data>/test_queries_3.pkl``: ids of each query's
    target mode, scores sorted, and ids equal to (scores within
    TOL_SCORE of) an in-process ``QueryServer.answer`` of the same
    queries.  Returns its K3 launches."""
    import os

    from mpqe_tpu_torch import evaluate as eval_cli
    from mpqe_tpu_torch import serve as serve_cli
    from mpqe_tpu_torch.data import loader

    pkl = os.path.join(data, "test_queries_3.pkl")
    out = os.path.join(tmp, "answers.npz")
    tgt_counters(reset=True)
    line = json.loads(run_cli(serve_cli.main, ["--run_dir", run, "--answer",
                                               pkl, "--out", out, "--device",
                                               str(device)],
                              "data.pkl serve.cli --answer")[-1])
    n3 = tgt_counters()[2]
    log(f"data.pkl serve.cli --answer: K3 launches {n3}; {json.dumps(line)}")
    got = np.load(out)
    grouped = loader.load_queries_pickle(pkl, kg)
    flat = [q for by_f in grouped.values() for qs in by_f.values()
            for q in qs]
    run_cfg, mc = eval_cli.read_run_dir(run)
    cfg = serve_cli.config_from_json(mc)
    _, _, model = eval_cli.restore_model(run, cfg, None, device)
    server = serve_cli.QueryServer(model, cfg, kg.entity_mode, device=device)
    want = server.answer(flat, k=K)
    ids, scores = got["entity_ids"], got["scores"]
    modes = np.asarray([q.formula.target_mode for q in flat])
    same_ids = np.array_equal(ids, np.stack([a.entity_ids for a in want]))
    err = float(np.abs(scores - np.stack([a.scores for a in want])).max())
    log(f"data.pkl serve.cli --answer: {line['queries']} queries "
        f"({line['seconds']:.4f} s, {line['queries_per_s']:.1f} "
        f"queries/s, hit@{K}={line['hit_at_k']:.4f}); target mode "
        f"{bool((kg.entity_mode[ids] == modes[:, None]).all())}, sorted "
        f"{bool((np.diff(scores, axis=1) <= 0).all())}, ids equal "
        f"in-process {same_ids}, score_err={err:.3e}")
    if not ((kg.entity_mode[ids] == modes[:, None]).all()
            and (np.diff(scores, axis=1) <= 0).all() and same_ids
            and err <= TOL_SCORE and n3 > 0 and line["queries"] == len(flat)
            and list(got["structure"]) == [q.formula.structure
                                           for q in flat]):
        raise AssertionError("data.pkl serve.cli --answer: check failed")
    return n3


BF16_STEPS = 50  # train.bf16: the flagship width through K1/K2 at bf16
SERVE_BF16_REQUESTS = 32  # serve.bf16: requests of BATCH queries
TABLE_DTYPES = ("float32", "bfloat16", "int8")
QUANT_OVERLAP = 0.8  # quantized top-10 overlap with the f32 table, and
QUANT_SCORE_ATOL = 0.05  # score tolerance: the reference's rule
# (tests/test_serve.py:183-201)


def phase_train_bf16(kg_path: str, tmp: str, device) -> tuple:
    """``train.bf16``: ``python -m mpqe_tpu_torch.train --dtype bfloat16
    --kernel fused_fwd --fused_backward pallas`` in-process on the
    flagship KG file (``--data npz:``) at the flagship width, BF16_STEPS
    steps with a run dir: K1 and K2 once a step, K3 in validation, every
    loss finite (:func:`train_cli_run`), the final checkpoint's every
    parameter and Adam moment in bf16; step p50 / p95 beside the f32
    runs'.  Returns (run dir, (K1, K2, K3))."""
    import os

    run_dir = os.path.join(tmp, "bf16_run")
    records, launches = train_cli_run(
        ["--data", f"npz:{kg_path}", *DATA_CLI, "--dtype", "bfloat16",
         "--device", str(device), "--steps", str(BF16_STEPS),
         "--val_every", str(BF16_STEPS), "--run_dir", run_dir],
        "train.bf16")
    bf16_checkpoint(run_dir, BF16_STEPS, "train.bf16")
    ref = " ".join(f"{k}: p50={v[0]:.3f} p95={v[1]:.3f}"
                   for k, v in STEP_MS.items() if k != "train.bf16")
    p50, p95 = STEP_MS["train.bf16"]
    log(f"train.bf16: step_ms_p50={p50:.3f} step_ms_p95={p95:.3f} on "
        f"{torch.cuda.get_device_name(device)}; float32 runs (ms) {ref}")
    return run_dir, launches


def phase_serve_bf16(run_dir: str, device) -> int:
    """``serve.bf16``: the serve CLI in-process on the ``train.bf16`` run
    dir with ``--table_dtype float32``, ``bfloat16`` and ``int8``, each
    answering SERVE_BF16_REQUESTS requests of BATCH queries over all 7
    structures (its JSON line: latency, queries/s, table bytes, peak
    memory; K3 once per layer of each dispatch), then ``QueryServer``s of
    the three tables on the same model answering the same queries: each
    quantized table's top-10 overlap with the float32 table's >=
    QUANT_OVERLAP and its scores within QUANT_SCORE_ATOL; int8 without
    cosine scoring refused.  Returns K3's launches."""
    from mpqe_tpu_torch import serve as serve_mod
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    k3 = 0
    for td in TABLE_DTYPES:
        tgt_counters(reset=True)
        torch.cuda.reset_peak_memory_stats(device)
        lines = run_cli(serve_mod.main, [
            "--run_dir", run_dir, "--table_dtype", td, "--requests",
            str(SERVE_BF16_REQUESTS), "--batch", str(BATCH), "--structures",
            ",".join(STRUCTURE_NAMES)], f"serve.bf16 --table_dtype {td}")
        n3 = tgt_counters()[2]
        out = json.loads(lines[-1])
        log(f"serve.bf16 --table_dtype {td}: K3 launches {n3}; "
            f"latency_ms_p50={out['latency_ms_p50']:.3f} "
            f"p95={out['latency_ms_p95']:.3f} "
            f"queries_per_s={out['queries_per_s']:.1f} "
            f"table_bytes={out['table_bytes']} "
            f"peak_mem_bytes={out['peak_mem_bytes']} "
            f"hit_at_k={out['hit_at_k']:.4f}")
        if n3 == 0 or out["table_dtype"] != td or not all(
                np.isfinite([out["latency_ms_p50"], out["queries_per_s"]])):
            raise AssertionError(f"serve.bf16 {td}: {lines[-1]}")
        k3 += n3

    args = serve_mod.parse_args(["--run_dir", run_dir])
    cfg, kg, model, _, nbr = serve_mod._from_run_dir(args, device)
    if cfg.dtype != torch.bfloat16:
        raise AssertionError(f"serve.bf16: the run's model is {cfg.dtype}")
    sampler = QuerySampler(kg, seed=7)
    per = SERVE_BF16_REQUESTS * BATCH // len(STRUCTURE_NAMES)
    queries = [q for s in STRUCTURE_NAMES
               for q in sampler.sample_queries(s, per, n_neg=1)]
    answers = {}
    for td in TABLE_DTYPES:
        server = serve_mod.QueryServer(model, cfg, kg.entity_mode,
                                       device=device, table_dtype=td)
        tgt_counters(reset=True)
        answers[td] = server.answer(queries, k=K)
        k3 += tgt_counters()[2]
        del server
    for td in TABLE_DTYPES[1:]:
        overlap = float(np.mean([
            len(set(a.entity_ids.tolist()) & set(b.entity_ids.tolist())) / K
            for a, b in zip(answers["float32"], answers[td])]))
        score_err = max(float(np.abs(a.scores - b.scores).max())
                        for a, b in zip(answers["float32"], answers[td]))
        line = (f"serve.bf16 {td} vs float32 table: {len(queries)} queries "
                f"top-{K} overlap={overlap:.4f} (>= {QUANT_OVERLAP}) "
                f"score_max_err={score_err:.4e} (<= {QUANT_SCORE_ATOL})")
        if overlap < QUANT_OVERLAP or score_err > QUANT_SCORE_ATOL:
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
    try:
        serve_mod.QueryServer(model, dataclasses.replace(
            cfg, scale_scores=False), kg.entity_mode, device=device,
            table_dtype="int8")
    except ValueError as e:
        log(f"serve.bf16: int8 without cosine scoring refused: {e}")
    else:
        raise AssertionError("serve.bf16: int8 without cosine served")
    return k3


def phase_quality(tmp: str, device) -> int:
    """``quality``: ``python -m mpqe_tpu_torch.tools.quality_bench`` with
    QUALITY_ARGS, in-process: both arms' held-out macro AUC and APR
    beside the JAX package's CPU figures, each AUC >= QUALITY_GATE.
    Returns its K3 launches (MPQE's validation rounds)."""
    import os

    from mpqe_tpu_torch.tools import quality_bench

    tgt_counters(reset=True)
    lines = run_cli(quality_bench.main,
                    QUALITY_ARGS + ["--out", os.path.join(tmp, "quality"),
                                    "--device", str(device)],
                    f"quality {' '.join(QUALITY_ARGS)}")
    n3 = tgt_counters()[2]
    arms = {r["model"]: r for r in (json.loads(ln) for ln in lines
                                    if ln.startswith("{"))}
    for model, (seed0, spread) in JAX_CPU_QUALITY.items():
        r = arms[model]
        log(f"quality {model}: macro_auc={r['auc_macro']:.4f} "
            f"macro_apr={r['apr_macro']:.2f} (JAX package on a CPU: seed 0 "
            f"{seed0}, seeds 0-2 {spread}; gate >= {QUALITY_GATE})")
    log(f"quality: K3 launches {n3} (MPQE validation rounds)")
    if not all(arms[m]["auc_macro"] >= QUALITY_GATE
               for m in JAX_CPU_QUALITY) or n3 == 0:
        raise AssertionError(f"quality: {arms}")
    return n3


# ----------------------------------------------------------------------
# The sparse routes at bf16: K5 on bf16 rows, K6 and K8 on bf16 leaves,
# the sparse evaluate and the sparse train routes of a bf16 model
# ----------------------------------------------------------------------
BF16_SPARSE_STEPS = 50  # train.bf16.fused, train.bf16.blocked
BF16_HALO_STEPS = 20  # halo.train.bf16
# the bf16 step rechecks (kernels against their plain versions, the halo
# loss against the dense one), per leaf in mean|diff| / mean|ref|: a bf16
# step is 2^-8 of a value, and the gradient scatters round after every
# add in bf16 (on the card by atomics, in an order that varies), so
# elements that take several adds move by a step or so; the loss within
# 1e-3 relative (the f32 sum over bf16 query vectors, a rare one-step
# flip of an element moving it)
TOL_BF16_STEP_GRAD = 1e-2
TOL_BF16_STEP_LOSS = 1e-3
# the halo loss against the dense loss at bf16: two routes that round
# their bf16 gradients at different points (the halo route gathers every
# node's mode row and every edge's coefficient row, as the reference's
# does, and their bf16 gradients, each rounded, sum into a few rows that
# cancel); measured in the mean form up to 7.9e-2 on an H100 (3-chain,
# layer 0's coefficients) and 4.7e-2 on a CPU (d = 128, 16 bases, B =
# 512, 7 structures), where the halo route's distance to the f32
# gradient stays within 1.9 x (2 x the dense route's + 1e-3).  A lost or
# doubled gradient term moves a leaf by ~1.
TOL_BF16_HALO_GRAD = 2e-1
# the sparse evaluate of a bf16 model (f32 activations, the reference's
# encode_sparse) against the dense encoder (a bf16 rounding per layer):
# scores part by ~1e-3, which swaps near-tied (positive, negative) pairs
TOL_BF16_EVAL_AUC = 1e-2
WIDE_K5_BF16 = ((200, 200), (768, 768), (768, 256))


def phase_rgcn_fused_bf16(layer_b, layer_f, cfg, device, gen, flush):
    """``kernel.rgcn_fused.bf16``: K5a and K5b on bf16 rows (gathered as
    stored, widened in the kernel; one of the three split-TF32 passes,
    whose products are exact zeros, skipped) on the 7 ``template_chunked``
    layouts at B = 512 and 131,072 and on the general graph: bit-equal to
    K5 on the f32 rows ``x.float()`` and to a repeat; at B = 512 and on
    the general graph <= TOL_PLAIN of the plain version and <= TOL_ORACLE
    of the f32 oracle, the negative control failing the plain gate; then
    at the wide widths (200, and 768 in k stages) on the WIDE_STRUCTURE
    template.  Times (kernel ms, L2 flushed, and device ms) beside the
    f32-row kernel's in the same run, the bound with 2-byte rows, the
    plain version and the ``torch.bmm`` yardstick (the f32 rows).
    Returns both kernels' fields for their ``bf16_rows`` variant."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURES

    d, R = cfg.embed_dim, cfg.n_rels
    basis, coeff = layer_b.basis.detach(), layer_b.coeff.detach()
    w_rel = layer_f.w_rel.detach()
    accs = {"K5a": new_acc(), "K5b": new_acc()}
    f32_rows = {"K5a": [0.0, 0.0], "K5b": [0.0, 0.0]}  # at 512, 131,072
    big = {"K5a": [0.0, 0.0], "K5b": [0.0, 0.0]}  # kernel, device ms

    def check(kid, label, B, x, src, norm, crel, chunk, w_b, c_b, w_r,
              K, N, plain_check):
        (fn, ref, w, kargs, c, ow, oc, w_bytes, c_bytes,
         w_c) = k5_operands(kid, w_b, c_b, w_r, crel, R, K, N)
        x32 = x.float()
        with torch.no_grad():
            got = fn(x, src, w, *kargs, norm, chunk)
            again = fn(x, src, w, *kargs, norm, chunk)
            wide = fn(x32, src, w, *kargs, norm, chunk)
        torch.cuda.synchronize()
        equal = torch.equal(bits(got), bits(wide))
        repeat = torch.equal(bits(got), bits(again))
        line = (f"kernel.rgcn_fused.bf16 {kid} {label:14s} B={B:6d} K={K} "
                f"N={N} E={src.shape[0]} bit_equal_f32_rows={equal} "
                f"repeat_equal={repeat}")
        ok = equal and repeat and bool(torch.isfinite(got).all())
        err = 0.0
        if plain_check:
            with torch.no_grad():
                plain = ref(x, src, w, c, norm, chunk)
                oracle = rf._edge_messages_xla(x, ow, oc, src, norm, crel, R,
                                               chunk)
                cut = ref(x, src, w, k5_control(c, crel, norm, chunk,
                                                kid == "K5a", R),
                          norm, chunk)
            e_plain, e_orc = rel_err(got, plain), rel_err(got, oracle)
            e_cut = rel_err(got, cut)
            err = float((got - plain).abs().max())
            line += (f" err_vs_plain={e_plain:.3e} err_vs_f32_oracle="
                     f"{e_orc:.3e} control_err={e_cut:.3e}")
            ok = (ok and e_plain <= TOL_PLAIN and e_orc <= TOL_ORACLE
                  and e_cut > TOL_PLAIN)
            del plain, oracle, cut
        if not ok:
            log(line + " FAIL")
            raise AssertionError(line)
        n = x.shape[0]
        real = norm != 0
        work = k5_work(src.shape[0], int(real.sum()), int(torch.unique(
            src[real].clamp(0, n - 1)).numel()), K, N, w_bytes, c_bytes, 2)
        iters = BIG_ITERS if B == TRAIN_BIG else ITERS
        per = 2 if kid == "K5a" else 1
        with torch.no_grad():
            ms = time_ms(lambda: fn(x, src, w, *kargs, norm, chunk), iters,
                         flush)
            k_ms = device_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                             iters, flush, K5_KERNELS, per)
            ms32 = time_ms(lambda: fn(x32, src, w, *kargs, norm, chunk),
                           iters, flush)
        return line, ms, k_ms, ms32, work, err, (fn, ref, w, c, w_c)

    for label, B, ch, n in k5_cases(cfg, gen, device):
        src = ch["src"].to(torch.int32).contiguous()
        norm = ch["norm"].float().contiguous()
        crel = ch["chunk_rel"].to(torch.int32).contiguous()
        chunk = ch["chunk"]
        x = torch.randn((n, d), generator=gen, device=device).to(
            torch.bfloat16)
        for kid in ("K5a", "K5b"):
            line, ms, k_ms, ms32, work, err, (fn, ref, w, c, w_c) = check(
                kid, label, B, x, src, norm, crel, chunk, basis, coeff,
                w_rel, d, d, B != TRAIN_BIG)
            t_b, t_o = bound_times(work)
            bound, by = max(t_b, t_o), ("bytes" if t_b >= t_o
                                        else "operations")
            if B == TRAIN_BATCH:
                xs_c = x[src.long().clamp(0, n - 1)].float().view(
                    -1, chunk, d)
                with torch.no_grad():
                    plain_ms = time_ms(lambda: ref(x, src, w, c, norm,
                                                   chunk), PLAIN_ITERS, flush)
                    lib_ms = time_ms(lambda: torch.bmm(xs_c, w_c), ITERS,
                                     flush)
                add_case(accs[kid], ms, plain_ms, lib_ms, work, k_ms)
                accs[kid]["max_abs_err"] = max(accs[kid]["max_abs_err"], err)
                f32_rows[kid][0] += ms32
                line += f" plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}"
                del xs_c
            elif B == TRAIN_BIG:
                big[kid][0] += ms
                big[kid][1] += k_ms
                f32_rows[kid][1] += ms32
            log(line + f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                f"f32_rows_kernel_ms={ms32:.4f} bound_ms={bound:.6f} ({by}: "
                f"{work[0]} B, {work[2]} f32 FLOP or {work[3]} TF32 FLOP)")
            del w_c
        del x
    s, B = WIDE_STRUCTURE, TRAIN_BATCH
    er, en = template_rel_norm(gen, cfg, s)
    ch = tl.template_chunked(s, er, en, B)
    n = B * STRUCTURES[s].n_nodes
    src = ch["src"].to(torch.int32).contiguous()
    norm = ch["norm"].float().contiguous()
    crel = ch["chunk_rel"].to(torch.int32).contiguous()
    for K, N in WIDE_K5_BF16:
        x = torch.randn((n, K), generator=gen, device=device).to(
            torch.bfloat16)
        wb = torch.randn((WIDE_BASES, K, N), generator=gen,
                         device=device) / K ** 0.5
        wc = torch.randn((R, WIDE_BASES), generator=gen, device=device)
        wr = torch.einsum("rb,bio->rio", wc, wb).contiguous()
        for kid in ("K5a", "K5b"):
            line, ms, k_ms, ms32, work, _, _ = check(
                kid, f"{s}.wide", B, x, src, norm, crel, ch["chunk"], wb,
                wc, wr, K, N, True)
            t_b, t_o = bound_times(work)
            log(line + f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                f"f32_rows_kernel_ms={ms32:.4f} bound_ms="
                f"{max(t_b, t_o):.6f}")
        del x, wb, wc, wr
    fields = {}
    for kid, acc in accs.items():
        log(f"kernel.rgcn_fused.bf16 {kid} sum of 7 at B={TRAIN_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"f32_rows_kernel_ms={f32_rows[kid][0]:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f}; at B={TRAIN_BIG}: "
            f"kernel_ms={big[kid][0]:.4f} device_ms={big[kid][1]:.4f} "
            f"f32_rows_kernel_ms={f32_rows[kid][1]:.4f}")
        fields[kid] = dict(finish_acc(acc), f32_rows_ms=f32_rows[kid][0],
                           big_ms=big[kid][0],
                           big_f32_rows_ms=f32_rows[kid][1])
    return fields


def phase_rgcn_blocked_bf16(layer_b, cfg, device, gen):
    """``kernel.rgcn_blocked.bf16``: the blocked layer (K6a forward and
    ``dx``, K6b) with bf16 leaves and bf16 rows against f32 leaves and
    rows of the same values (the kernels read bf16 either way), on the 7
    ``template_blocked`` layouts at B = 512 and the general graph: the
    output bit-equal, every gradient bf16, each leaf's bit-equal to the
    f32 leaves' gradient rounded to bf16 and the rows' to the bf16 sum of
    its two parts rounded (the self term's and K6a's ``dx``), a repeat
    bit-equal."""
    import copy

    from mpqe_tpu_torch.ops import rgcn_blocked as rb

    d, R = cfg.embed_dim, cfg.n_rels
    layer16 = copy.deepcopy(layer_b).to(torch.bfloat16)
    layer32 = copy.deepcopy(layer16).float()
    for label, B, bk, n in k6_cases(cfg, gen, device):
        if B == TRAIN_BIG:
            continue
        lays = rb.layouts_on(bk, device)
        x16 = torch.randn((n, d), generator=gen, device=device).to(
            torch.bfloat16)
        g = torch.randn((n, d), generator=gen, device=device)
        outs = []
        for layer, x in ((layer16, x16), (layer16, x16),
                         (layer32, x16.float())):
            xr = x.clone().requires_grad_()
            out = rb.rgcn_sparse_blocked(xr, layer, lays, R)
            grads = torch.autograd.grad(out, [xr, *layer.parameters()], g)
            outs.append((out.detach(), grads))
        torch.cuda.synchronize()
        (o16, g16), (o16b, g16b), (o32, g32) = outs
        out_equal = torch.equal(bits(o16), bits(o32))
        grads_bf16 = all(t.dtype == torch.bfloat16 for t in g16)
        grads_equal = all(torch.equal(bits(a), bits(b.to(torch.bfloat16)))
                          for a, b in zip(g16[1:], g32[1:]))
        # the rows' gradient has two parts, the self term's and K6a's dx,
        # each rounded to bf16 before their sum (as the reference's bf16
        # cotangents are): their f32 values from the f32 leaves, rounded,
        # then added in bf16
        with torch.no_grad():
            parts = (rb.messages_blocked(g, layer32.basis.transpose(1, 2),
                                         layer32.coeff, lays[1], R),
                     g @ layer32.w_self.t())
        want_x = sum(t.to(torch.bfloat16).float() for t in parts).to(
            torch.bfloat16)
        x_equal = torch.equal(bits(g16[0]), bits(want_x))
        repeat = torch.equal(bits(o16), bits(o16b)) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(g16, g16b))
        line = (f"kernel.rgcn_blocked.bf16 {label:14s} B={B:6d} "
                f"out_bit_equal_f32_leaves={out_equal} grads_bf16="
                f"{grads_bf16} leaf_grads_equal_f32_leaves_rounded="
                f"{grads_equal} x_grad_equal_rounded_parts={x_equal} "
                f"repeat_equal={repeat}")
        if not (out_equal and grads_bf16 and grads_equal and x_equal
                and repeat):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del outs, lays, x16, g


def phase_ring_bf16(layer, cfg, device, gen):
    """``kernel.ring.bf16``: K8 on a bf16 layer and bf16 rows (every
    operand taken up to f32 in the wrapper, as the reference takes it) at
    P = RING_TEMPLATE_PARTS on the general graph and the 7 template
    layouts: bit-equal to K8 on the widened operands, under ``ring_gate``
    against the plain version, 6 + 2 P launches a call.  Returns its
    launches."""
    import copy

    from mpqe_tpu_torch.ops import ring

    R = cfg.n_rels
    layer16 = copy.deepcopy(layer).to(torch.bfloat16)
    layer32 = copy.deepcopy(layer16).float()
    total = 0
    for c in ring_cases(cfg, gen, device):
        if c["P"] != RING_TEMPLATE_PARTS:
            continue
        x16 = c["x"].to(torch.bfloat16)
        before = ring.rgcn_ring_halo_rdma.launches
        with torch.no_grad():
            got = ring.rgcn_ring_halo_rdma(c["mesh"], layer16, x16,
                                           *c["edges"], R)
            n = ring.rgcn_ring_halo_rdma.launches - before
            wide = ring.rgcn_ring_halo_rdma(c["mesh"], layer32, x16.float(),
                                            *c["edges"], R)
            plain = ring.rgcn_ring_halo_rdma_reference(c["mesh"], layer16,
                                                       x16, *c["edges"], R)
        torch.cuda.synchronize()
        total += n
        gate = ring.ring_gate(got, plain)
        equal = got.dtype == torch.float32 and torch.equal(bits(got),
                                                           bits(wide))
        line = (f"kernel.ring.bf16 {c['label']:14s} P={c['P']} "
                f"bit_equal_widened={equal} gate_ok={gate['ok']} "
                f"err_vs_plain={gate['err_vs_plain']:.3e} launches={n}")
        if not (equal and gate["ok"] and n == 6 + 2 * c["P"]):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del got, wide, plain
    return total


def phase_eval_sparse_bf16(model, cfg, val_q, device):
    """``eval.sparse.bf16``: the per-formula ``evaluate`` of the flagship
    model and of a max-readout model at ``cfg.dtype = bfloat16`` through
    :class:`SparseEncode` (``encode_sparse(segment_backend="pallas")``:
    f32 activations, as the reference's): K4 launches equal to the
    expected counts; one formula per structure recomputed with the
    ``"xla"`` segment backend (<= TOL_ORACLE); per-structure AUC within
    TOL_BF16_EVAL_AUC of ``evaluate`` through the bf16 dense encoder.
    Returns the K4 launches."""
    from mpqe_tpu_torch.data.batcher import bucket_size, make_dense_batch
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import evaluation

    total = {"K4a": 0, "K4b": 0, "layout": 0}
    mcfg = mpqe_mod.MPQEConfig(**dict(FLAGSHIP, readout="max"))
    mmodel = mpqe_mod.init_mpqe(torch.Generator(device=device).manual_seed(
        8), mcfg, device=device)
    for label, (m, c) in (("eval.sparse.bf16", (model, cfg)),
                          ("eval.sparse_max.bf16", (mmodel, mcfg))):
        m16, c16, _, _ = bf16_twin(m, c)
        enc = SparseEncode()
        counters = k4_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = evaluation.evaluate(m16, c16, val_q, n_neg=64, encode_fn=enc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        dense = evaluation.evaluate(m16, c16, val_q, n_neg=64)
        worst = max(abs(a - dense.auc_by_structure[s])
                    for s, a in res.auc_by_structure.items())
        line = (f"{label}: evaluate through the sparse path (bf16 model, "
                f"readout {c16.readout}): {enc.calls} encode calls in "
                f"{wall:.3f} s; launches "
                + " ".join(f"{k}={v}" for k, v in launches.items())
                + f" (expected "
                f"{' '.join(f'{k}={v}' for k, v in enc.want.items())}); "
                f"macro_auc {res.macro_auc:.6f} vs the bf16 dense encoder's "
                f"{dense.macro_auc:.6f}, worst per-structure |diff| "
                f"{worst:.3e} (<= {TOL_BF16_EVAL_AUC})")
        log(line)
        if launches != enc.want or launches["K4a"] == 0 or \
                worst > TOL_BF16_EVAL_AUC:
            raise AssertionError(line)
        for k, v in launches.items():
            total[k] += v
        for structure, by_formula in val_q.items():
            formula, qs = max(by_formula.items(), key=lambda kv: len(kv[1]))
            b = make_dense_batch(formula, qs[:1000],
                                 bucket_size(len(qs[:1000])), n_neg=64,
                                 rng=np.random.default_rng(0))
            args = [torch.from_numpy(getattr(b, f)).to(device) for f in (
                "node_entity", "node_mode", "edge_rel", "edge_norm")]
            with torch.no_grad():
                q_k = enc(m16, c16, structure, *args)
                q_x = enc(m16, c16, structure, *args, backend="xla")
            torch.cuda.synchronize()
            e = rel_err(q_k, q_x)
            line = (f"{label}.recheck {structure:14s} B={b.batch_size} "
                    f"dtype={q_k.dtype} err_vs_xla_segments={e:.3e}")
            log(line)
            if q_k.dtype != torch.float32 or e > TOL_ORACLE:
                raise AssertionError(line)
        del m16
    del mmodel
    return total


def bf16_checkpoint(run_dir: str, steps: int, label: str) -> None:
    """Every parameter and Adam moment of the run's checkpoint at
    ``steps`` in bf16."""
    import os

    payload = torch.load(os.path.join(run_dir, "ckpt", f"step_{steps}",
                                      "state.pt"),
                         map_location="cpu", weights_only=True)
    leaves = {f"model.{k}": v for k, v in payload["model"].items()}
    for i, st in payload["optimizer"]["state"].items():
        for k in ("mu", "nu"):
            leaves[f"optimizer.{i}.{k}"] = st[k]
    not_bf16 = sorted(k for k, v in leaves.items()
                      if v.dtype != torch.bfloat16)
    n_params = len(payload["model"])
    log(f"{label}: checkpoint step_{steps}: {n_params} parameters and "
        f"{len(leaves) - n_params} Adam moments, not bf16: {not_bf16}")
    if not_bf16 or len(leaves) != 3 * n_params:
        raise AssertionError(f"{label}: leaves not bf16 {not_bf16}, "
                             f"{len(leaves)} of {3 * n_params}")


def recheck_bf16_step(model, cfg, device, loss_fn, plain_fn, label,
                      plain_ctx=None, tol_grad=TOL_BF16_STEP_GRAD,
                      tol_loss=TOL_BF16_STEP_LOSS, control=None):
    """One random batch of TRAIN_BATCH per structure from the trained
    state through ``loss_fn`` and ``plain_fn`` (the same route on the
    plain versions, forward and backward within ``plain_ctx``, or another
    route of the same function): losses within ``tol_loss``, every
    gradient in the leaves' dtype (bf16, or f32 for an f32 model) and per
    leaf within ``tol_grad`` in mean|diff| / mean|ref| (its worst leaf
    named; the max form printed beside).  ``tol_grad`` may be a function
    of the structure.  ``control(got, want, structure)``, when given,
    returns the kernel's gradients made wrong by a known amount, which
    must fail ``tol_grad`` (the limit's negative control)."""
    import contextlib

    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    gen = torch.Generator(device=device).manual_seed(12)
    params = dict(model.named_parameters())
    for structure in STRUCTURE_NAMES:
        B = TRAIN_BATCH
        t = (*shared_inputs(gen, cfg, structure, B),
             torch.randint(0, cfg.n_entities, (B,), generator=gen,
                           device=device, dtype=torch.int32),
             torch.randint(0, cfg.n_entities, (B, 4), generator=gen,
                           device=device, dtype=torch.int32),
             torch.ones((B, 4), device=device),
             torch.ones((B,), device=device))
        tol = tol_grad(structure) if callable(tol_grad) else tol_grad
        out = []
        for fn, ctx in ((loss_fn, contextlib.nullcontext),
                        (plain_fn, plain_ctx or contextlib.nullcontext)):
            with ctx():
                loss = fn(model, cfg, structure, *t)
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
            out.append((float(loss.detach()), {
                n: (torch.zeros_like(p) if g is None else g)
                for (n, p), g in zip(params.items(), grads)}))
        (lk, gk), (lp, gp) = out
        e_loss = abs(lk - lp) / max(abs(lp), 1e-12)
        f32 = {n: g.float() for n, g in gk.items()}
        want = {n: g.float() for n, g in gp.items()}
        e_mean, e_max = tree_mean_err(f32, want), tree_rel_err(f32, want)
        worst = max((tree_mean_err({n: f32[n]}, {n: w}), n)
                    for n, w in want.items())[1]
        dtypes_ok = all(g.dtype == cfg.dtype for g in gk.values())
        line = (f"{label}.recheck {structure:14s} loss={lk:.6f} "
                f"loss_err={e_loss:.3e} grad_mean_err={e_mean:.3e} "
                f"({worst}; tol {tol:g}) grad_max_err={e_max:.3e} "
                f"grads_{'bf16' if cfg.dtype == torch.bfloat16 else 'f32'}="
                f"{dtypes_ok}")
        if control is not None:
            e_control = tree_mean_err(control(f32, want, structure), want)
            line += f" control={e_control:.3e}"
            if e_control <= tol:
                raise AssertionError(f"{line}: the control passes the "
                                     "limit")
        log(line)
        if (e_loss > tol_loss or e_mean > tol
                or not dtypes_ok or not np.isfinite(lk)):
            raise AssertionError(line)


BF16_SPARSE_RUNS = {
    # label: (the CLI's route flags, steps, module, the loss it calls)
    "train.bf16.fused": (["--kernel", "fused"], BF16_SPARSE_STEPS,
                         "models.mpqe", "dense_batch_loss_kernel_fused"),
    "train.bf16.blocked": (["--kernel", "blocked"], BF16_SPARSE_STEPS,
                           "models.mpqe", "dense_batch_loss_kernel_blocked"),
    "halo.train.bf16": (["--kernel", "dense", "--parallel", "halo_ring",
                         "--mesh", "1,1"],
                        BF16_HALO_STEPS, "parallel.halo_train",
                        "halo_dense_batch_loss"),
}


def phase_train_bf16_sparse(kg_path: str, tmp: str, device, label: str):
    """``train.bf16.fused`` / ``train.bf16.blocked`` /
    ``halo.train.bf16``: the train CLI at ``--dtype bfloat16`` on the
    flagship KG file at the flagship width, in-process, its route's loss
    counted: finite losses, K5 (2 a layer a step) or K6a / K6b (2 and 1)
    launch counts, the checkpoint's parameters and Adam moments bf16, one
    step per structure rechecked (:func:`recheck_bf16_step`: the kernels
    against their plain versions; the halo loss on HALO_PARTS parts of the
    card against ``dense_batch_loss``); step p50 / p95 beside the f32
    runs'.  Returns the K5 / K6 launches by kernel id."""
    import contextlib
    import importlib
    import io
    import os
    import re

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import halo_train as ht
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.serve import config_from_json
    from mpqe_tpu_torch.train import __main__ as train_cli

    flags, steps, mod_name, attr = BF16_SPARSE_RUNS[label]
    module = importlib.import_module(f"mpqe_tpu_torch.{mod_name}")
    loss_impl = getattr(module, attr)
    real = []

    def counted(*a, **kw):
        real.append(a[-1].sum())
        return loss_impl(*a, **kw)

    run_dir = os.path.join(tmp, label.replace(".", "_"))
    argv = ["--data", f"npz:{kg_path}", *DATA_CLI, *flags, "--dtype",
            "bfloat16", "--device", str(device), "--steps", str(steps),
            "--val_every", str(steps), "--run_dir", run_dir]
    counters = sparse_counters()
    for fn in counters.values():
        fn.launches = 0
    setattr(module, attr, counted)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            state = train_cli.main(argv)
    finally:
        setattr(module, attr, loss_impl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    lines = buf.getvalue().strip().splitlines()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    recs = [r for r in records if "loss" in r]
    losses = [r["loss"] for r in recs]
    with open(os.path.join(run_dir, "model_config.json")) as f:
        cfg = config_from_json(json.load(f))
    if cfg.dtype != torch.bfloat16:
        raise AssertionError(f"{label}: the run's model is {cfg.dtype}")
    layers = sum(mpqe_mod.num_steps(cfg, r["structure"]) for r in recs)
    want = {"K5a": 0, "K5b": 0, "K6a": 0, "K6b": 0}
    if "fused" in flags:
        want["K5a"] = 2 * layers
    elif "blocked" in flags:
        want.update(K6a=2 * layers, K6b=layers)
    ms = np.asarray([r["seconds"] * 1e3 for r in recs])
    n_real = int(torch.stack(real).sum()) if real else 0
    ref = " ".join(f"{k}: p50={v[0]:.3f} p95={v[1]:.3f}"
                   for k, v in STEP_MS.items())
    STEP_MS[label] = (np.percentile(ms, 50), np.percentile(ms, 95))
    log(f"{label}: {wall:.2f} s, {len(recs)} steps; launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" (expected {' '.join(f'{k}={v}' for k, v in want.items())}); "
        f"loss first={losses[0]:.6f} last={losses[-1]:.6f}; step_ms_p50="
        f"{np.percentile(ms, 50):.3f} step_ms_p95={np.percentile(ms, 95):.3f}"
        f" train_queries_per_s={n_real / ms.sum() * 1e3:.1f} ({n_real} real "
        f"rows of {len(ms) * TRAIN_BATCH}) on "
        f"{torch.cuda.get_device_name(device)}; float32 runs (ms) {ref}; "
        f"{lines[-1]}")
    if not re.fullmatch(rf"final step={steps} macro_auc=\S+ macro_apr=\S+",
                        lines[-1]):
        raise AssertionError(f"{label}: final line {lines[-1]!r}")
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            len(real) != steps:
        raise AssertionError(f"{label}: {len(losses)} steps, finite: "
                             f"{all(np.isfinite(losses))}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    bf16_checkpoint(run_dir, steps, label)
    model = state.model
    if "halo_ring" in flags:
        mesh = make_mesh((HALO_PARTS, 1), devices=[device] * HALO_PARTS)
        recheck_bf16_step(
            model, cfg, device,
            ht.halo_batch_loss_fn(mesh, layer_kind="ring"),
            mpqe_mod.dense_batch_loss, label, tol_grad=TOL_BF16_HALO_GRAD)
    else:
        recheck_bf16_step(model, cfg, device, loss_impl, loss_impl, label,
                          plain_sparse_kernels)
    del state, model
    return launches


# ----------------------------------------------------------------------
# The training host path (the C++ binding, the pipeline, K steps a call,
# shared negatives) and the HTTP front end
# ----------------------------------------------------------------------
HTTP_CLIENTS = 8
HTTP_REQUESTS = 16  # per client, one after another
HTTP_QUERIES = 32  # per request, drawn across every structure
HTTP_WAIT_MS = 5.0  # the batcher's max_wait_ms (the CLI's default)
HTTP_TIMEOUT_S = 60
NATIVE_PACKS = 50  # batches of TRAIN_BATCH timed per packer
MULTISTEP_K = 8
MULTISTEP_STEPS = 16  # each train.multistep run: 2 calls of K = 8
MULTISTEP_TOL = 1e-4  # K steps a call vs one: index_add_ atomics only
# each timed window of run_train: HOST_WARM_CALLS calls (the pipeline's
# start, its first batch), then HOST_WINDOW_STEPS steps on the host clock,
# then HOST_PROFILE_STEPS under the profiler, then the pipeline's stop
# (device activity only: with the host's too, 64 profiled steps cost
# ~10 s more a window on the H100)
HOST_WARM_CALLS = 2
HOST_WINDOW_STEPS = 64
HOST_PROFILE_STEPS = 16
# (prefetch, steps_per_call) of the timed windows: each lever alone, both
HOST_WINDOWS = ((0, 1), (0, MULTISTEP_K), (2, 1), (2, MULTISTEP_K))
HOST_PIPE_BATCHES = 16  # batches the pipeline alone is timed over
SHARED_NEGS = 512
SHARED_STEPS = 20


def write_ntriples(kg, path: str) -> None:
    """``kg`` as gzipped N-Triples: one ``rdf:type`` statement per entity
    (its mode) and one statement per triple."""
    import gzip

    from mpqe_tpu_torch.data.rdf import RDF_TYPE

    with gzip.open(path, "wt", compresslevel=1) as f:
        f.writelines(f"<http://s/e{e}> <{RDF_TYPE}> <http://s/M{m}> .\n"
                     for e, m in enumerate(kg.entity_mode.tolist()))
        f.writelines(f"<http://s/e{h}> <http://s/r{r}> <http://s/e{t}> .\n"
                     for h, r, t in zip(kg.heads.tolist(), kg.rels.tolist(),
                                        kg.tails.tolist()))


def phase_native(tmp: str) -> None:
    """``native``: the C++ host library built from ``cpp/mpqe_host.cpp``
    (the phase fails if it is unavailable); ``load_ntriples_kg(
    native=True)`` equal to the Python parse, array for array, on the
    rule KG written as N-Triples; the raw-edge batches of the C++ packer
    checked as the numpy packer's are; both packers' host ms a batch."""
    import os

    from mpqe_tpu_torch.data import native, rdf
    from mpqe_tpu_torch.data.sampler import make_rule_kg
    from mpqe_tpu_torch.data.store import pack_dense_batch_np, \
        stores_from_edges

    t0 = time.perf_counter()
    ok = native.ensure_built()
    log(f"native: ensure_built {time.perf_counter() - t0:.2f} s: "
        f"available={ok} {native.library_path().name} "
        f"error={native.BUILD_ERROR}")
    if not ok:
        raise AssertionError(f"native: the C++ host library is unavailable: "
                             f"{native.BUILD_ERROR}")
    rule = make_rule_kg(**RULE_KG)
    path = os.path.join(tmp, "rule.nt.gz")
    t0 = time.perf_counter()
    write_ntriples(rule, path)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = rdf.load_ntriples_kg(path, native=True)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = rdf.load_ntriples_kg(path, native=False)
    t_python = time.perf_counter() - t0
    fields = ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
              "tails")
    equal = all(np.array_equal(getattr(got, f), getattr(want, f))
                for f in fields) and got.rel_names == want.rel_names \
        and got.mode_names == want.mode_names
    log(f"native: N-Triples of {rule.n_entities} entities and "
        f"{rule.n_triples} triples ({os.path.getsize(path) / 2**20:.1f} MiB "
        f"gzipped, written in {t_write:.2f} s): load_ntriples_kg "
        f"native=True {t_native:.2f} s, native=False {t_python:.2f} s; "
        f"arrays equal {equal} ({got.n_entities} entities, {got.n_triples} "
        "triples)")
    if not equal or got.n_triples != rule.n_triples:
        raise AssertionError("native: the C++ parse differs from the "
                             "Python parse")
    stores = stores_from_edges(got)["1-chain"]
    check_raw_edge_batches(stores, got, native.pack_dense_batch_native,
                           "native")
    store = max(stores, key=lambda s: s.n_queries)
    rng = np.random.default_rng(1)
    picks = [rng.integers(0, store.n_queries, TRAIN_BATCH).astype(np.int64)
             for _ in range(NATIVE_PACKS)]
    ms = {}
    for name, pack in (("cpp", native.pack_dense_batch_native),
                       ("numpy", pack_dense_batch_np)):
        t0 = time.perf_counter()
        for i, pick in enumerate(picks):
            pack(store, pick, TRAIN_BATCH, DATA_NEG, i)
        ms[name] = (time.perf_counter() - t0) * 1e3 / NATIVE_PACKS
    log(f"native: host ms a raw-edge batch of {TRAIN_BATCH} x {DATA_NEG} "
        f"negatives (mean of {NATIVE_PACKS}): C++ {ms['cpp']:.3f}, numpy "
        f"{ms['numpy']:.3f} ({ms['numpy'] / ms['cpp']:.1f}x)")


def http_requests(kg, seed: int = 321) -> list:
    """HTTP_CLIENTS x HTTP_REQUESTS requests of HTTP_QUERIES queries drawn
    across every structure (as ``sample_stream``'s mixed requests)."""
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    sampler = QuerySampler(kg, seed=seed)
    union = [q for s in STRUCTURE_NAMES
             for q in sampler.sample_queries(s, 64, n_neg=1)]
    rng = np.random.default_rng(seed)
    return [[union[int(i)] for i in rng.integers(0, len(union),
                                                 HTTP_QUERIES)]
            for _ in range(HTTP_CLIENTS * HTTP_REQUESTS)]


def same_up_to_ties(ids, scores, ref_ids, ref_scores, tol: float) -> tuple:
    """(equal, swapped): ``ids`` / ``scores`` (k) against a reference
    top-(k+1): scores within ``tol`` place by place, and every id that
    differs sits where the reference's score ties (within ``tol``) with
    its neighbour's, the (k+1)-th included; ``swapped`` counts them."""
    k = len(ids)
    fin = np.isfinite(ref_scores[:k])
    if not (np.array_equal(fin, np.isfinite(scores))
            and (np.abs(scores[fin] - ref_scores[:k][fin]) <= tol).all()):
        return False, 0
    swapped = 0
    for j in np.flatnonzero(ids != ref_ids[:k]):
        tie = any(abs(ref_scores[j] - ref_scores[i]) <= tol
                  for i in (j - 1, j + 1) if 0 <= i <= k)
        if not tie:
            return False, swapped
        swapped += 1
    return True, swapped


def phase_serve_http(model, cfg, kg, device) -> int:
    """``serve.http``: the port's HTTP front end (``netserve``) on
    127.0.0.1:0 over the serve phase's model; HTTP_CLIENTS client
    threads each send HTTP_REQUESTS requests of HTTP_QUERIES mixed
    queries.  Every answer equals ``QueryServer.answer`` of the same
    request up to ties; ``/statz`` shows more than one request's queries
    per dispatch; K3 launches one per layer per eligible structure group
    of each dispatch the batcher made; a bad body gets 400 and the
    server stays up.  Returns K3's launches under the traffic."""
    import threading
    import urllib.error
    import urllib.request

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.netserve import make_http_server
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.serve import QueryServer

    server = QueryServer(model, cfg, kg.entity_mode, device=device)
    server.warmup(STRUCTURE_NAMES, batch=HTTP_CLIENTS * HTTP_QUERIES, k=K)
    reqs = http_requests(kg)
    answer = server.answer
    dispatched = []  # per batcher dispatch, its structures
    dispatch_ms = []

    def recorded(queries, k=10):
        dispatched.append([q.formula.structure for q in queries])
        t0 = time.perf_counter()
        out = answer(queries, k=k)
        dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    server.answer = recorded
    httpd = make_http_server(server, kg, "127.0.0.1", 0, default_k=K,
                             max_wait_ms=HTTP_WAIT_MS)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    loop = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()

    def post(body):
        req = urllib.request.Request(
            url + "/v1/answer", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(path):
        with urllib.request.urlopen(url + path,
                                    timeout=HTTP_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())

    got = [None] * len(reqs)
    lat = [0.0] * len(reqs)

    def client(c):
        for i in range(c * HTTP_REQUESTS, (c + 1) * HTTP_REQUESTS):
            body = {"queries": [{"structure": q.formula.structure,
                                 "anchors": list(q.anchors),
                                 "rels": list(q.formula.rels)}
                                for q in reqs[i]], "k": K}
            t0 = time.perf_counter()
            got[i] = post(body)
            lat[i] = (time.perf_counter() - t0) * 1e3

    try:
        tgt_counters(reset=True)
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(HTTP_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=HTTP_CLIENTS * HTTP_REQUESTS * HTTP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        launches = tgt_counters()[2]
        _, statz = get("/statz")
        bad = post({"queries": [{"structure": "nope", "anchors": [0],
                                 "rels": [0]}]})
        health = get("/healthz")[0]
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.stop()
        loop.join(timeout=HTTP_TIMEOUT_S)
        server.answer = answer
    expected = 0
    for structures in dispatched:
        for s in STRUCTURE_NAMES:
            n = structures.count(s)
            if n and mpqe_mod.multi_kernel_eligible(cfg, s):
                expected += -(-n // server.max_batch) * \
                    mpqe_mod.num_steps(cfg, s)
    status = [g[0] if g else None for g in got]
    ms = np.asarray(lat)
    n_q = len(reqs) * HTTP_QUERIES
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    log(f"serve.http: {len(reqs)} requests of {HTTP_QUERIES} mixed queries "
        f"from {HTTP_CLIENTS} clients on {name}: request latency_ms_p50="
        f"{np.percentile(ms, 50):.3f} latency_ms_p95="
        f"{np.percentile(ms, 95):.3f} queries_per_s={n_q / wall:.1f} "
        f"(wall {wall:.3f} s); statz total_dispatches="
        f"{statz['total_dispatches']} total_queries={statz['total_queries']}"
        f" mean_queries_per_dispatch="
        f"{statz['mean_queries_per_dispatch']:.2f} recent_dispatch_sizes="
        f"{statz['recent_dispatch_sizes'][-8:]}; QueryServer.answer a "
        f"dispatch: p50 {np.percentile(dispatch_ms, 50):.3f} ms, p95 "
        f"{np.percentile(dispatch_ms, 95):.3f} ms, sum "
        f"{sum(dispatch_ms):.1f} ms (the clients share the server's "
        "process)")
    log(f"serve.http: K3 launches {launches}, expected {expected} (one per "
        f"layer of each eligible structure group of {len(dispatched)} "
        f"dispatches); bad body -> {bad[0]} {bad[1]}; /healthz after -> "
        f"{health}")
    if set(status) != {200} or statz["total_queries"] != n_q:
        raise AssertionError(f"serve.http: statuses {set(status)}, statz "
                             f"{statz}")
    if statz["mean_queries_per_dispatch"] <= HTTP_QUERIES:
        raise AssertionError("serve.http: no dispatch coalesced requests")
    if launches == 0 or launches != expected:
        raise AssertionError(f"serve.http: K3 launches {launches} != "
                             f"{expected}")
    if bad[0] != 400 or "unknown structure" not in bad[1]["error"] or \
            health != 200:
        raise AssertionError(f"serve.http: bad body {bad}, then {health}")
    swapped = 0
    for req, (_, body) in zip(reqs, got):
        ref = answer(req, k=K + 1)
        for q, a, r in zip(req, body["answers"], ref):
            ok, n = same_up_to_ties(np.asarray(a["entities"]),
                                    np.asarray(a["scores"], np.float32),
                                    r.entity_ids, r.scores, TOL_SCORE)
            swapped += n
            mode = kg.entity_mode[np.asarray(a["entities"])]
            if not ok or (mode != q.formula.target_mode).any():
                raise AssertionError(
                    f"serve.http: {q.formula.structure} answer "
                    f"{a} != QueryServer's {r.entity_ids.tolist()} "
                    f"{r.scores.tolist()}")
    log(f"serve.http.recheck: {n_q} answers equal QueryServer.answer of "
        f"the same requests (scores within {TOL_SCORE:g}; {swapped} ids "
        "swapped within ties)")
    return launches


class plain_tgt_kernels:
    """Within the block, K1 and K2 under ``FusedChain`` are their plain
    versions, on the card (the shared-negatives recheck); K1's bf16
    store is its f32 output rounded, as the kernel's is."""

    def __enter__(self):
        from mpqe_tpu_torch.ops import fused_fwd as ff

        self.saved = (ff._chain_forward, ff._chain_backward)
        ff._chain_forward = lambda x0, ws, bs, d, blocks, \
            out_dtype=torch.float32: ff._chain_forward_plain(
                x0, ws, bs, d).to(out_dtype)
        ff._chain_backward = lambda x0, ws, bs, g, n_a, d, d_pad, blocks: \
            ff._chain_backward_plain(x0, ws, bs, g, n_a, d, d_pad)
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import fused_fwd as ff

        ff._chain_forward, ff._chain_backward = self.saved
        return False


def host_window(state, cfg, tc, stores, loss_fn, prefetch: int,
                k: int) -> dict:
    """One ``run_train`` at ``prefetch`` and ``steps_per_call`` ``k`` over
    HOST_WARM_CALLS calls, then HOST_WINDOW_STEPS steps timed on the host
    clock call by call (from one call's record to the next: the batch's
    draw or wait, the step and the loss's read), then HOST_PROFILE_STEPS
    steps under the profiler (its wall from the profiler's start to the
    last record), all in one phase with no convergence stop; the
    pipeline's start and stop fall outside both spans.  Returns the step
    ms over calls (``p50``, ``p95``, ``mean``), ``calls``, the profiled
    span's ``wall_ms`` / ``busy_ms`` a step and ``idle``, the window's
    seconds in all (``seconds``) and those of the profiler's start, stop
    and summary (``profile_s``)."""
    from torch.profiler import ProfilerActivity, profile

    from mpqe_tpu_torch.train import loop as loop_mod

    timed = HOST_WINDOW_STEPS // k
    profiled = HOST_PROFILE_STEPS // k
    stamps = []
    prof = profile(activities=[ProfilerActivity.CUDA])
    span = {"profile_s": 0.0}

    def log_fn(rec):
        if "loss" not in rec:
            return
        stamps.append(time.perf_counter())
        if len(stamps) == HOST_WARM_CALLS + timed:
            prof.start()
            span["t0"] = time.perf_counter()
            span["profile_s"] += span["t0"] - stamps[-1]
        elif len(stamps) == HOST_WARM_CALLS + timed + profiled:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            span["wall_s"] = t1 - span["t0"]
            prof.stop()
            span["profile_s"] += time.perf_counter() - t1

    # one phase (no burn-in: its switch restarts the pipeline) and no
    # convergence stop (the window's deque never fills)
    steps = (HOST_WARM_CALLS + timed + profiled) * k
    t_window = time.perf_counter()
    loop_mod.run_train(
        state, cfg, dataclasses.replace(
            tc, max_steps=steps, burn_in_structure="", conv_window=1 << 30),
        None, log_fn=log_fn, train_stores=stores, batch_loss_fn=loss_fn,
        prefetch=prefetch, steps_per_call=k)
    if "wall_s" not in span:
        raise AssertionError(f"host window: {len(stamps)} calls of {k}, "
                             f"not {HOST_WARM_CALLS + timed + profiled}")
    per_step = np.diff(stamps[HOST_WARM_CALLS - 1:HOST_WARM_CALLS + timed]
                       ) * 1e3 / k
    t1 = time.perf_counter()
    busy_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    span["profile_s"] += time.perf_counter() - t1
    if busy_us <= 0:
        raise AssertionError("host window: the profiler recorded no device "
                             "time")
    wall_ms = span["wall_s"] * 1e3
    return {"p50": float(np.percentile(per_step, 50)),
            "p95": float(np.percentile(per_step, 95)),
            "mean": float(per_step.mean()), "calls": len(per_step),
            "wall_ms": wall_ms / (profiled * k),
            "busy_ms": busy_us / 1e3 / (profiled * k),
            "idle": 1 - busy_us / 1e3 / wall_ms,
            "seconds": time.perf_counter() - t_window,
            "profile_s": span["profile_s"]}


def phase_train_multistep(kg_path: str, tmp: str, device) -> tuple:
    """``train.multistep``: the train CLI in-process on the flagship KG
    file at ``--kernel fused_fwd --fused_backward pallas --steps_per_call
    8 --prefetch 2`` and at ``--steps_per_call 1 --prefetch 0``
    (:func:`train_cli_run`: launches, finite losses, the C++ packer).
    The first call's 8 losses are held to 8 single steps (K1/K2, one a
    call) from the same seeded weights on the same 8 batches within
    MULTISTEP_TOL.  Then ``run_train`` at each of HOST_WINDOWS (each lever
    alone and both; :func:`host_window`): step ms p50 / p95 over calls on
    the host clock, then the device's idle share under the profiler; and
    the pipeline alone: its first batch, its rate with no consumer, its
    stop.  Returns the CLI runs' (K1, K2, K3)."""
    import os

    from mpqe_tpu_torch.data.pipeline import BatchPipeline
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import __main__ as train_cli
    from mpqe_tpu_torch.train import loop as loop_mod

    base = ["--data", f"npz:{kg_path}", *DATA_CLI, "--device", str(device),
            "--steps", str(MULTISTEP_STEPS), "--val_every",
            str(MULTISTEP_STEPS)]
    first = []
    run_stacked = loop_mod.run_multistep_stacked

    def captured(step, state, batch, *put):
        losses = run_stacked(step, state, batch, *put)
        if not first:
            first.append((dataclasses.replace(batch, **{
                f: torch.as_tensor(getattr(batch, f)).cpu()
                for f in loop_mod.BATCH_FIELDS}),
                losses))
        return losses

    loop_mod.run_multistep_stacked = captured
    try:
        _, n_multi = train_cli_run(
            base + ["--steps_per_call", str(MULTISTEP_K), "--prefetch", "2",
                    "--run_dir", os.path.join(tmp, "multistep_run")],
            "train.multistep")
    finally:
        loop_mod.run_multistep_stacked = run_stacked
    _, n_single = train_cli_run(
        base + ["--steps_per_call", "1", "--prefetch", "0", "--run_dir",
                os.path.join(tmp, "singlestep_run")],
        "train.multistep.single")

    args = train_cli.parse_args(base)
    kg, train_q, _ = train_cli.load_data(args)
    cfg = mpqe_mod.MPQEConfig(
        n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
        embed_dim=args.embed_dim, n_layers=args.n_layers,
        num_bases=args.num_bases, readout=args.readout)

    def loss_fn(*a):
        return mpqe_mod.dense_batch_loss_kernel_fused_fwd(*a,
                                                          backward="pallas")

    def fresh(tc):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return loop_mod.init_train_state(gen, cfg, tc, device=device)

    stacked, k_losses = first[0]
    tc = loop_mod.TrainConfig(lr=args.lr, batch_size=args.batch_size,
                              n_neg=args.n_neg, seed=args.seed,
                              max_steps=MULTISTEP_K,
                              val_every=1 << 30)
    state = fresh(tc)
    step = loop_mod.make_train_step(cfg, state.optimizer, loss_fn)
    single = [loop_mod.run_step(step, state, dataclasses.replace(
        stacked, **{f: getattr(stacked, f)[i]
                    for f in loop_mod.BATCH_FIELDS}))
        for i in range(MULTISTEP_K)]
    err = max(abs(a - b) / abs(b) for a, b in zip(k_losses, single))
    log(f"train.multistep.recheck: the first call's {MULTISTEP_K} losses "
        f"against {MULTISTEP_K} single steps on the same batches from the "
        f"same weights: max relative diff {err:.3e} (tol "
        f"{MULTISTEP_TOL:g}); first {k_losses[0]:.6f} / {single[0]:.6f}, "
        f"last {k_losses[-1]:.6f} / {single[-1]:.6f}")
    if err > MULTISTEP_TOL:
        raise AssertionError(f"train.multistep: {k_losses} vs {single}")

    stores = build_stores(train_q, kg=kg)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    windows = {}
    for prefetch, k in HOST_WINDOWS:
        w = windows[prefetch, k] = host_window(fresh(tc), cfg, tc, stores,
                                                loss_fn, prefetch, k)
        log(f"train.multistep.window --prefetch {prefetch} --steps_per_call "
            f"{k}: on {name}: step_ms_p50={w['p50']:.3f} step_ms_p95="
            f"{w['p95']:.3f} mean={w['mean']:.3f} over {w['calls']} calls "
            f"({HOST_WINDOW_STEPS} steps after {HOST_WARM_CALLS} warm calls;"
            f" host clock, record to record, pipeline start and stop "
            f"outside); profiled {HOST_PROFILE_STEPS} steps: "
            f"{w['wall_ms']:.3f} ms a step, device busy {w['busy_ms']:.3f}, "
            f"idle share {w['idle']:.3f}; window {w['seconds']:.2f} s, of "
            f"which the profiler's start, stop and summary "
            f"{w['profile_s']:.2f} s")
    for k in (1, MULTISTEP_K):
        t0 = time.perf_counter()
        pipe = BatchPipeline(stores, args.batch_size, args.n_neg,
                             seed=args.seed, device=device,
                             steps_per_call=k).start()
        next(pipe)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(HOST_PIPE_BATCHES):
            next(pipe)
        t_each = (time.perf_counter() - t0) / HOST_PIPE_BATCHES
        t0 = time.perf_counter()
        pipe.stop()
        log(f"train.multistep.pipeline steps_per_call={k}: start to first "
            f"batch {t_first * 1e3:.3f} ms, then {t_each * 1e3:.3f} ms a "
            f"batch with no consumer ({t_each * 1e3 / k:.3f} a step), stop "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    plain, both = windows[0, 1], windows[2, MULTISTEP_K]
    log(f"train.multistep: on {name}: --prefetch 2 --steps_per_call "
        f"{MULTISTEP_K} step_ms_p50={both['p50']:.3f} step_ms_p95="
        f"{both['p95']:.3f} idle share {both['idle']:.3f} against --prefetch "
        f"0 --steps_per_call 1 step_ms_p50={plain['p50']:.3f} step_ms_p95="
        f"{plain['p95']:.3f} idle share {plain['idle']:.3f} (the windows "
        "above)")
    return tuple(a + b for a, b in zip(n_multi, n_single))


# The f32 shared-negatives recheck's gradient limit by depth: the worst
# leaf's mean|diff| / mean|ref| of K1/K2 against plain K1/K2 on this
# phase's batches read 1.07e-5 at one layer, 1.05e-4 at two and 7.5e-5 at
# three on the H100 (the same in four runs: the trained state and the
# batches are seeded), and the limits are 2.4x to 4.7x those.  A K2 whose
# parameter gradients had bf16's error (2.7e-4 / 5.7e-4 / 6.8e-4, the
# worst of ``tools/tgt_probe.py emulate``: ``ops/fused_fwd.py``) fails
# them, and so does SHARED_F32_CONTROL, one basis's gradient moved by it.
SHARED_F32_GRAD_TOL = {1: 5e-5, 2: 2.5e-4, 3: 2.5e-4}
SHARED_F32_CONTROL = {1: 2.7e-4, 2: 5.7e-4, 3: 6.8e-4}


def shared_grad_tol(cfg, structure: str) -> float:
    """The f32 shared-negatives recheck's gradient limit at the
    structure's depth (SHARED_F32_GRAD_TOL)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    return SHARED_F32_GRAD_TOL[mpqe_mod.num_steps(cfg, structure)]


def shared_grad_control(cfg, got: dict, want: dict, structure: str) -> dict:
    """``got`` with layer 0's basis 0 gradient scaled by ``1 + s``, ``s``
    chosen so that the leaf's mean|diff| / mean|ref| grows by
    SHARED_F32_CONTROL at the structure's depth: a wrong gradient of one
    basis at bf16's error, which :func:`shared_grad_tol` must refuse."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    out = dict(got)
    g = got["layers.0.basis"].clone()
    amount = SHARED_F32_CONTROL[mpqe_mod.num_steps(cfg, structure)]
    g[0] = g[0] * (1.0 + amount * float(want["layers.0.basis"].abs().sum()
                                        / g[0].abs().sum()))
    out["layers.0.basis"] = g
    return out


HALO_MULTISTEP = ["--parallel", "halo_ring", "--mesh", "1,1",
                  "--steps_per_call", "4", "--steps", "8", "--val_every", "8"]


def phase_halo_multistep(device) -> None:
    """``halo.train.multistep``: the train CLI in-process at ``--parallel
    halo_ring --steps_per_call 4`` (one part on the card) on the synthetic
    KG of ``phase_train_cli``'s runs: the final line, two calls of 4 steps
    with finite losses, a checkpoint at the end."""
    import os
    import re
    import tempfile

    from mpqe_tpu_torch.train import __main__ as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        lines = run_cli(train_cli.main, [
            "--data", "synthetic", *HALO_MULTISTEP, "--num_bases", "16",
            "--n_neg", "4", "--syn_entities", "20000", "--syn_modes", "4",
            "--syn_rels", "20", "--syn_triples", "60000",
            "--syn_train_queries", "700", "--syn_val_queries", "140",
            "--device", str(device), "--run_dir", run_dir],
            "halo.train.multistep")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            steps = [r for r in map(json.loads, f) if "loss" in r]
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    log(f"halo.train.multistep {' '.join(HALO_MULTISTEP)}: {lines[-1]}; "
        f"calls {[(r['step'], r['k']) for r in steps]}, losses "
        f"{[round(r['loss'], 6) for r in steps]}; ckpt/{','.join(ckpts)}")
    if not re.fullmatch(r"final step=8 macro_auc=\S+ macro_apr=\S+",
                        lines[-1]) or [r["k"] for r in steps] != [4, 4] \
            or not np.isfinite([r["loss"] for r in steps]).all() \
            or "step_8" not in ckpts:
        raise AssertionError(f"halo.train.multistep: {lines[-1]} {steps} "
                             f"{ckpts}")


def phase_train_shared_negs(kg_path: str, tmp: str, device) -> tuple:
    """``train.shared_negs``: the train CLI in-process on the flagship KG
    file with ``--shared_negatives 512 --kernel fused_fwd
    --fused_backward pallas``, float32 and ``--dtype bfloat16``
    (:func:`train_cli_run`, each call of ``dense_batch_loss_shared_negs``
    a step); then one step per structure from the trained state through
    K1/K2 and through their plain versions (:class:`plain_tgt_kernels`):
    f32 with the loss at ``train.recheck``'s TOL_PLAIN and the gradients
    at SHARED_F32_GRAD_TOL (:func:`shared_grad_tol`; its control,
    :func:`shared_grad_control`, failing it), bf16 at
    ``recheck_bf16_step``'s tolerances.  Returns the runs' (K1, K2,
    K3)."""
    import os

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.serve import config_from_json

    total = (0, 0, 0)
    for dtype in ("float32", "bfloat16"):
        label = f"train.shared_negs.{dtype}"
        _, n = train_cli_run(
            ["--data", f"npz:{kg_path}", *DATA_CLI, "--device", str(device),
             "--dtype", dtype, "--shared_negatives", str(SHARED_NEGS),
             "--steps", str(SHARED_STEPS), "--val_every", str(SHARED_STEPS),
             "--run_dir", os.path.join(tmp, f"shared_{dtype}")], label,
            counted_loss="dense_batch_loss_shared_negs")
        total = tuple(a + b for a, b in zip(total, n))
        state = CLI_RESULT[label]
        with open(os.path.join(tmp, f"shared_{dtype}",
                               "model_config.json")) as f:
            cfg = config_from_json(json.load(f))
        loss_fn = mpqe_mod.make_shared_negs_batch_loss(
            SHARED_NEGS, encoder="fused_fwd", fused_backward="pallas")
        f32 = dtype == "float32"
        recheck_bf16_step(state.model, cfg, device, loss_fn, loss_fn, label,
                          plain_ctx=plain_tgt_kernels,
                          tol_grad=(functools.partial(shared_grad_tol, cfg)
                                    if f32 else TOL_BF16_STEP_GRAD),
                          tol_loss=TOL_PLAIN if f32 else TOL_BF16_STEP_LOSS,
                          control=(functools.partial(shared_grad_control, cfg)
                                   if f32 else None))
    return total


BENCH_ROUTES = ("dense", "fused", "blocked", "fused_fwd")


def check_bench_record(rec: dict, batch: int = TRAIN_BIG) -> list:
    """What is wrong with the bench's JSON line (empty: nothing): the
    reference's top-level keys, a finite positive ``value`` and
    ``vs_baseline``, a K1 route as ``fwd_impl``, ``batch x 4`` executed
    edge messages (``3-chain_inter``), a roofline fraction in (0, 1.05],
    no broken timing, K1's device ms an iteration and the loop's busy
    share in (0, 1] from the profile, the best stack's and the shared-
    negatives variant's step times finite and positive, the four config
    rows and the four kernel-path rows each with finite positive times
    and no ``error``."""
    bad = []

    def pos(name, v):
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            bad.append(f"{name}={v!r} is not finite and positive")

    for k in ("metric", "value", "unit", "vs_baseline", "extra"):
        if k not in rec:
            bad.append(f"no {k!r}")
    if bad:
        return bad
    pos("value", rec["value"])
    pos("vs_baseline", rec["vs_baseline"])
    ex = rec["extra"]
    if ex.get("fwd_impl") not in ("cuda_k1", "cuda_k1_obf16"):
        bad.append(f"fwd_impl={ex.get('fwd_impl')!r} is not a K1 route")
    if ex.get("edge_msgs_per_fwd") != batch * 4:
        bad.append(f"edge_msgs_per_fwd={ex.get('edge_msgs_per_fwd')} != "
                   f"{batch * 4}")
    rf = ex.get("roofline_fraction")
    if not (isinstance(rf, float) and 0 < rf <= 1.05):
        bad.append(f"roofline_fraction={rf!r} not in (0, 1.05]")
    if "broken_timings" in ex:
        bad.append(f"broken_timings={ex['broken_timings']}")
    for k in ("fwd_seconds", "fwd_seconds_xla", "fwd_seconds_k1",
              "fwd_seconds_k1_obf16", "fwd_seconds_k1_fold_bias",
              "train_step_seconds", "fwd_k1_kernel_ms"):
        pos(k, ex.get(k))
    busy = ex.get("fwd_device_busy_share")
    if not (isinstance(busy, float) and 0 < busy <= 1):
        bad.append(f"fwd_device_busy_share={busy!r} not in (0, 1]")
    configs = ex.get("configs")
    if not isinstance(configs, list) or len(configs) != 4:
        bad.append(f"configs: {configs!r}")
    else:
        for row in configs:
            pos(f"configs {row.get('name')} fwd_ms", row.get("fwd_ms"))
            pos(f"configs {row.get('name')} train_step_ms",
                row.get("train_step_ms"))
    for key in ("best_stack", "shared_neg_variant"):
        row = ex.get(key)
        if not isinstance(row, dict):
            bad.append(f"{key}={row!r} is not a record")
            continue
        for k in ("train_step_ms", "train_queries_per_s"):
            pos(f"{key} {k}", row.get(k))
    paths = ex.get("kernel_paths")
    if not isinstance(paths, list) or tuple(
            r.get("kernel") for r in paths) != BENCH_ROUTES:
        bad.append(f"kernel_paths: {paths!r}")
    else:
        for row in paths:
            if "error" in row:
                bad.append(f"kernel_paths {row['kernel']}: {row['error']}")
            else:
                pos(f"kernel_paths {row['kernel']} train_step_ms",
                    row.get("train_step_ms"))
    return bad


# the bench's loops cut in depth for this check (the shapes, batches and
# rows are the bench's own)
BENCH_DEPTH = dict(N_LARGE=8, N_LARGE_FWD=25, MATRIX_SMALL_ITERS=(10, 60),
                   BEST_STACK_ITERS=(2, 6))


def phase_bench() -> float:
    """``mpqe_tpu_torch.bench``'s ``main`` in-process with its config
    matrix and kernel-path rows and their profiles (``MPQE_BENCH_MATRIX=1
    MPQE_BENCH_KERNELS=1``) at its full shapes, its loops cut to
    BENCH_DEPTH: its stderr (each row's time and peak memory) and its JSON
    line printed, the line held to :func:`check_bench_record`.  Returns
    the phase's wall seconds."""
    import contextlib
    import io
    import os

    from mpqe_tpu_torch import bench

    saved = {k: getattr(bench, k) for k in BENCH_DEPTH}
    env = {k: os.environ.get(k) for k in ("MPQE_BENCH_MATRIX",
                                          "MPQE_BENCH_KERNELS")}
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        for k, v in BENCH_DEPTH.items():
            setattr(bench, k, v)
        os.environ.update(MPQE_BENCH_MATRIX="1", MPQE_BENCH_KERNELS="1")
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main([])
    finally:
        for k, v in saved.items():
            setattr(bench, k, v)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    for ln in err.getvalue().splitlines():
        log(f"bench.log: {ln}")
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"bench: rc={rc}, {len(lines)} stdout lines")
    log(f"bench: {lines[-1]}")
    bad = check_bench_record(json.loads(lines[-1]))
    if bad:
        log(f"bench: FAIL {bad}")
        raise AssertionError(f"bench: {bad}")
    log(f"bench: line ok, {wall:.1f} s (loops {BENCH_DEPTH})")
    return wall


# ----------------------------------------------------------------------
# The sharded entity table (parts of the one card): ShardedQueryServer,
# full_ranking_sharded, the spmd step and its CLI, two processes under
# gloo, and the multi-part dry run
# ----------------------------------------------------------------------
SHARD_PARTS = 4  # the model axis of serve.sharded and eval.sharded
SPMD_STEPS = 3
SPMD_STRUCTURES = ("1-chain", "2-inter", "3-chain_inter")
# spmd vs single-device step, two processes vs one: each parameter's
# change over the run, mean-normalized per leaf (the gathers' gradients
# sum with atomics); the optimizer is SGD at this rate, so the changes
# are the gradients' sums (a gradient reduced twice gives an error of 1)
SPMD_TOL = 1e-4
SPMD_LR = 1.0
MULTIHOST_TOL = 1e-5  # two processes vs one, losses (relative)
DRYRUN_PARTS = 8
SMI = {}  # the card's name and power limit (nvidia-smi), set in main


def shard_mesh(device, shape=(1, SHARD_PARTS)):
    from mpqe_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, devices=[device] * (shape[0] * shape[1]))


def phase_serve_sharded(model, cfg, kg, device) -> int:
    """``serve.sharded``: ``ShardedQueryServer`` over SHARD_PARTS parts of
    the card at float32, bfloat16 and int8 on ``sample_stream``'s
    requests, each answer held to the unsharded ``QueryServer``'s of the
    same table dtype (``check_answers``, then ids equal up to ties and
    scores within TOL_SCORE: the ``-1`` tail of a scarce mode is the
    reference's own difference and cannot arise at 250,000 entities a
    mode), K3's launches equal to the unsharded server's on the same
    requests, and one dispatch per structure encoded both ways: K3 from
    the compact anchor table bit-equal to K3 from the model's table.
    Returns the sharded runs' K3 launches."""
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.serve import QueryServer, ShardedQueryServer

    mesh = shard_mesh(device)
    single, mixed = sample_stream(kg)
    reqs = single + mixed
    firsts = {}
    for req in single:
        firsts.setdefault(req[0].formula.structure, req)
    launches = 0
    for dtype in ("float32", "bfloat16", "int8"):
        t0 = time.perf_counter()
        dense = QueryServer(model, cfg, kg.entity_mode, device=device,
                            table_dtype=dtype)
        ff.fused_tgt_forward_multi.launches = 0
        want = [dense.answer(r, k=K + 1) for r in reqs]
        k3_dense = ff.fused_tgt_forward_multi.launches
        sharded = ShardedQueryServer(model, cfg, kg.entity_mode, mesh,
                                     table_dtype=dtype)
        sharded.warmup(STRUCTURE_NAMES, batch=BATCH, k=K)
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ff.fused_tgt_forward_multi.launches = 0
        lat, got = [], []
        for r in reqs:
            t0 = time.perf_counter()
            got.append(sharded.answer(r, k=K))
            lat.append((time.perf_counter() - t0) * 1e3)
        k3 = ff.fused_tgt_forward_multi.launches
        peak = torch.cuda.max_memory_allocated(device)
        launches += k3
        swapped = 0
        for r, a, w in zip(reqs, got, want):
            check_answers(sharded, r, a, K)
            for ga, wa in zip(a, w):
                ok, n = same_up_to_ties(ga.entity_ids, ga.scores,
                                        wa.entity_ids, wa.scores, TOL_SCORE)
                if not ok:
                    raise AssertionError(
                        f"serve.sharded {dtype}: answer {ga.entity_ids} "
                        f"{ga.scores} vs unsharded {wa.entity_ids} "
                        f"{wa.scores}")
                swapped += n
        bit_equal = True
        for s, req in firsts.items():
            _, *arrays = dense._pack(req)
            args = [torch.from_numpy(a).to(device) for a in arrays[:4]]
            with torch.inference_mode():
                qd = ff.fused_tgt_forward_multi(model, cfg, s, *args,
                                                operands=dense._k3)
                qs = ff.fused_tgt_forward_multi(sharded.model, cfg, s, *args,
                                                operands=sharded._k3)
            bit_equal &= bool(torch.equal(qd, qs))
        ms = np.asarray(lat)
        n_q = sum(map(len, reqs))
        block_bytes = BATCH * sharded._tables[0].shape[0] * 4
        line = (f"serve.sharded {dtype}: {len(reqs)} requests ({n_q} "
                f"queries) on {SHARD_PARTS} parts of {SMI['line']}: "
                f"latency_ms_p50={np.percentile(ms, 50):.3f} "
                f"latency_ms_p95={np.percentile(ms, 95):.3f} "
                f"queries_per_s={n_q / ms.sum() * 1e3:.1f}; K3 launches "
                f"{k3} (unsharded {k3_dense}); encodings_bit_equal="
                f"{bit_equal}; answers equal up to {swapped} tie swaps; "
                f"largest score block {block_bytes} B ([{BATCH}, "
                f"{sharded._tables[0].shape[0]}] f32); ranking blocks "
                f"{sharded.table_bytes} B; peak_mem_bytes={peak}; setup "
                f"{setup_s:.2f} s")
        log(line)
        if k3 == 0 or k3 != k3_dense or not bit_equal:
            raise AssertionError(line)
        del dense, sharded, want, got
        torch.cuda.empty_cache()
    return launches


def phase_eval_sharded(model, cfg, kg, val_q, device, want) -> int:
    """``eval.sharded``: ``full_ranking_sharded`` over SHARD_PARTS parts
    of the card against ``full_ranking``'s metrics (``want``): MRR,
    mean rank and Hits@k within 1e-6; then per structure the ranks of
    both routes from the same query vectors, the count that differ and
    each one's score gap (the nearest same-mode competitor's distance
    from the true answer's score).  Returns its K3 launches."""
    from mpqe_tpu_torch.data.batcher import bucket_size
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.parallel import rank_shard
    from mpqe_tpu_torch.train import evaluation

    mesh = shard_mesh(device)
    ff.fused_tgt_forward_multi.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    rk = evaluation.full_ranking_sharded(model, cfg, val_q, kg.entity_mode,
                                         mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = ff.fused_tgt_forward_multi.launches
    peak = torch.cuda.max_memory_allocated(device)
    worst = max(abs(rk[s][m] - want[s][m]) for s in want for m in want[s])
    log(f"eval.sharded: {len(rk)} structures in {wall:.3f} s on "
        f"{SHARD_PARTS} parts of {SMI['line']}; K3 launches {k3}; "
        f"peak_mem_bytes={peak}; max |metric - full_ranking's| = "
        f"{worst:.3e}")
    if set(rk) != set(want) or worst > 1e-6 or k3 == 0:
        raise AssertionError(f"eval.sharded: {rk} vs {want}")

    sharded = rank_shard.shard_encode_params(model, mesh)
    table = sharded.emb.ent
    modes = rank_shard.shard_modes(mesh, kg.entity_mode, table.n_padded)
    rank_fn = rank_shard.make_sharded_rank_fn(mesh, cfg)
    ops = ff.prepare_fused_multi(model, cfg)
    emode = torch.from_numpy(kg.entity_mode.astype(np.int32)).to(device)
    es = evaluation.make_eval_set(val_q, 200, require_negatives=False)
    n_diff = 0
    for s, data in es.by_structure.items():
        n = data["target"].shape[0]
        B = bucket_size(n)
        pad = [evaluation._pad_chunk(data[k], 0, n, B, device, fill)
               for k, fill in (("node_entity", 0), ("node_mode", 0),
                               ("edge_rel", 0), ("edge_norm", 1))]
        tgt = evaluation._pad_chunk(data["target"], 0, n, B, device)
        with torch.no_grad():
            q = mpqe_mod.encode_dense_multi_auto(model, cfg, s, *pad,
                                                 operands=ops)
            scores = mpqe_mod.score_all_entities(model, cfg, q)
            t = tgt.long()
            ok = emode[None, :] == emode[t][:, None]
            true_s = scores.gather(1, t[:, None])
            r_d = 1 + torch.sum((scores > true_s) & ok, dim=1)
            r_s = rank_fn(table.blocks, modes, q.float(), tgt)
            diff = (r_d != r_s)[:n].nonzero().flatten().tolist()
            for i in diff:
                gap = (scores[i] - true_s[i]).abs()
                gap[t[i]] = float("inf")
                gap = gap.masked_fill(~ok[i], float("inf"))
                log(f"eval.sharded.rank_diff {s} query {i}: full_ranking "
                    f"{int(r_d[i])} sharded {int(r_s[i])} score gap "
                    f"{float(gap.min()):.3e}")
        n_diff += len(diff)
    log(f"eval.sharded: {n_diff} ranks differ of "
        f"{sum(d['target'].shape[0] for d in es.by_structure.values())}")
    return k3


def phase_train_spmd(kg, train_q, device, keep=None) -> int:
    """``train.spmd``: SPMD_STEPS SGD steps of the data-parallel step
    with the entity table row-sharded, on a (2, 2) mesh of 4 parts of the
    card, against the port's single-device step from the same initial
    state (checked equal) on the same batches: losses within SPMD_TOL
    (relative), each parameter's change within SPMD_TOL mean-normalized
    per leaf (the gathers' gradients sum with atomics, in another order
    each run); then the train CLI at
    ``--parallel spmd`` in-process (a (1, 1) mesh), ``evaluate
    --ranking`` and ``serve --run_dir`` of its run, and ``serve --shards
    N + 1`` refused with the reference's message (N the visible cards).
    Returns the K3 launches of the CLI runs.  ``keep``: a directory
    where the CLI's run dir (``<keep>/run``) stays for ``multicard``."""
    import contextlib
    import os
    import re
    import tempfile

    from mpqe_tpu_torch import evaluate as eval_cli
    from mpqe_tpu_torch import serve as serve_cli
    from mpqe_tpu_torch.data.store import build_stores, pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import spmd
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.train import __main__ as train_cli
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    tc = loop_mod.TrainConfig(lr=SPMD_LR, optimizer="sgd",
                              batch_size=TRAIN_BATCH, n_neg=4)
    stores = build_stores(train_q, kg=kg)
    batches = []
    for s in SPMD_STRUCTURES:
        fstore = max(stores[s], key=lambda f: f.n_queries)
        batches.append(pack_dense_batch_np(
            fstore, np.arange(min(fstore.n_queries, TRAIN_BATCH)),
            TRAIN_BATCH, 4, 17))
    single = loop_mod.init_train_state(
        torch.Generator(device=device).manual_seed(5), cfg, tc,
        device=device)
    one = loop_mod.make_train_step(cfg, single.optimizer)
    init = {k: v.clone() for k, v in single.model.state_dict().items()}
    mesh = shard_mesh(device, (2, 2))
    init_fn, step = spmd.make_spmd_train_step(cfg, tc, mesh)
    state = init_fn(torch.Generator(device=device).manual_seed(5))
    same_init = all(torch.equal(v, init[k])
                    for k, v in state.model.state_dict().items())
    put = functools.partial(spmd.put_batch, mesh)
    ms_single, ms_spmd, worst_loss = [], [], 0.0
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        la = loop_mod.run_step(one, single, b)
        ms_single.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        lb = loop_mod.run_step(step, state, b, put)
        ms_spmd.append((time.perf_counter() - t0) * 1e3)
        worst_loss = max(worst_loss, abs(la - lb) / max(abs(la), 1e-12))
    got, want = state.model.state_dict(), single.model.state_dict()
    e_change = tree_change_err({k: v - init[k] for k, v in got.items()},
                               {k: v - init[k] for k, v in want.items()})
    e_mean = tree_mean_err(got, want)
    ent = state.model.emb.ent
    line = (f"train.spmd: {SPMD_STEPS} SGD steps (lr {SPMD_LR}) of batch "
            f"{TRAIN_BATCH} ({', '.join(SPMD_STRUCTURES)}) on a (2, 2) mesh "
            f"of {SMI['line']}, the table in {len(ent.blocks)} blocks of "
            f"{ent.block_rows} rows, initial parameters equal: {same_init}: "
            f"loss_err={worst_loss:.3e} change_err={e_change:.3e} "
            f"(param_mean_err={e_mean:.3e}); step ms spmd "
            f"{[round(x, 3) for x in ms_spmd]} single "
            f"{[round(x, 3) for x in ms_single]}")
    log(line)
    if not same_init or worst_loss > SPMD_TOL or e_change > SPMD_TOL or \
            len(ent.blocks) != 2:
        raise AssertionError(line)
    del state, single, one, step, init, got, want
    torch.cuda.empty_cache()

    with (contextlib.nullcontext(keep) if keep
          else tempfile.TemporaryDirectory()) as tmp:
        run_dir = os.path.join(tmp, "run")
        tgt_counters(reset=True)
        lines = run_cli(train_cli.main, [
            "--data", "synthetic", "--parallel", "spmd", "--mesh", "1,1",
            "--steps", "20",
            "--val_every", "10", "--num_bases", "16", "--n_neg", "4",
            "--syn_entities", "20000", "--syn_modes", "4", "--syn_rels",
            "20", "--syn_triples", "60000", "--syn_train_queries", "700",
            "--syn_val_queries", "140", "--device", str(device),
            "--run_dir", run_dir], "train.spmd.cli")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
        payload = torch.load(os.path.join(run_dir, "ckpt", "step_20",
                                          "state.pt"), map_location="cpu",
                             weights_only=True)
        shape = tuple(payload["model"]["emb.ent"].shape)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            mesh_rec = [r for r in map(json.loads, f)
                        if r.get("event") == "mesh"]
        log(f"train.spmd.cli --parallel spmd: {lines[-1]}; mesh "
            f"{mesh_rec[0]['shape']}; ckpt/{','.join(ckpts)}; emb.ent "
            f"{shape} in the checkpoint")
        if not re.fullmatch(r"final step=20 macro_auc=\S+ macro_apr=\S+",
                            lines[-1]) or "step_20" not in ckpts or \
                shape != (20000, cfg.embed_dim):
            raise AssertionError(f"train.spmd.cli: {lines[-1]} {ckpts} "
                                 f"{shape}")
        ev = run_cli(eval_cli.main, ["--run_dir", run_dir, "--ranking"],
                     "train.spmd.eval.cli")
        head = json.loads(ev[0])
        if head["step"] != 20 or not all("mrr" in json.loads(ln)
                                         for ln in ev[1:]) or len(ev) < 2:
            raise AssertionError(f"train.spmd.eval.cli: {ev}")
        log(f"train.spmd.eval.cli: {ev[0]}")
        sv = run_cli(serve_cli.main, [
            "--run_dir", run_dir, "--requests", "21", "--batch", "8",
            "--structures", ",".join(STRUCTURE_NAMES)],
            "train.spmd.serve.cli")
        out = json.loads(sv[-1])
        log(f"train.spmd.serve.cli --run_dir: {sv[-1]}")
        if not str(out.get("checkpoint", "")).endswith("step_20"):
            raise AssertionError(f"train.spmd.serve.cli: {sv[-1]}")
    k3 = tgt_counters()[2]
    have = torch.cuda.device_count()
    try:
        serve_cli.main(["--init_seed", "0", "--shards", str(have + 1)])
    except SystemExit as e:
        msg = str(e)
    else:
        raise AssertionError(f"serve --shards {have + 1} ran on {have} "
                             "cards")
    log(f"train.spmd: serve --shards {have + 1} on {have} card(s) exits: "
        f"{msg!r}")
    if f"--shards {have + 1} needs that many devices, have {have}" not in msg:
        raise AssertionError(f"serve --shards {have + 1}: {msg!r}")
    return k3


def phase_multihost(device) -> None:
    """``multihost``: two processes on the card joined by an explicitly
    named gloo group (NCCL takes one card per rank: across cards it is
    ``multicard.nccl``), each on its own (2, 1) mesh of the card with half of
    every global batch, SPMD_STEPS steps at the flagship width with a
    1,000,000-entity table (``tools/multihost_run.py``, SGD), against
    one process over the global batch on a (4, 1) mesh: the two
    processes' losses and parameter changes equal each other bit for bit,
    their losses equal the one process's within MULTIHOST_TOL (relative)
    and rank 0's parameter changes the one process's within SPMD_TOL
    (mean-normalized per leaf)."""
    import os
    import socket
    import tempfile

    from mpqe_tpu_torch.tools import multihost_run

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--device", "cuda:0", "--steps", str(SPMD_STEPS),
                  "--mesh", "2,1", "--params", "--out",
                  os.path.join(tmp, "two")]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mpqe_tpu_torch.tools.multihost_run",
             "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
             "--process_id", str(r), "--backend", "gloo", *common],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in (0, 1)]
        try:
            one = multihost_run.main(["--device", "cuda:0", "--steps",
                                      str(SPMD_STEPS), "--mesh", "4,1",
                                      "--params", "--out",
                                      os.path.join(tmp, "one")])
            errs = []
            for p in procs:
                _, err = p.communicate(timeout=300)
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for p, err in zip(procs, errs):
            if p.returncode != 0:
                raise AssertionError(f"multihost worker rc={p.returncode}:"
                                     f"\n{err[-3000:]}")
        two = [dict(np.load(os.path.join(tmp, "two", f"rank{r}.npz")))
               for r in (0, 1)]
    del one["state"]
    torch.cuda.empty_cache()
    want = np.asarray(one["losses"])
    losses = two[0].pop("losses")
    ranks_equal = bool(np.array_equal(losses, two[1].pop("losses"))) and \
        all(np.array_equal(v, two[1][k]) for k, v in two[0].items())
    err = float(np.max(np.abs(losses - want) / np.abs(want)))
    e_change = tree_change_err(two[0], one["changes"])
    line = (f"multihost: 2 processes (backend gloo) on {SMI['line']}, "
            f"{SPMD_STEPS} spmd SGD steps, each process a (2, 1) mesh and "
            f"half of each 512-query batch: losses {losses.tolist()} (rank "
            f"1's losses and parameter changes equal: {ranks_equal}); one "
            f"process over the global batch {want.tolist()}; "
            f"loss rel_err={err:.3e} change_err={e_change:.3e}; "
            f"{wall:.1f} s; NCCL across cards is multicard.nccl's")
    log(line)
    if not ranks_equal or err > MULTIHOST_TOL or e_change > SPMD_TOL:
        raise AssertionError(line)


MP_PARTS = 2  # parts of the card each process of multihost.halo holds
MP_RING_SIZES = (2, 4)  # kernel.ring.multiprocess: one, two parts a process
MP_TIMED_CALLS = 5  # K8 calls timed across processes, per ring size
MP_TIMEOUT_S = 600


def mp_ring_case(cfg, P: int, device):
    """K8's case across processes (the same in every process): the
    general graph at the flagship width over P parts, its x and a layer
    of 16 bases from fixed seeds, and a second x for the control."""
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.parallel import halo

    gen = torch.Generator(device=device).manual_seed(21)
    layer = rgcn_ops.init_rgcn_layer(gen, cfg.embed_dim, cfg.embed_dim,
                                     cfg.n_rels, cfg.num_bases,
                                     device=device)
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1, generator=gen)
    st = general_store(cfg)
    pr = halo.partition_edges_ring(st, P)
    x = torch.zeros((pr.n_nodes_padded, cfg.embed_dim), device=device)
    x[:st.n_nodes] = torch.randn((st.n_nodes, cfg.embed_dim), generator=gen,
                                 device=device)
    edges = [torch.from_numpy(a).to(device) for a in (
        pr.src_local, pr.dst_local, pr.rel, pr.norm)]
    return layer, x, edges, x.flip(0).contiguous()


class delayed_senders:
    """Within the block each K8 copy into another process's slot, and
    each send to another node, is preceded on its stream by
    ``torch.cuda._sleep``: the receiver's aggregate would run before the
    block lands but for the ``recv`` counter or the receive's event.
    ``skip_receive=True`` also drops the receivers' waits (the negative
    control)."""

    def __init__(self, skip_receive: bool = False):
        self.skip = skip_receive

    def __enter__(self):
        from mpqe_tpu_torch.ops import ring

        self.saved = (ring._remote_copy, ring._wait_received, ring._net_hop)
        copy, net = ring._remote_copy, ring._net_hop

        def late(*a):
            torch.cuda._sleep(RING_SLEEP_CYCLES)
            return copy(*a)

        def late_net(link, *a):
            if link.net_send:  # before the staging copy and the send
                torch.cuda._sleep(RING_SLEEP_CYCLES)
            return net(link, *a)

        ring._remote_copy, ring._net_hop = late, late_net
        if self.skip:
            ring._wait_received = lambda *a: None
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import ring

        ring._remote_copy, ring._wait_received, ring._net_hop = self.saved
        return False


class timed_hops:
    """Within the block, CUDA events around every K8 copy into another
    process's slot (on the copy stream), every wait on a ``recv``
    counter (on the waiting stream) and every hop between nodes that
    receives (on the boundary stream, from its staging copy to the
    receive's end): their mean ms when read."""

    def __enter__(self):
        from mpqe_tpu_torch.ops import ring

        self.saved = (ring._remote_copy, ring._wait_received, ring._net_hop)
        self.copies, self.waits, self.nets = [], [], []

        def wrap(fn, into, when=lambda *a: True):
            def timed(*a):
                if not when(*a):
                    return fn(*a)
                a0 = torch.cuda.Event(enable_timing=True)
                b0 = torch.cuda.Event(enable_timing=True)
                a0.record()
                out = fn(*a)
                b0.record()
                into.append((a0, b0))
                return out
            return timed

        ring._remote_copy = wrap(self.saved[0], self.copies)
        ring._wait_received = wrap(self.saved[1], self.waits,
                                   lambda link, *a: not link.net_recv)
        ring._net_hop = wrap(self.saved[2], self.nets,
                             lambda link, *a: link.net_recv)
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import ring

        ring._remote_copy, ring._wait_received, ring._net_hop = self.saved
        return False

    def means(self) -> tuple:
        """(copy, counter wait, hop between nodes) mean ms."""
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return tuple(sum(a.elapsed_time(b) for a, b in ev) / max(len(ev), 1)
                     for ev in (self.copies, self.waits, self.nets))


def parts_of(cards: list, n: int) -> list:
    """``n`` parts over ``cards`` in order, as evenly as they go (one card
    repeated, or one part a card)."""
    return [cards[i * len(cards) // n] for i in range(n)]


EXCHANGE_CASES = (((3,), torch.float32), ((2, 5), torch.bfloat16),
                  ((4, 3, 2), torch.int64), ((128, 8), torch.float16),
                  ((7,), torch.uint8))


def exchange_inputs(case: int, rank: int) -> list:
    """Process ``rank``'s contribution to exchange case ``case`` of
    EXCHANGE_CASES: ``(rank + case) % 3`` tensors (unequal counts, none
    at all among them) from a seed, on the CPU."""
    shape, dtype = EXCHANGE_CASES[case]
    gen = torch.Generator().manual_seed(1000 * case + rank)
    return [(torch.randn(shape, generator=gen) * 100).to(dtype)
            if dtype.is_floating_point
            else torch.randint(0, 200, shape, generator=gen).to(dtype)
            for _ in range((rank + case) % 3)]


def exchange_check(device) -> bool:
    """``multihost.exchange`` of every EXCHANGE_CASES case on ``device``:
    each process's contributions arrive bit for bit, as the same
    exchange within one node returns them."""
    from mpqe_tpu_torch.parallel import multihost

    ok = True
    for case in range(len(EXCHANGE_CASES)):
        mine = [t.to(device) for t in exchange_inputs(
            case, multihost.process_index())]
        got = multihost.exchange(mine, device, f"case {case}")
        for r, ts in enumerate(got):
            want = exchange_inputs(case, r)
            ok &= len(ts) == len(want) and all(
                torch.equal(a.cpu(), b) for a, b in zip(ts, want))
    return ok


def multiprocess_worker(port: str, rank: str, out: str, backend="gloo",
                        cards="cuda:0", spmd="0") -> int:
    """One process of a group of worker processes (``chip_smoke.py
    --multiprocess-worker PORT RANK OUT [BACKEND CARDS SPMD]``, a pair;
    under ``torchrun``, ``chip_smoke.py --multinode-worker OUT CARDS
    SPMD``, PORT and RANK ``env``, the group's size from torchrun's
    variables, CARDS ``;``-separated by local rank): a group under
    ``backend`` whose process ``rank`` holds its parts on ``cards``
    (comma-separated; the first is its own); the exchange cases
    (:func:`exchange_check`); with ``spmd`` 1 the spmd step on its (2,
    1) mesh of its first card and its share of every global batch
    (``tools/multihost_run.py``, SPMD_STEPS SGD steps at the flagship
    width); the halo step for ``halo_ring`` and ``halo_gather`` on its
    share of a (2 MP_PARTS, 1) mesh; then K8 at each MP_RING_SIZES the
    processes divide, with its sender delayed, the control, and timed
    calls.  Writes ``<out>/k8_rank<r>.npz``."""
    import os

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel import ipc, multihost
    from mpqe_tpu_torch.tools import multihost_run

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    if port == "env":  # torchrun's variables
        cards = cards.split(";")[int(os.environ["LOCAL_RANK"])]
    cards = [torch.device(c) for c in cards.split(",")]
    device = cards[0]
    if port == "env":
        multihost.initialize(backend=backend, device=str(device),
                             timeout_s=MP_TIMEOUT_S)
    else:
        multihost.initialize(f"127.0.0.1:{port}", 2, int(rank),
                             backend=backend, device=str(device),
                             timeout_s=MP_TIMEOUT_S)
    rank, world = multihost.process_index(), multihost.process_count()

    def stage(what):  # progress, on the worker's own output
        log(f"worker {rank}/{world}: {what} at {time.perf_counter() - t0:.1f}"
            " s")

    stage(f"nodes {multihost.nodes()}")
    res = {"nodes": np.asarray(multihost.nodes()),
           "exchange_ok": np.asarray(exchange_check(device))}
    stage("exchange cases")
    if spmd == "1":
        multihost_run.main([
            "--device", str(device), "--steps", str(SPMD_STEPS), "--mesh",
            f"{4 // world},1", "--params", "--out",
            os.path.join(out, "spmd")])
        stage("spmd")
    parts = 2 * MP_PARTS // world
    for kind in ("ring", "gather"):
        multihost_run.main([
            "--device", str(device), "--devices",
            ",".join(map(str, parts_of(cards, parts))), "--parallel",
            f"halo_{kind}", "--mesh", f"{parts},1", "--steps",
            str(SPMD_STEPS), "--params", "--out", os.path.join(out, kind)])
        stage(f"halo_{kind}")
    torch.cuda.empty_cache()
    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    for P in MP_RING_SIZES:
        if P % world:
            continue
        stage(f"K8 P={P}")
        layer, x, edges, x2 = mp_ring_case(cfg, P, device)
        mesh = multihost.global_mesh((P, 1), parts_of(cards, P // world))

        def k8(xx):
            return ring.rgcn_ring_halo_rdma(mesh, layer, xx, *edges,
                                            cfg.n_rels)

        with torch.no_grad():
            ring.rgcn_ring_halo_rdma.launches = 0
            with delayed_senders():
                res[f"late{P}"] = k8(x).cpu().numpy()
            res[f"again{P}"] = k8(x).cpu().numpy()
            k8(x2)  # the slots now hold x2's blocks
            with delayed_senders(skip_receive=True):
                res[f"control{P}"] = k8(x).cpu().numpy()
            t1 = time.perf_counter()
            with timed_hops() as th:
                for _ in range(MP_TIMED_CALLS):
                    k8(x)
                for c in cards:
                    torch.cuda.synchronize(c)
            res[f"ms{P}"] = np.asarray(
                (time.perf_counter() - t1) * 1e3 / MP_TIMED_CALLS)
            res[f"copy_ms{P}"], res[f"wait_ms{P}"], res[f"net_ms{P}"] = map(
                np.asarray, th.means())
            res[f"launches{P}"] = np.asarray(
                ring.rgcn_ring_halo_rdma.launches)
        del layer, x, edges, x2
    res["opened_from"] = np.asarray(ipc.opened_from(), dtype=np.int64)
    np.savez(os.path.join(out, f"k8_rank{rank}.npz"), **res)
    ipc.close()
    stage("done")
    return 0


# the one-process runs every pair of worker processes is held to, made
# once: "ring" / "gather" (the halo step on a (2 MP_PARTS, 1) mesh of the
# card), "spmd" (the spmd step over the global batch on a (4, 1) mesh),
# P -> (K8, its plain version) on the general graph
MP_REFS: dict = {}


def mp_references(device, tmp: str, spmd: bool) -> dict:
    """:data:`MP_REFS`, computed where missing, on ``device``."""
    import os

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.tools import multihost_run

    for kind in ("ring", "gather"):
        if kind not in MP_REFS:
            one = multihost_run.main([
                "--device", str(device), "--parallel", f"halo_{kind}",
                "--mesh", f"{2 * MP_PARTS},1", "--steps", str(SPMD_STEPS),
                "--params", "--out", os.path.join(tmp, "one_" + kind)])
            del one["state"]
            MP_REFS[kind] = one
    if spmd and "spmd" not in MP_REFS:
        one = multihost_run.main([
            "--device", str(device), "--steps", str(SPMD_STEPS), "--mesh",
            "4,1", "--params", "--out", os.path.join(tmp, "one_spmd")])
        del one["state"]
        MP_REFS["spmd"] = one
    torch.cuda.empty_cache()
    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    with torch.no_grad():
        for P in MP_RING_SIZES:
            if P in MP_REFS:
                continue
            layer, x, edges, _ = mp_ring_case(cfg, P, device)
            mesh = make_mesh((P, 1), devices=[device] * P)
            MP_REFS[P] = (
                ring.rgcn_ring_halo_rdma(mesh, layer, x, *edges,
                                         cfg.n_rels).cpu(),
                ring.rgcn_ring_halo_rdma_reference(
                    mesh, layer, x, *edges, cfg.n_rels).cpu())
            del layer, x, edges
    return MP_REFS


def mp_pair(device, tmp: str, backend: str, cards: list,
            spmd: bool = False) -> float:
    """Two worker processes (:func:`multiprocess_worker`), process r on
    ``cards[r]`` (a comma-separated list), their results under ``tmp``;
    meanwhile :func:`mp_references` in this process.  Returns the wall
    seconds; a worker's failure raises."""
    import os
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--multiprocess-worker", str(port), str(r), tmp, backend, cards[r],
         "1" if spmd else "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        mp_references(device, tmp, spmd)
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=MP_TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise AssertionError(f"multiprocess worker ({backend}, "
                                 f"{cards}) rc={p.returncode}:\n"
                                 f"{err[-3000:]}")
    return time.perf_counter() - t0


def mp_compare(tmp: str, labels: tuple, where: tuple,
               spmd: bool = False, world: int = 2,
               figures: dict = None) -> tuple:
    """Hold a group's results under ``tmp`` (``world`` worker processes)
    to :data:`MP_REFS`: the exchange cases; the halo step (and with
    ``spmd`` the spmd step): the ranks' losses and parameter changes
    bit-equal, their losses within MULTIHOST_TOL (relative) and rank 0's
    changes within SPMD_TOL of one process's; K8 at each MP_RING_SIZES
    the processes divide bit-equal to the one-process K8 (with its sender
    delayed, and a repeat), under ``ring_gate`` against its plain
    version, the control different.  ``labels``: the spmd, halo and K8
    lines' names; ``where``: the halo (and spmd) and K8 lines'
    descriptions.  Returns (failed lines, the workers' K8 launches);
    ``figures`` (where given) gets rank 0's K8 times by P."""
    import os

    from mpqe_tpu_torch.ops import ring

    bad, launches = [], 0
    figures = {} if figures is None else figures
    ranks = range(world)
    k8 = [dict(np.load(os.path.join(tmp, f"k8_rank{r}.npz"))) for r in ranks]
    if not all(bool(r["exchange_ok"]) for r in k8):
        bad.append(f"{labels[1]}: exchange cases differ from what each "
                   "process sent")
    kinds = (("spmd",) if spmd else ()) + ("ring", "gather")
    for kind in kinds:
        a, *others = [dict(np.load(os.path.join(tmp, kind, f"rank{r}.npz")))
                      for r in ranks]
        want = np.asarray(MP_REFS[kind]["losses"])
        losses = a.pop("losses")
        ranks_equal = all(
            np.array_equal(losses, b.pop("losses"))
            and all(np.array_equal(v, b[k]) for k, v in a.items())
            for b in others)
        err = float(np.max(np.abs(losses - want) / np.abs(want)))
        e_change = tree_change_err(a, MP_REFS[kind]["changes"])
        label = labels[0] if kind == "spmd" else f"{labels[1]} {kind}"
        one = "(4, 1)" if kind == "spmd" else f"({2 * MP_PARTS}, 1)"
        line = (f"{label}: {where[0]}, {SPMD_STEPS} SGD steps of the "
                f"{'global' if kind == 'spmd' else 'whole'} "
                f"{TRAIN_BATCH}-query batch: losses {losses.tolist()} "
                f"(ranks' losses and parameter changes bit-equal: "
                f"{ranks_equal}); one process on a {one} mesh "
                f"{want.tolist()}; loss rel_err={err:.3e} "
                f"change_err={e_change:.3e}")
        log(line)
        if not ranks_equal or err > MULTIHOST_TOL or e_change > SPMD_TOL:
            bad.append(line)
    for P in MP_RING_SIZES:
        if P % world:
            continue
        got_k8, plain = MP_REFS[P]
        want = got_k8.numpy()
        late = [r[f"late{P}"] for r in k8]
        equal = all(np.array_equal(v, want) for v in late) and all(
            np.array_equal(r[f"again{P}"], want) for r in k8)
        gate = ring.ring_gate(torch.from_numpy(late[0]), plain)
        ctl_differs = all(not np.array_equal(r[f"control{P}"], want)
                          for r in k8)
        n = int(sum(int(r[f"launches{P}"]) for r in k8))
        launches += n
        fig = {k: float(k8[0][f"{k}{P}"])
               for k in ("ms", "copy_ms", "wait_ms", "net_ms")}
        figures[P] = fig
        line = (f"{labels[2]} general P={P} ({P // world} parts a "
                f"process, {where[1]}): "
                f"bit_equal_one_process={equal} (sender delayed "
                f"{RING_SLEEP_CYCLES} cycles a hop, and a repeat) gate_ok="
                f"{gate['ok']} err_vs_plain={gate['err_vs_plain']:.3e} "
                f"control_differs={ctl_differs} (receive wait skipped, "
                f"sender delayed) launches={n} ({world} processes) "
                f"cross_ms={fig['ms']:.4f} (a call, host clock, mean of "
                f"{MP_TIMED_CALLS}) hop_copy_ms={fig['copy_ms']:.4f} "
                f"counter_wait_ms={fig['wait_ms']:.4f} net_hop_ms="
                f"{fig['net_ms']:.4f} (CUDA events, rank 0, means per IPC "
                f"copy, counter wait and hop between nodes)")
        log(line)
        if not (equal and gate["ok"] and ctl_differs) or n == 0:
            bad.append(line)
    return bad, launches


def phase_multiprocess(device) -> int:
    """``multihost.halo`` and ``kernel.ring.multiprocess``: two worker
    processes on the card (:func:`multiprocess_worker`, launched once for
    both phases, gloo), each holding half of the parts; meanwhile the
    same runs in this process on one (4, 1) mesh of the card.  The halo
    step (``halo_ring``, ``halo_gather``): the ranks' losses and
    parameter changes bit-equal, their losses within MULTIHOST_TOL
    (relative) and rank 0's changes within SPMD_TOL of one process's.  K8
    at P = 2 and 4 across the processes, its sender delayed: bit-equal to
    the one-process K8 on the same inputs (and a repeat, undelayed, too),
    ``ring_gate`` against its plain version, and the control (the receive
    counter skipped under a delayed sender, after a call on another x)
    different.  Returns the workers' K8 launches."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        wall = mp_pair(device, tmp, "gloo", [str(device)] * 2)
        bad, launches = mp_compare(
            tmp, (None, "multihost.halo", "kernel.ring.multiprocess"),
            (f"2 processes (backend gloo, CUDA IPC) x {MP_PARTS} parts of "
             f"{SMI['line']}", f"2 processes on {SMI['line']}"))
    log(f"multihost.halo, kernel.ring.multiprocess: {wall:.1f} s")
    if bad:
        raise AssertionError("; ".join(bad))
    return launches


# the multicard group: N = every visible card, at most MULTICARD_MAX
MULTICARD_MAX = 8
MULTICARD_SHARD_DTYPES = ("float32", "int8")
MULTICARD_TIMED_CALLS = 5


class delayed_copies:
    """Within: each K8 hop's copies into a card's slots (``ring._copies``,
    one process) are preceded on that card's copy stream by
    ``torch.cuda._sleep``, so the receiver's aggregate would run before
    the block lands but for the receive event; ``skip_receive=True`` also
    drops the compute streams' waits on that event (the negative
    control).  ``timed=True`` records CUDA events around each call
    instead (the hop copy's ms, :meth:`mean_ms`)."""

    def __init__(self, skip_receive: bool = False, timed: bool = False):
        self.skip, self.timed, self.events = skip_receive, timed, []

    def __enter__(self):
        from mpqe_tpu_torch.ops import ring

        self.saved = (ring._copies, ring._wait_copied)
        copies = ring._copies

        def wrapped(groups, plan, cur, nxt, dev):
            if not plan[dev]:
                return copies(groups, plan, cur, nxt, dev)
            with torch.cuda.device(dev):
                if self.timed:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    copies(groups, plan, cur, nxt, dev)
                    b.record()
                    self.events.append((a, b))
                    return None
                torch.cuda._sleep(RING_SLEEP_CYCLES)
            return copies(groups, plan, cur, nxt, dev)

        ring._copies = wrapped
        if self.skip:
            ring._wait_copied = lambda *a: None
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import ring

        ring._copies, ring._wait_copied = self.saved
        return False

    def mean_ms(self) -> float:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return sum(a.elapsed_time(b) for a, b in self.events) / max(
            len(self.events), 1)


def multicard_shards(cfg, kg, cards: list, run_dir: str) -> int:
    """``multicard.shards``: ``ShardedQueryServer`` over a (1, N) mesh of
    the N cards (``cli_mesh``) at float32 and int8 against the unsharded
    server of the same table dtype on cuda:0, one single-structure request
    of ``sample_stream`` per structure and one mixed: answers equal up to
    ties, K3's launches equal and nonzero; ``serve --shards N`` against
    ``serve`` (the same requests: ``hit_at_k`` equal) and ``evaluate
    --ranking --shards N`` against ``evaluate --ranking`` of the train.spmd
    CLI's run (metrics within 1e-6).  Returns the K3 launches."""
    from mpqe_tpu_torch import evaluate as eval_cli
    from mpqe_tpu_torch import serve as serve_cli
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.parallel import mesh as mesh_lib
    from mpqe_tpu_torch.serve import QueryServer, ShardedQueryServer

    n, dev = len(cards), cards[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=dev)
    with torch.no_grad():
        for lp in model.layers:
            lp.bias.normal_(0.0, 0.1, generator=gen)
    mesh = mesh_lib.cli_mesh((1, n), dev, f"--shards {n}")
    single, mixed = sample_stream(kg)
    firsts = {}
    for req in single:
        firsts.setdefault(req[0].formula.structure, req)
    reqs = list(firsts.values()) + mixed[:1]
    launches = 0
    for dtype in MULTICARD_SHARD_DTYPES:
        dense = QueryServer(model, cfg, kg.entity_mode, device=dev,
                            table_dtype=dtype)
        ff.fused_tgt_forward_multi.launches = 0
        want = [dense.answer(r, k=K + 1) for r in reqs]
        k3_dense = ff.fused_tgt_forward_multi.launches
        del dense
        sharded = ShardedQueryServer(model, cfg, kg.entity_mode, mesh,
                                     table_dtype=dtype)
        ff.fused_tgt_forward_multi.launches = 0
        t0 = time.perf_counter()
        got = [sharded.answer(r, k=K) for r in reqs]
        ms = (time.perf_counter() - t0) * 1e3 / len(reqs)
        k3 = ff.fused_tgt_forward_multi.launches
        launches += k3
        swapped = 0
        for r, a, w in zip(reqs, got, want):
            check_answers(sharded, r, a, K)
            for ga, wa in zip(a, w):
                ok, m = same_up_to_ties(ga.entity_ids, ga.scores,
                                        wa.entity_ids, wa.scores, TOL_SCORE)
                if not ok:
                    raise AssertionError(
                        f"multicard.shards {dtype}: answer {ga.entity_ids} "
                        f"{ga.scores} vs one card {wa.entity_ids} "
                        f"{wa.scores}")
                swapped += m
        blocks = sorted({str(b.device) for b in sharded._tables})
        line = (f"multicard.shards {dtype}: {len(reqs)} requests of "
                f"{BATCH} on a (1, {n}) mesh of the blocks on {blocks}: "
                f"answers equal to one card's up to {swapped} tie swaps; "
                f"K3 launches {k3} (one card {k3_dense}); "
                f"{ms:.3f} ms a request")
        log(line)
        if k3 == 0 or k3 != k3_dense or len(blocks) != n:
            raise AssertionError(line)
        del sharded, got, want
        torch.cuda.empty_cache()
    del model
    tgt_counters(reset=True)
    base = ["--init_seed", "0", "--requests", "8", "--batch", "8",
            "--device", str(dev)]
    sv = {m: json.loads(run_cli(serve_cli.main, base + flag,
                                f"multicard.serve.cli{m}")[-1])
          for m, flag in ((1, []), (n, ["--shards", str(n)]))}
    ev = {m: [json.loads(ln) for ln in run_cli(
        eval_cli.main, ["--run_dir", run_dir, "--ranking", "--device",
                        str(dev)] + flag, f"multicard.eval.cli{m}")[1:]]
        for m, flag in ((1, []), (n, ["--shards", str(n)]))}
    worst = max(abs(a[k] - b[k]) for a, b in zip(ev[1], ev[n])
                for k in a if k != "ranking" and isinstance(a[k], float))
    same = [a["ranking"] for a in ev[1]] == [b["ranking"] for b in ev[n]]
    line = (f"multicard.shards cli: serve --shards {n} hit_at_k="
            f"{sv[n]['hit_at_k']} shards={sv[n]['shards']} (one card "
            f"{sv[1]['hit_at_k']}); evaluate --ranking --shards {n}: "
            f"{len(ev[n])} structures, max |metric - one card's| = "
            f"{worst:.3e}")
    log(line)
    if sv[n]["hit_at_k"] != sv[1]["hit_at_k"] or sv[n]["shards"] != n or \
            not same or worst > 1e-6 or not ev[n]:
        raise AssertionError(line)
    return launches + tgt_counters()[2]


def multicard_spmd(cards: list) -> None:
    """``multicard.spmd``: SPMD_STEPS SGD steps of the spmd step at the
    flagship width (``tools/multihost_run.py``'s batches, 10^6 entities)
    on an (N, 1) mesh and, for even N, an (N / 2, 2) mesh of the N cards,
    against the same mesh of N parts of cuda:0, run twice: bit-equal
    where the two one-card runs are bit-equal to each other, else within
    SPMD_TOL (losses, relative; changes, mean-normalized per leaf)."""
    from mpqe_tpu_torch.data.batcher import DenseQueryBatch
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import spmd
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.tools import multihost_run as mr
    from mpqe_tpu_torch.train import loop as loop_mod

    n, dev = len(cards), cards[0]
    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    tc = loop_mod.TrainConfig(lr=SPMD_LR, optimizer="sgd",
                              batch_size=TRAIN_BATCH, n_neg=mr.N_NEG)
    batches = [DenseQueryBatch(structure=mr.STRUCTURE, n_queries=TRAIN_BATCH,
                               **g)
               for g in mr.global_batches(SPMD_STEPS, TRAIN_BATCH,
                                          STRUCTURES[mr.STRUCTURE],
                                          cfg.n_entities)]

    def run(devices, shape):
        mesh = make_mesh(shape, devices=devices)
        init_fn, step = spmd.make_spmd_train_step(cfg, tc, mesh)
        state = init_fn(torch.Generator(device=dev).manual_seed(5))
        init = {k: v.clone() for k, v in state.model.state_dict().items()}
        put = functools.partial(spmd.put_batch, mesh)
        t0 = time.perf_counter()
        losses = [loop_mod.run_step(step, state, b, put) for b in batches]
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        changes = {k: (v - init[k]).cpu()
                   for k, v in state.model.state_dict().items()}
        del state, init
        torch.cuda.empty_cache()
        return np.asarray(losses), changes, ms

    shapes = [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else [])
    for shape in shapes:
        ref, again, got = (run(devs, shape) for devs in (
            [dev] * n, [dev] * n, cards))
        self_equal = np.array_equal(ref[0], again[0]) and all(
            torch.equal(v, again[1][k]) for k, v in ref[1].items())
        bit_equal = np.array_equal(ref[0], got[0]) and all(
            torch.equal(v, got[1][k]) for k, v in ref[1].items())
        loss_err = float(np.max(np.abs(got[0] - ref[0]) / np.abs(ref[0])))
        e_change = tree_change_err(got[1], ref[1])
        line = (f"multicard.spmd {shape}: {SPMD_STEPS} SGD steps of batch "
                f"{TRAIN_BATCH} on {n} cards vs {n} parts of {dev}: "
                f"bit_equal={bit_equal} (one card bit-equal to itself: "
                f"{self_equal}) loss_err={loss_err:.3e} change_err="
                f"{e_change:.3e}; step ms {got[2]:.3f} on {n} cards, "
                f"{ref[2]:.3f} on one")
        log(line)
        ok = bit_equal if self_equal else (loss_err <= SPMD_TOL
                                           and e_change <= SPMD_TOL)
        if not ok:
            raise AssertionError(line)


def multicard_halo(cards: list, tmp: str) -> None:
    """``multicard.halo``: SPMD_STEPS SGD steps of ``halo_ring`` and
    ``halo_gather`` at the flagship width (``tools/multihost_run.py``, one
    process) over an (N, 1) mesh of the N cards against N parts of
    cuda:0: losses within MULTIHOST_TOL (relative), changes within
    SPMD_TOL."""
    import os

    from mpqe_tpu_torch.tools import multihost_run

    n = len(cards)
    for kind in ("ring", "gather"):
        out = {}
        for label, devs in (("one", [cards[0]] * n), ("cards", cards)):
            t0 = time.perf_counter()
            out[label] = multihost_run.main([
                "--device", str(cards[0]), "--devices",
                ",".join(map(str, devs)), "--parallel", f"halo_{kind}",
                "--mesh", f"{n},1", "--steps", str(SPMD_STEPS), "--params",
                "--out", os.path.join(tmp, f"halo_{kind}_{label}")])
            del out[label]["state"]
            out[label]["s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        a, b = out["cards"], out["one"]
        want = np.asarray(b["losses"])
        err = float(np.max(np.abs(np.asarray(a["losses"]) - want)
                           / np.abs(want)))
        e_change = tree_change_err(a["changes"], b["changes"])
        line = (f"multicard.halo {kind}: {SPMD_STEPS} SGD steps of the "
                f"whole {TRAIN_BATCH}-query batch over {n} cards: losses "
                f"{a['losses']}; {n} parts of {cards[0]} {b['losses']}; "
                f"loss rel_err={err:.3e} change_err={e_change:.3e}; "
                f"{a['s']:.1f} s on {n} cards, {b['s']:.1f} s on one")
        log(line)
        if err > MULTIHOST_TOL or e_change > SPMD_TOL:
            raise AssertionError(line)


def multicard_ring(cfg, cards: list) -> tuple:
    """``multicard.ring``: K8 on the general graph at the flagship width
    over P = 2 and P = N distinct cards (one part a card, one process),
    every hop's copies delayed ``RING_SLEEP_CYCLES`` on the receiver's
    copy stream: bit-equal to K8 with the P parts on cuda:0 (and a repeat,
    undelayed), under ``ring_gate`` against its plain version, 6 + 2 P
    launches a card and call, the control (the receive event skipped,
    copies delayed, after a call on another x) different; then
    MULTICARD_TIMED_CALLS calls: the call's ms (host clock) and the hop
    copy's (CUDA events on the copy stream) beside its bound (the block's
    bytes over one direction of the card's NVLink as ``nvidia-smi nvlink``
    reports it).  Returns (K8 launches, the figures by P)."""
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel import ipc
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.tools.peer_copy_probe import nvlink_gbps

    n, dev = len(cards), cards[0]
    gbps, links = nvlink_gbps(dev.index)
    launches, figures = 0, {}
    for P in sorted({2, n}):
        layer, x, edges, x2 = mp_ring_case(cfg, P, dev)
        one = make_mesh((P, 1), devices=[dev] * P)
        mesh = make_mesh((P, 1), devices=cards[:P])
        with torch.no_grad():
            if P in MP_REFS:
                want, plain = MP_REFS[P]
            else:
                want = ring.rgcn_ring_halo_rdma(one, layer, x, *edges,
                                                cfg.n_rels).cpu()
                plain = ring.rgcn_ring_halo_rdma_reference(
                    one, layer, x, *edges, cfg.n_rels).cpu()

            def k8(xx):
                return ring.rgcn_ring_halo_rdma(mesh, layer, xx, *edges,
                                                cfg.n_rels)

            ring.rgcn_ring_halo_rdma.launches = 0
            with delayed_copies():
                late = k8(x).cpu()
            n_launch = ring.rgcn_ring_halo_rdma.launches
            again = k8(x).cpu()
            k8(x2)  # the slots' memory now holds x2's blocks
            with delayed_copies(skip_receive=True):
                control = k8(x).cpu()
            t0 = time.perf_counter()
            with delayed_copies(timed=True) as tc:
                for _ in range(MULTICARD_TIMED_CALLS):
                    k8(x)
                for c in cards[:P]:
                    torch.cuda.synchronize(c)
            call_ms = (time.perf_counter() - t0) * 1e3 / MULTICARD_TIMED_CALLS
            copy_ms = tc.mean_ms()
            launches += ring.rgcn_ring_halo_rdma.launches
        equal = torch.equal(late, want) and torch.equal(again, want)
        gate = ring.ring_gate(late, plain)
        differs = not torch.equal(control, want)
        block_bytes = x.shape[0] // P * x.shape[1] * 4
        bound = (block_bytes / (gbps * 1e9) * 1e3 if gbps else None)
        peers = all(torch.cuda.can_device_access_peer(a.index, b.index)
                    for a in cards[:P] for b in cards[:P] if a != b)
        enabled = sorted(f"{a}->{b}" for a, b in ipc._PEERS
                         if a < P and b < P)
        figures[P] = dict(call_ms=call_ms, hop_copy_ms=copy_ms,
                          hop_bound_ms=bound, hop_bytes=block_bytes)
        line = (f"multicard.ring general P={P} on {[str(c) for c in cards[:P]]}"
                f" (one part a card): bit_equal_one_card={equal} (copies "
                f"delayed {RING_SLEEP_CYCLES} cycles, and a repeat) gate_ok="
                f"{gate['ok']} err_vs_plain={gate['err_vs_plain']:.3e} "
                f"control_differs={differs} (receive event skipped, copies "
                f"delayed) launches={n_launch} a call (6 + 2 P = "
                f"{6 + 2 * P} on each of {P} cards); peer access possible "
                f"{peers}, enabled {enabled}; call_ms={call_ms:.4f} (host "
                f"clock, mean of {MULTICARD_TIMED_CALLS}) hop_copy_ms="
                f"{copy_ms:.4f} ({block_bytes} B a copy, CUDA events on the "
                f"receiver's copy stream, mean) bound_ms="
                + (f"{bound:.4f} ({links} NVLink links, {gbps:.3f} GB/s one "
                   "direction, nvidia-smi nvlink --status)" if gbps
                   else "not measured (nvidia-smi reports no NVLink)"))
        log(line)
        if not (equal and gate["ok"] and differs and peers) or \
                n_launch != P * (6 + 2 * P):
            raise AssertionError(line)
        del layer, x, edges, x2
        torch.cuda.empty_cache()
    return launches, figures


def phase_multicard(kg, device, run_dir: str) -> dict:
    """The ``multicard`` group over N = every visible card (at most
    MULTICARD_MAX), each path held to the same path with its parts on one
    card: ``multicard.shards``, ``multicard.spmd``, ``multicard.halo``,
    ``multicard.ring`` (:func:`multicard_shards` ... :func:`multicard_ring`),
    ``multicard.nccl`` (two processes on cuda:0 and cuda:1 under NCCL: the
    spmd step, the halo step and K8 of :func:`mp_pair`, held to one
    process as ``multihost``, ``multihost.halo`` and
    ``kernel.ring.multiprocess`` are) and, with four cards or more,
    ``multicard.procs_x_cards`` (two processes of two cards each under
    NCCL: the halo step and K8).  With one card it prints that it did not
    run.  Returns ``{"K3", "K8", "ring", "seconds"}``."""
    import os
    import tempfile

    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    have = torch.cuda.device_count()
    if have < 2:
        log(f"multicard: not run, {have} card")
        return {"K3": 0, "K8": 0, "ring": {}, "seconds": 0.0}
    t0 = time.perf_counter()
    cards = [torch.device("cuda", i) for i in range(min(have,
                                                        MULTICARD_MAX))]
    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    log(f"multicard: {len(cards)} cards: "
        + "; ".join(torch.cuda.get_device_name(c) for c in cards))
    bad = []

    def check(name, fn, *args):
        """``fn(*args)``; a failure is logged and raised at the group's
        end, after the other checks have run."""
        t1 = time.perf_counter()
        try:
            return fn(*args)
        except Exception as e:  # raised below, with every other failure
            import traceback

            log(f"{name} FAILED: {traceback.format_exc()}")
            bad.append(f"{name}: {e!r}"[:2000])
        finally:
            log(f"{name}: {time.perf_counter() - t1:.1f} s")

    def pair(tmp, cards_of, labels, where, spmd):
        os.makedirs(tmp)
        mp_pair(device, tmp, "nccl", cards_of, spmd=spmd)
        return mp_compare(tmp, labels, where, spmd=spmd)

    k3 = check("multicard.shards", multicard_shards, cfg, kg, cards,
               run_dir) or 0
    check("multicard.spmd", multicard_spmd, cards)
    k8, figures = check("multicard.ring", multicard_ring, cfg,
                        cards) or (0, {})
    with tempfile.TemporaryDirectory() as tmp:
        check("multicard.halo", multicard_halo, cards, tmp)
        got = check("multicard.nccl", pair, os.path.join(tmp, "nccl"),
                    ["cuda:0", "cuda:1"],
                    ("multicard.nccl.spmd", "multicard.nccl.halo",
                     "multicard.nccl.ring"),
                    ("2 processes (backend nccl, CUDA IPC across cards) "
                     f"on cuda:0 and cuda:1, {MP_PARTS} parts each",
                     "2 processes under NCCL on cuda:0 and cuda:1"), True)
        if len(cards) >= 4:
            got2 = check(
                "multicard.procs_x_cards", pair,
                os.path.join(tmp, "procs_x_cards"),
                ["cuda:0,cuda:1", "cuda:2,cuda:3"],
                (None, "multicard.procs_x_cards.halo",
                 "multicard.procs_x_cards.ring"),
                ("2 processes (backend nccl) x 2 cards (cuda:0, cuda:1 | "
                 f"cuda:2, cuda:3), {MP_PARTS} parts each",
                 "2 processes under NCCL, process r on cuda:2r and "
                 "cuda:2r+1"), False)
        else:
            got2 = None
            log(f"multicard.procs_x_cards: not run, {len(cards)} cards "
                "(needs 4)")
    for g in (got, got2):
        if g is not None:
            bad += g[0]
            k8 += g[1]
    seconds = time.perf_counter() - t0
    log(f"multicard: {seconds:.1f} s on {len(cards)} cards; launches K3 "
        f"{k3}, K8 {k8}")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"K3": k3, "K8": k8, "ring": figures, "seconds": seconds}


# the multinode group: two node groups of this host, NCCL between them
# over its network transport (sockets on the loopback), as between two
# hosts without InfiniBand
MULTINODE_ENV = {"NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1",
                 "NCCL_IB_DISABLE": "1", "NCCL_SOCKET_IFNAME": "lo",
                 "NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,P2P,NET"}
# (label, each node's cards, processes a node, each process's cards by
# local rank (";"-separated, as the node sees them), spmd, cards needed)
MULTINODE_RUNS = (
    ("multinode", ([0], [1]), 1, "cuda:0", True, 2),
    ("multinode.mixed.procs", ([0, 1], [2, 3]), 2, "cuda:0;cuda:1", False,
     4),
    ("multinode.mixed.cards", ([0, 1], [2, 3]), 1, "cuda:0,cuda:1", False,
     4),
)


def mp_nodes(device, tmp: str, node_cards: tuple, nproc: int, cards: str,
             spmd: bool) -> tuple:
    """Two node groups of this host: one ``torchrun --nnodes 2
    --node_rank i`` launch each (``python -m torch.distributed.run``),
    node i over ``node_cards[i]`` (``CUDA_VISIBLE_DEVICES``) with
    ``nproc`` worker processes (``chip_smoke.py --multinode-worker``,
    :func:`multiprocess_worker` under NCCL), NCCL's peer-to-peer and
    shared-memory transports off (MULTINODE_ENV); meanwhile
    :func:`mp_references` in this process.  Returns (wall seconds, the
    count of each transport NCCL reported for a connection: ``via
    NET/Socket`` and the like, rank 0's progress lines); a launch's
    failure raises."""
    import collections
    import os
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    procs, logs = [], []
    for i, cv in enumerate(node_cards):
        env = dict(os.environ, **MULTINODE_ENV,
                   CUDA_VISIBLE_DEVICES=",".join(map(str, cv)),
                   NCCL_HOSTID=f"mpqe-node{i}")
        logs.append(os.path.join(tmp, f"node{i}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--nnodes",
                 "2", "--node_rank", str(i), "--nproc_per_node", str(nproc),
                 "--master_addr", "127.0.0.1", "--master_port", str(port),
                 os.path.abspath(__file__), "--multinode-worker", tmp,
                 cards, "1" if spmd else "0"],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    try:
        mp_references(device, tmp, spmd)
        for p in procs:
            p.wait(timeout=MP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for path in logs:
        with open(path, errors="replace") as f:
            texts.append(f.read())
    for p, text in zip(procs, texts):
        if p.returncode != 0:
            tail = "\n".join(ln for ln in text.splitlines()
                             if "NCCL INFO" not in ln)[-4000:]
            raise AssertionError(f"node group rc={p.returncode}:\n{tail}")
    via = collections.Counter(
        "/".join(m.split("/")[:2])
        for text in texts for m in re.findall(r" via (\S+)", text))
    stages = re.findall(r"worker 0/\d+: (.*) at ([0-9.]+) s", texts[0])
    return time.perf_counter() - t0, via, stages


def phase_multinode(device) -> tuple:
    """The ``multinode`` group: the parallel layer over two node groups of
    this host (:func:`mp_nodes`, NCCL between them over sockets), each
    run held to one process as the pairs are (:func:`mp_compare`):
    ``multinode`` (2 nodes x 1 process of one card: the exchange cases,
    the spmd step, the halo step, K8 at P = 2 and 4), and with four cards
    ``multinode.mixed.procs`` (2 nodes x 2 processes of one card: CUDA IPC
    within each node, NCCL between them; the halo step and K8 at P = 4)
    and ``multinode.mixed.cards`` (2 nodes x 1 process of two cards: the
    halo step and K8 at P = 2 and 4).  Each run's processes report their
    nodes as launched, open no CUDA IPC handle of a process on another
    node, and NCCL reports its network transport (``via NET``) for every
    connection.  With one card it prints ``multinode: not run, 1 card``.
    Returns (the workers' K8 launches, rank 0's K8 times by run and P)."""
    import os
    import tempfile
    import traceback

    have = torch.cuda.device_count()
    if have < 2:
        log(f"multinode: not run, {have} card")
        return 0, {}
    t0 = time.perf_counter()
    bad, launches, figures = [], 0, {}
    for label, node_cards, nproc, cards, spmd, need in MULTINODE_RUNS:
        if have < need:
            log(f"{label}: not run, {have} cards (needs {need})")
            continue
        world = 2 * nproc
        shape = (f"2 nodes x {nproc} process{'es' if nproc > 1 else ''} of "
                 f"{len(cards.split(';')[0].split(','))} card(s), node i "
                 f"on cards {list(node_cards)}")
        t1 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                wall, via, stages = mp_nodes(device, tmp, node_cards, nproc,
                                             cards, spmd)
                figs = {}
                b, n = mp_compare(
                    tmp, (f"{label}.spmd", f"{label}.halo", f"{label}.ring"),
                    (f"{shape}, NCCL between the nodes", shape), spmd=spmd,
                    world=world, figures=figs)
                k8 = [dict(np.load(os.path.join(tmp, f"k8_rank{r}.npz")))
                      for r in range(world)]
            nodes = [r["nodes"].tolist() for r in k8]
            want = [r // nproc for r in range(world)]
            across = sum(int(nodes[0][q] != nodes[0][r])
                         for r, w in enumerate(k8) for q in w["opened_from"])
            net = sum(v for k, v in via.items() if k.startswith("NET"))
            line = (f"{label}: {shape} ({SMI['line']} each): nodes "
                    f"{nodes[0]} (launched {want}); exchange cases "
                    f"({len(EXCHANGE_CASES)} dtypes and shapes, unequal "
                    f"counts) bit-equal to what each process sent: "
                    f"{all(bool(r['exchange_ok']) for r in k8)}; IPC "
                    f"handles opened across nodes {across}; NCCL "
                    f"transports {dict(via)}; {wall:.1f} s (rank 0: "
                    + ", ".join(f"{w} {t} s" for w, t in stages) + ")")
            log(line)
            if any(v != want for v in nodes) or across or not net or \
                    net != sum(via.values()):
                b.append(line)
            bad += b
            launches += n
            figures[label] = figs
        except Exception:  # raised below, with every other failure
            log(f"{label} FAILED: {traceback.format_exc()}")
            bad.append(f"{label}: failed")
        log(f"{label}: {time.perf_counter() - t1:.1f} s")
    seconds = time.perf_counter() - t0
    log(f"multinode: {seconds:.1f} s on {have} cards; K8 launches "
        f"{launches}")
    if bad:
        raise AssertionError("; ".join(bad))
    return launches, figures


def phase_dryrun(device) -> int:
    """``dryrun``: ``python -m mpqe_tpu_torch.tools.dryrun_multichip`` in
    process: DRYRUN_PARTS parts of the card on one card, else one part on
    each of the first min(4, N) cards: the spmd step with both tables
    sharded, the edge-partitioned layers, the ring and K8 against it, a
    halo step, K3 from the relation-sharded state bit-equal to K3
    unsharded, the sharded rank and top-k.  Returns (K8's launches, K3's
    launches)."""
    from mpqe_tpu_torch.ops import ring as ring_ops
    from mpqe_tpu_torch.tools import dryrun_multichip

    have = torch.cuda.device_count()
    n, where = ((DRYRUN_PARTS, str(device)) if have < 2
                else (min(4, have), "cuda"))
    before = ring_ops.rgcn_ring_halo_rdma.launches
    k3_before = tgt_counters()[2]
    t0 = time.perf_counter()
    out = dryrun_multichip.dryrun_multichip(n, where)
    n8 = ring_ops.rgcn_ring_halo_rdma.launches - before
    k3 = tgt_counters()[2] - k3_before
    log(f"dryrun_multichip ok: mesh={out['mesh']} loss={out['loss']:.4f} "
        f"halo_loss={out['halo_loss']:.4f} k8_err_vs_ring={out['k8_err']:.3e}"
        f" K8 launches {n8}, K3 launches {k3} (sharded and unsharded "
        f"encodes bit-equal); {time.perf_counter() - t0:.2f} s on "
        f"{n} parts: {out['devices']} ({SMI['line']})")
    if n8 == 0 or k3 == 0:
        raise AssertionError(f"dryrun: K8 launches {n8}, K3 launches {k3}")
    return n8, k3


# the last single-card modules (train --trace, the supervisor, reference
# checkpoint import and export, the AM-scale tool, utils/debug.py)
TRACE_ARGS = ["--trace", "5", "--trace_skip", "10"]
# K1's forward and K2's pass A are one template,
# ``tgt_mma_chain_kernel<MT, BWD>`` (csrc/fused_tgt.cu), told apart by BWD
# in the trace's demangled name (or the mangled ``...ILi<MT>ELb<0|1>E``);
# K2's pass B is ``tgt_mma_dw_kernel``, pass C the ``tgt_mma_reduce``
# kernels
TRACE_CHAIN = "tgt_mma_chain_kernel"
TRACE_BWD = (re.compile(r"tgt_mma_chain_kernel<\s*\d+\s*,\s*(true|false)\s*>"),
             re.compile(r"tgt_mma_chain_kernelILi\d+ELb([01])E"))
TRACE_PASSES = (("K1", None), ("K2.A", None), ("K2.B", "tgt_mma_dw_kernel"),
                ("K2.C", "tgt_mma_reduce"))
RESILIENT_STEPS = 40  # after the resume
RESILIENT_VAL = 20  # the first checkpoint, then the kill
IMPORT_QUERIES = 40  # served queries per structure
AM_ARGS = ["--burn_in_steps", "100", "--steps", "100", "--steps_per_call",
           "50", "--train_queries", "100000", "--val_queries", "4096"]
AM_TIMEOUT_S = 600
DEBUG_BATCH = 512


def trace_pass(name: str):
    """Which of K1 / K2.A / K2.B / K2.C a CUDA kernel event is, or None."""
    if TRACE_CHAIN in name:
        for pat in TRACE_BWD:
            m = pat.search(name)
            if m:
                return "K2.A" if m.group(1) in ("true", "1") else "K1"
        raise AssertionError(f"train.trace: no BWD argument in {name!r}")
    for label, sub in TRACE_PASSES[2:]:
        if sub in name:
            return label
    return None


def check_train_trace(records: list, run: str) -> None:
    """``train.trace``: the ``data.npz`` train CLI run's ``--trace 5
    --trace_skip 10`` window (K1/K2): ``trace_start`` at step 10 and
    ``trace_done`` at 15, one Chrome trace under ``<run_dir>/trace``
    whose CUDA kernel events hold, counted apart, K2's pass A, pass B and
    pass C at least once a traced step each and K1's forward in all
    steps but one (every step launches each).  The one: in this long
    process ``torch.profiler`` dropped the device events of the first
    traced step's forward, K1 included, in two runs on the H100 (launch
    order ``ABCC`` then ``FABCC`` four times, with 20 and 320 ms of idle
    pad before the step; PERF.md), which the same window in a process of
    its own did not repeat.  The passes
    are logged in launch order, one letter a launch (F, A, B, C), so
    that a lost event shows where it was."""
    import os

    events = {r["event"]: r for r in records
              if r.get("event") in ("trace_start", "trace_done")}
    files = os.listdir(os.path.join(run, "trace"))
    path = os.path.join(run, "trace", files[0])
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["name"]) for e in trace
                     if e.get("cat") == "kernel")
    passes = [p for p in (trace_pass(k) for _, k in kernels) if p]
    counts = {label: passes.count(label) for label, _ in TRACE_PASSES}
    order = "".join({"K1": "F", "K2.A": "A", "K2.B": "B",
                     "K2.C": "C"}[p] for p in passes)
    names = sorted({k for _, k in kernels if trace_pass(k) in ("K1", "K2.A")})
    window = events["trace_done"]["window"]
    log(f"train.trace: trace_start step {events['trace_start']['step']}, "
        f"trace_done step {events['trace_done']['step']}; {len(files)} "
        f"file, {os.path.getsize(path) / 2**20:.2f} MiB, {len(trace)} "
        f"events, {len(kernels)} CUDA kernel events: {counts} (in launch "
        f"order {order}); window step_ms_p50={window['p50_s'] * 1e3:.3f} "
        f"p95={window['p95_s'] * 1e3:.3f} over {window['steps']} steps; "
        f"{SMI['line']}")
    log(f"train.trace: chain kernel names {names}")
    n = events["trace_done"]["step"] - events["trace_start"]["step"]
    if not (events["trace_start"]["step"] == 10
            and events["trace_done"]["step"] == 15 and len(files) == 1
            and counts["K1"] >= n - 1
            and all(counts[p] >= n for p in ("K2.A", "K2.B", "K2.C"))):
        raise AssertionError(f"train.trace: events {events}, files {files}, "
                             f"kernel events {counts} for {n} steps")


def _children(pid: int) -> list:
    """The running children of ``pid`` (Linux ``/proc``)."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(c) for c in f.read().split()]
    except OSError:
        return []


def phase_resilient(kg_path: str, tmp: str, device) -> None:
    """``resilient``: ``python -m mpqe_tpu_torch.tools.resilient_train`` on
    the train CLI (the card, K1/K2, flagship width, the flagship KG file
    of ``data.npz``: a 10^6-row table and its Adam state in each
    checkpoint), its child SIGKILLed once its first checkpoint exists:
    the relaunch carries ``--resume``, logs ``resumed`` at that
    checkpoint's step and reaches the final step with exit 0.  The
    seconds lost: from the checkpoint to the kill (work thrown away) and
    from the kill to the relaunch's ``resumed`` record (backoff, process
    start, data load, restore), of which the CUDA start, the model's
    init and the restore are from the relaunch's ``data_loaded`` record
    to ``resumed``; the restore's own seconds are in that record."""
    import os
    import signal

    run = os.path.join(tmp, "resilient_run")
    cmd = [sys.executable, "-m", "mpqe_tpu_torch.tools.resilient_train",
           "--backoff", "0.5", "--", "--data", f"npz:{kg_path}", *DATA_CLI,
           "--device", str(device), "--steps", str(RESILIENT_STEPS),
           "--val_every", str(RESILIENT_VAL), "--patience", "1000",
           "--run_dir", run]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    metrics = os.path.join(run, "metrics.jsonl")
    killed_at = None
    try:
        deadline = time.time() + 300
        while killed_at is None:
            if time.time() > deadline or proc.poll() is not None:
                raise AssertionError("resilient: no checkpoint before the "
                                     "run ended")
            # the checkpoint's record is logged once its directory is
            # complete
            saved = os.path.exists(metrics) and any(
                '"event": "checkpoint"' in ln for ln in open(metrics))
            kids = _children(proc.pid)
            if saved and kids:
                os.kill(kids[0], signal.SIGKILL)
                killed_at = time.time()
            time.sleep(0.05)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    ckpts = [r for r in recs if r.get("event") == "checkpoint"
             and r["ts"] <= killed_at]
    resumed = [r for r in recs if r.get("event") == "resumed"]
    loaded = [r for r in recs if r.get("event") == "data_loaded"
              and r["ts"] > killed_at]
    finals = [r for r in recs if "final" in r]
    restarts = err.count("relaunching with --resume")
    ckpt_bytes = (os.path.getsize(os.path.join(ckpts[-1]["path"],
                                               "state.pt"))
                  if ckpts else 0)
    lost_work = killed_at - ckpts[-1]["ts"] if ckpts else float("nan")
    lost_restart = (resumed[0]["ts"] - killed_at if resumed
                    else float("nan"))
    restore = (resumed[0]["ts"] - loaded[0]["ts"] if resumed and loaded
               else float("nan"))
    log(f"resilient: rc={proc.returncode} in {wall:.1f} s, restarts "
        f"{restarts}, killed after the checkpoint at step "
        f"{ckpts[-1]['step'] if ckpts else None} ({ckpt_bytes} bytes, "
        f"{ckpt_bytes / 2**30:.3f} GiB); resumed at step "
        f"{resumed[0]['step'] if resumed else None}; final step "
        f"{finals[-1]['step'] if finals else None}; seconds lost "
        f"{lost_work + lost_restart:.2f} ({lost_work:.2f} of thrown-away "
        f"steps, {lost_restart:.2f} from the kill to the resumed "
        f"restore, of which {restore:.2f} from data_loaded to resumed: "
        f"CUDA start, model init and restore; the restore alone "
        f"{resumed[0]['seconds'] if resumed else float('nan'):.2f}); "
        f"{SMI['line']}")
    for ln in err.splitlines():
        if ln.startswith("[resilient]"):
            log(f"resilient: {ln}")
    if not (proc.returncode == 0 and restarts == 1 and ckpts
            and len(resumed) == 1
            and resumed[0]["step"] == ckpts[-1]["step"]
            and "--resume" in err.split("launching (restart 1)")[-1]
            and finals and finals[-1]["step"]
            == resumed[0]["step"] + RESILIENT_STEPS):
        raise AssertionError(f"resilient: rc={proc.returncode}\n"
                             f"{err[-3000:]}")


def phase_import(kg_path: str, tmp: str, device) -> int:
    """``import``: an upstream-shaped state dict of a random port model at
    the flagship's 10^6 entities and 4 modes (per-mode ``nn.Embedding``
    tables placed through a shuffled ``node_maps`` of a ``graph_data.pkl``,
    ``rgcn.convs.{i}.{root,bias,weight,comp}``, mode embeddings) through
    ``python -m mpqe_tpu_torch.tools.import_torch_checkpoint`` into a run
    dir: every parameter bit-equal to the source model's; the run dir
    served by ``python -m mpqe_tpu_torch.serve --run_dir --answer``
    (K3): ids equal to, and scores within TOL_SCORE of, the source
    model's ``QueryServer``; the run exported by ``export_torch_checkpoint``
    and imported again bit-equal.  Returns K3's launches."""
    import os
    import pickle

    from mpqe_tpu_torch import serve as serve_cli
    from mpqe_tpu_torch.data import loader
    from mpqe_tpu_torch.data import torch_import
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.tools import export_torch_checkpoint as export_cli
    from mpqe_tpu_torch.tools import import_torch_checkpoint as import_cli

    d = os.path.join(tmp, "import_ds")
    os.makedirs(d)
    pkl = os.path.join(d, "graph_data.pkl")
    t0 = time.perf_counter()
    loader.save_graph_pickle(pkl, loader.load_kg_npz(kg_path))
    with open(pkl, "rb") as f:
        rels, adj, node_maps = pickle.load(f)
    rng = np.random.default_rng(0)
    for m in node_maps:
        rng.shuffle(node_maps[m])
    with open(pkl, "wb") as f:
        pickle.dump((rels, adj, node_maps), f)
    del rels, adj
    kg, _, _ = loader.load_graph_pickle(pkl)
    t_prep = time.perf_counter() - t0
    cfg = mpqe_mod.MPQEConfig(n_entities=kg.n_entities, n_modes=kg.n_modes,
                              n_rels=kg.n_rels, embed_dim=128, n_layers=3,
                              num_bases=16)
    gen = torch.Generator(device=device).manual_seed(19)
    src = mpqe_mod.init_mpqe(gen, cfg, device=device)
    with torch.no_grad():
        for lp in src.layers:
            lp.bias.normal_(0.0, 0.1, generator=gen)
    sd = {"mode_embeddings.weight": src.emb.var.detach().cpu()}
    for m in kg.mode_names:
        rows = torch.as_tensor(np.asarray(node_maps[m]), device=device)
        sd[f"enc.features.{m}.weight"] = src.emb.ent[rows].detach().cpu()
    for i, lp in enumerate(src.layers):
        pre = f"rgcn.convs.{i}."
        sd.update({pre + "root": lp.w_self.detach().cpu(),
                   pre + "bias": lp.bias.detach().cpu(),
                   pre + "weight": lp.basis.detach().cpu(),
                   pre + "comp": lp.coeff.detach().cpu()})
    ckpt = os.path.join(tmp, "upstream.pt")
    torch.save(sd, ckpt)
    del sd
    run = os.path.join(tmp, "imported")
    t0 = time.perf_counter()
    lines = run_cli(import_cli.main, ["--ckpt", ckpt, "--out", run, "--data",
                                      f"pkl:{d}", "--device", str(device)],
                    "import.cli")
    t_import = time.perf_counter() - t0
    report = json.loads(lines[-1])

    def bit_equal(model):
        got = dict(model.named_parameters())
        return all(torch.equal(got[n], p) for n, p in src.named_parameters())

    from mpqe_tpu_torch import evaluate as eval_cli

    _, _, restored = eval_cli.restore_model(run, cfg, None, device)
    equal_import = bit_equal(CLI_RESULT.pop("import.cli")) and \
        bit_equal(restored)
    del restored
    sampler = QuerySampler(kg, seed=7)
    flat = [q for s in STRUCTURE_NAMES
            for q in sampler.sample_queries(s, IMPORT_QUERIES, n_neg=1)]
    qpkl = os.path.join(tmp, "import_queries.pkl")
    loader.save_queries_pickle(qpkl, flat)
    grouped = loader.load_queries_pickle(qpkl, kg)
    flat = [q for by_f in grouped.values() for qs in by_f.values()
            for q in qs]
    out = os.path.join(tmp, "import_answers.npz")
    tgt_counters(reset=True)
    t0 = time.perf_counter()
    line = json.loads(run_cli(serve_cli.main, [
        "--run_dir", run, "--answer", qpkl, "--out", out, "--device",
        str(device)], "import serve.cli --answer")[-1])
    t_serve = time.perf_counter() - t0
    n3 = tgt_counters()[2]
    got = np.load(out)
    want = serve_cli.QueryServer(src, cfg, kg.entity_mode,
                                 device=device).answer(flat, k=K)
    same_ids = np.array_equal(got["entity_ids"],
                              np.stack([a.entity_ids for a in want]))
    err = float(np.abs(got["scores"]
                       - np.stack([a.scores for a in want])).max())
    exported = os.path.join(tmp, "exported.pt")
    run_cli(export_cli.main, ["--run_dir", run, "--out", exported,
                              "--device", str(device)], "export.cli")
    again, rep2 = torch_import.import_mpqe_params(
        torch_import.load_state_dict(exported), cfg, torch.Generator(),
        mode_names=kg.mode_names, device=device)
    equal_export = bit_equal(again) and not rep2.missing
    log(f"import: graph_data.pkl ({kg.n_entities} entities, "
        f"{kg.n_modes} modes, shuffled node_maps) {t_prep:.2f} s; "
        f"import.cli {t_import:.2f} s: mapped {report['mapped']}, "
        f"missing {report['missing']}, unused {report['unused_keys']}; "
        f"parameters bit-equal to the source {equal_import}; serve.cli "
        f"--answer {t_serve:.2f} s ({line['queries']} queries, "
        f"{line['queries_per_s']:.1f} queries/s in its answer call, "
        f"hit@{K}={line['hit_at_k']:.4f}), K3 launches {n3}, ids equal "
        f"the source's QueryServer {same_ids}, score_err={err:.3e}; "
        f"export -> import bit-equal {equal_export}; {SMI['line']}")
    if not (equal_import and equal_export and same_ids and err <= TOL_SCORE
            and n3 > 0 and not report["missing"]
            and not report["unused_keys"] and line["queries"] == len(flat)):
        raise AssertionError("import: check failed")
    return n3


def phase_am_scale() -> None:
    """``am_scale``: ``python -m mpqe_tpu_torch.tools.am_scale_quality`` at
    the reference's AM shape (2,000,000 entities, 8 modes, 16 base
    relations, 10,000,000 triples, 3-chain_inter, batch 65,536, 4
    negatives, d = 128, 3 layers, 16 bases) with its depth cut in steps
    and queries only (AM_ARGS): each phase line, the result well formed,
    every loss finite and the burn-in loss falling; each phase's
    seconds, steps/s, APR, AUC and peak memory printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpqe_tpu_torch.tools.am_scale_quality",
         *AM_ARGS], capture_output=True, text=True, timeout=AM_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"am_scale: rc={proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    for ln in lines:
        if ln["phase"] != "result":
            log(f"am_scale: {json.dumps(ln)}")
    res = lines[-1]
    burn = [ln for ln in lines if ln["phase"] == "burn_in"]
    full = [ln for ln in lines if ln["phase"] == "full"]
    losses = [ln["loss"] for ln in burn + full]
    keys = {"phase", "model", "structure", "kg", "entities",
            "directed_edges", "train_queries", "steps", "burn_in_steps",
            "batch", "backend", "apr", "auc_pooled", "val_heldout",
            "peak_mem_bytes"}
    log(f"am_scale: {wall:.1f} s (cut: {' '.join(AM_ARGS)}); result "
        f"{json.dumps(res)}")
    log(f"am_scale: burn_in {burn[-1]['step']} steps in "
        f"{burn[-1]['seconds']:.2f} s ({burn[-1]['step'] / burn[-1]['seconds']:.2f}"
        f" steps/s), full {full[-1]['step']} steps in "
        f"{full[-1]['seconds']:.2f} s "
        f"({full[-1]['step'] / full[-1]['seconds']:.2f} steps/s); APR "
        f"{res['apr']:.3f} AUC {res['auc_pooled']:.4f} on "
        f"{res['val_heldout']} held-out queries; peak "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; burn-in loss "
        f"{burn[0]['loss']:.6f} -> {burn[-1]['loss']:.6f}; {SMI['line']}")
    if not (lines[0]["phase"] == "kg_gen" and res["phase"] == "result"
            and keys <= set(res) and res["entities"] == 2_000_000
            and res["directed_edges"] == 20_000_000
            and res["batch"] == 65_536 and res["backend"] == "cuda"
            and res["val_heldout"] > 0 and 0.0 <= res["apr"] <= 100.0
            and np.isfinite(res["auc_pooled"]) and len(burn) >= 2
            and all(np.isfinite(losses))
            and burn[-1]["loss"] < burn[0]["loss"]):
        raise AssertionError("am_scale: check failed")


def phase_debug(device) -> None:
    """``debug``: one dense train step of the flagship model under
    ``utils/debug.checked`` equal to the same step without it (loss and
    every parameter after the update), then the same step with a NaN in
    the entity row of one of the batch's anchors raising
    ``FloatingPointError`` naming an aten op."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.train import loop as loop_mod
    from mpqe_tpu_torch.utils.debug import checked

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    tc = loop_mod.TrainConfig(lr=0.01, batch_size=DEBUG_BATCH, n_neg=4)
    structure = "3-chain_inter"
    spec = STRUCTURES[structure]
    gen = torch.Generator(device=device).manual_seed(23)
    B, n = DEBUG_BATCH, spec.n_nodes
    ne = torch.randint(0, cfg.n_entities, (B, n), generator=gen,
                       device=device)
    nm = torch.randint(0, cfg.n_modes, (B, n), generator=gen, device=device)
    er = torch.randint(0, cfg.n_rels, (spec.n_edges,), generator=gen,
                       device=device)
    en = torch.ones(spec.n_edges, device=device)
    tgt = torch.randint(0, cfg.n_entities, (B,), generator=gen,
                        device=device)
    negs = torch.randint(0, cfg.n_entities, (B, 4), generator=gen,
                         device=device)
    batch = (ne, nm, er, en, tgt, negs, torch.ones((B, 4), device=device),
             torch.ones(B, device=device))

    def fresh():
        return loop_mod.init_train_state(
            torch.Generator(device=device).manual_seed(0), cfg, tc,
            device=device)

    def step(state):
        fn = loop_mod.make_train_step(cfg, state.optimizer)
        loss = fn(state.model, structure, *batch)
        float(loss)  # waits for the step
        return loss

    plain = fresh()
    t0 = time.perf_counter()
    want = step(plain)
    t_plain = time.perf_counter() - t0
    ck = fresh()
    t0 = time.perf_counter()
    got = checked(step)(ck)
    t_checked = time.perf_counter() - t0
    params = dict(ck.model.named_parameters())
    with torch.no_grad():
        worst = max(float((params[k] - p).abs().max())
                    for k, p in plain.model.named_parameters())
    bit_equal = torch.equal(got, want) and worst == 0.0
    del plain
    bad = fresh()
    with torch.no_grad():
        bad.model.emb.ent[int(ne[0, spec.anchor_slots[0]])] = float("nan")
    try:
        checked(step)(bad)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    # the gate allows the entity gradient's accumulation order
    # (index_put_ with accumulate), which may differ between two plain
    # steps as well
    log(f"debug: the dense {structure} step at B = {B} under checked "
        f"{t_checked:.2f} s (unchecked {t_plain:.3f} s): loss "
        f"{float(got):.6f} vs {float(want):.6f}, parameters max|diff| "
        f"{worst:.3e}, bit-equal {bit_equal}; a NaN entity row raises "
        f"FloatingPointError: {raised!r}; {SMI['line']}")
    if raised is None or "aten." not in raised or worst > 1e-6 or \
            abs(float(got) - float(want)) > 1e-6:
        raise AssertionError("debug: check failed")


# ----------------------------------------------------------------------
# The root tools' ports (mpqe_tpu_torch/tools/), each once through its
# main(argv): the flagship width, a short depth
# ----------------------------------------------------------------------
# every timed loop of the tools cut to (1, 3) iterations, one sample, a
# one-iteration profile; sizes, batches and widths are the tools' own
TOOLS_LOOP = dict(n_small=1, n_large=3, samples=1, profile=1)
MLP_ARM_STEPS = 200
# (tool, argv, [(what a record matches, the keys it must hold)]); every
# record of a tool must match one entry, every entry at least one record
TOOL_RUNS = (
    ("serve_bench", ["--requests", "4", "--http_clients", "2"], [
        ({"phase": "setup"}, ["max_batch", "backend", "device_name"]),
        ({"phase": "warmup"}, ["seconds"]),
        ({"phase": "stream"}, ["batch", "k", "requests", "latency_ms_p50",
                               "latency_ms_p95", "queries_per_s"]),
        ({"phase": "http_stream"}, ["clients", "http_batch", "wall_s",
                                    "requests_per_s", "queries_per_s",
                                    "latency_ms_p50", "latency_ms_p95",
                                    "dispatches", "mean_dispatch_queries",
                                    "errors"])]),
    ("eval_bench", ["--batches", "256"], [
        ({}, ["batch", "ms_per_sweep", "ranked_queries_per_s",
              "scored_candidates_per_s", "device_ms"])]),
    ("e2e_train_bench", ["--dispatches", "1"], [
        ({"phase": "store_build"}, ["seconds", "n_queries"]),
        ({"phase": "pack_only"}, ["seconds_per_batch", "queries_per_s",
                                  "native"]),
        ({"phase": "warmup_dispatch"}, ["seconds"]),
        ({"phase": "steady_state"}, [
            "reuse_batch", "backend", "packer", "dispatches",
            "steps_per_call", "batch", "wall_seconds", "seconds_per_step",
            "end_to_end_queries_per_s", "mean_fetch_wait_s",
            "max_fetch_wait_s", "per_dispatch_s", "device_ms",
            "device_ms_per_step", "busy_share"])]),
    ("step_breakdown", ["--kernel", "fused_fwd", "--adam_probe"], [
        ({"phase": p}, ["ms", "device_ms", "kernels"]) for p in (
            "forward_loss", "loss_plus_grad", "adam_update", "full_step",
            "adam_dense_ent_table", "adam_touched_rows_655k")]),
    ("loss_breakdown", [], [
        ({"phase": p}, ["ms", "device_ms"]) for p in (
            "encode", "gather", "enc_gather", "pos_score", "full_loss")]),
    ("embed_scatter_exp", [], [
        ({"variant": v}, ["ms", "device_ms", "grad_mean_err"])
        for v in ("multi", "fused", "sorted", "dedup")]),
    ("gather_exp", [], [
        ({"case": c}, ["ms", "eff_gbps", "device_ms"]) for c in (
            "d128_float32", "d128_bfloat16", "d256_float32", "d32_float32",
            "d512_float32")]),
    ("bf16_shared_bench", ["--combos", "f32_fused,bf16_shared"], [
        ({"combo": c}, ["dtype", "protocol", "encoder", "n_negatives",
                        "train_step_ms", "train_queries_per_s"])
        for c in ("float32_fused[pallas]", "bfloat16_shared")]),
    ("big_kg_demo", ["--triples", "1000000", "--queries", "100000",
                     "--train_steps", "2"], [
        ({"phase": "kg_gen"}, ["triples", "seconds", "triples_per_s"]),
        ({"phase": "query_sampling"}, ["requested", "sampled_ok", "seconds",
                                       "queries_per_s"]),
        ({"phase": "raw_edge_stores"}, ["edge_queries", "build_seconds",
                                        "pack_batch_seconds",
                                        "pack_queries_per_s", "packer"]),
        ({"phase": "train"}, ["backend", "step_seconds", "queries_per_s"])]),
    ("fused_fwd_bench", ["--variants", "--train_bwd", "--multi"], [
        ({"case": c}, ["ms", "msgs_per_s", "device_ms"]) for c in (
            "xla", "fused", "fused fold", "fused +obf16", "fused fold+obf16",
            "multi xla", "multi fused")] + [
        ({"case": c}, ["ms", "queries_per_s", "device_ms"]) for c in (
            "step dense", "step fused_fwd/xla-bwd",
            "step fused_fwd/pallas-bwd")] + [
        ({"parity": True}, ["batch", "max_rel_err"])]),
    ("fwd_gemm_floor", [], [
        ({"case": c}, ["ms", "device_ms"]) for c in (
            "gemm_chain", "gemm_only", "onehot_build")] + [
        ({"summary": True}, ["gemm_route", "flop", "bf16_peak_bound_ms",
                             "gemm_only_tflop_per_s",
                             "gemm_only_fraction_of_bf16_peak"])]),
    ("kernel_bench", ["--paths", "xla,fused,blocked,blocked_grad"], [
        ({"path": p}, ["ms", "edges_per_s", "n_nodes", "n_edges", "e_pad",
                       "n_rels", "d", "num_bases", "chunk", "device_ms"])
        for p in ("rgcn_sparse_xla", "rgcn_sparse_fused",
                  "rgcn_sparse_blocked_bf16_sb2048_c512",
                  "rgcn_sparse_blocked_bf16_grad")] + [
        ({"agree": a}, ["vs", "ok"]) for a in ("rgcn_sparse_fused",
                                               "K6a_sb2048_c512")] + [
        ({"summary": True}, ["speedup_fused_over_xla", "fused_ms", "xla_ms",
                             "fused_roofline_fraction", "roofline_ms"])]),
    ("scaling_bench", ["--device", "cuda:0"], [
        ({"devices": n}, ["seconds_per_layer", "edges_per_s", "parts_on"])
        for n in (1, 2, 4, 8)] + [
        ({"metric": "halo_rgcn_scaling_efficiency"},
         ["sizes", "edges_per_s", "efficiency", "backend"])]),
    ("scaling_bench", ["--phase", "rank", "--device", "cuda:0"], [
        ({"devices": n}, ["seconds_per_sweep", "ranked_queries_per_s",
                          "parts_on"]) for n in (1, 2, 4, 8)] + [
        ({"metric": "sharded_rank_scaling"},
         ["sizes", "ranked_queries_per_s", "backend"])]),
    ("fused_bwd_diag", [], [
        ({"ok": True}, ["bad", "depth", "k2_vs_f32_mean_max",
                        "k2_vs_plain_mean_max", "f32_wire_vs_f32_mean_max"])]),
    ("kernel_smoke", [], [({"ok": True}, ["checks", "failed", "backend"])]),
    ("mlp_readout_diag", ["--arms", "mlp_id", "--steps",
                          str(MLP_ARM_STEPS), "--train_per_structure", "100",
                          "--val_per_structure", "20"], [
        ({"arm": "mlp_id"}, ["readout", "lr", "val_auc_macro",
                             "val_apr_macro", "train_auc_macro"])]),
)
PROBED_PICKLES = ("graph_data.pkl", "test_queries_3.pkl")


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by the kernels line's id."""
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.ops import sddmm as sd

    k4 = k4_counters()
    return {"K1": ff.fused_tgt_forward, "K2": ff.fused_tgt_backward,
            "K3": ff.fused_tgt_forward_multi, **sparse_counters(),
            "K4a": k4["K4a"], "K4b": k4["K4b"], "K4L": k4["layout"],
            "K7": sd.sddmm_kernel}


def run_tool(name: str, argv: list) -> tuple:
    """``mpqe_tpu_torch.tools.<name>.main(argv)`` in-process: (exit code,
    its JSON records, its other stdout lines, its stderr)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"mpqe_tpu_torch.tools.{name}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    torch.cuda.synchronize()
    records, text = [], []
    for ln in out.getvalue().splitlines():
        if ln.startswith("{"):
            records.append(json.loads(ln))
        else:
            text.append(ln)
    return rc, records, text, err.getvalue()


def tool_record_faults(records: list, expected: list) -> list:
    """What is wrong with a tool's records: an expected record missing, a
    key missing, a record matching no entry, or a time, rate or size
    that is not finite and positive (device fields included: the run is
    on the card)."""
    bad = []
    positive = ("ms", "_s", "seconds", "per_s", "gbps", "_p50", "_p95",
                "_ms_p50")

    def matches(rec, sel):
        return all(rec.get(k) == v for k, v in sel.items())

    for sel, keys in expected:
        hit = [r for r in records if matches(r, sel)]
        if not hit:
            bad.append(f"no record {sel}")
        for r in hit:
            bad += [f"{sel}: no {k}" for k in keys if k not in r]
    for r in records:
        if not any(matches(r, sel) for sel, _ in expected):
            bad.append(f"unexpected record {str(r)[:120]}")
        if r.get("ok") is False or r.get("errors"):
            bad.append(f"failed: {str(r)[:200]}")
        if "max_rel_err" in r and r.get("parity") and \
                not r["max_rel_err"] <= TOL_F32:
            bad.append(f"K1 vs the f32 encoder {r['max_rel_err']}")
        for k, v in r.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if k.endswith(positive) and not (math.isfinite(v) and v > 0):
                bad.append(f"{k}={v}")
    return bad


def phase_tools(data_dir: str) -> dict:
    """Each of the 17 ported tools once through its ``main`` on the card
    (``TOOL_RUNS``; ``probe_pickles`` on ``data.pkl``'s dataset
    directory), their timed loops cut to ``TOOLS_LOOP``: exit code 0,
    every record with the reference's keys and finite positive times,
    and the checks the tools make themselves (the four scatters'
    gradients within 1e-4, K5 and K6a against their plain routes, K2
    under its limits, every ``kernel_smoke`` check).  Returns the tools'
    launches by kernel id."""
    import gc
    import os

    from mpqe_tpu_torch.tools import probe_common

    counters = kernel_counters()
    saved_loop = dict(probe_common.LOOP)
    saved_launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    t_group = time.perf_counter()
    try:
        probe_common.LOOP.update(TOOLS_LOOP)
        for name, argv, expected in TOOL_RUNS:
            t0 = time.perf_counter()
            rc, records, text, err = run_tool(name, argv)
            bad = tool_record_faults(records, expected)
            if rc != 0:
                bad.append(f"exit code {rc}")
            summary = " ".join(f"{k}={v}" for k, v in records[-1].items()
                               if not isinstance(v, (list, dict))
                               )[:400] if records else ""
            line = (f"tools.{name} {' '.join(argv)}: "
                    f"{time.perf_counter() - t0:.2f} s, {len(records)} "
                    f"records; last: {summary}")
            if name == "kernel_smoke":
                line += f"; {sum('OK' in t for t in text)} checks OK"
            if bad:
                for ln in err.splitlines()[-40:] + text[-40:]:
                    log(f"tools.{name}: {ln}")
                log(line + f" FAIL {bad}")
                raise AssertionError(f"tools.{name}: {bad}")
            log(line)
            gc.collect()
            torch.cuda.empty_cache()
        for fname in PROBED_PICKLES:
            path = os.path.join(data_dir, fname)
            rc, _, text, _ = run_tool("probe_pickles", [path])
            checks = [t for t in text if t.startswith("[")]
            ok = rc == 0 and checks and all(t.startswith("[OK ")
                                            for t in checks)
            line = (f"tools.probe_pickles {fname}: {len(checks)} checks, "
                    f"all OK={ok}")
            if not ok:
                log(line + f" FAIL {checks}")
                raise AssertionError(line)
            log(line)
    finally:
        probe_common.LOOP.clear()
        probe_common.LOOP.update(saved_loop)
        got = {k: fn.launches for k, fn in counters.items()}
        for k, fn in counters.items():
            fn.launches = saved_launches[k]
    log(f"tools group {time.perf_counter() - t_group:.1f} s (17 tools, "
        f"{len(TOOL_RUNS) + len(PROBED_PICKLES)} runs); launches {got}")
    missing = [k for k in ("K1", "K2", "K3", "K5a", "K6a", "K6b", "K4a",
                           "K4b", "K4L", "K7") if got[k] == 0]
    if missing:
        raise AssertionError(f"tools: no launch of {missing}")
    return got


def build_kernels() -> None:
    """Build the seven kernel libraries at once (one nvcc each, in
    parallel) and print what ptxas reports of registers and spills."""
    import threading

    from mpqe_tpu_torch.ops import cuda_build
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.ops import sddmm as sd
    from mpqe_tpu_torch.ops import segment_kernels as sk

    errors = []

    def build(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below, in this thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(fn,))
               for fn in (ff._kernel, ff._tgt_kernel, rf._kernel, rb._kernel,
                          sk._kernel, sd._kernel, ring._kernel)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    names = ("fused_multi", "fused_tgt", "rgcn_fused", "rgcn_blocked",
             "segment", "sddmm", "ring")
    log(f"build: {' + '.join(names)} {time.perf_counter() - t0:.2f} s")
    for name in names:
        for ln in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"build: {name}: {ln.strip()}")


def setup_card() -> bool:
    """TF32 off and the card's name and power limit (``SMI``); False
    without a card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    SMI["line"] = smi.splitlines()[0]
    return True


def main_multicard() -> int:
    """``python3 chip_smoke.py --multicard``: only the phases whose meaning
    depends on the count of cards, on the same inputs as the whole run:
    ``train.spmd`` (its ``--shards`` refusal), ``multihost.halo`` and
    ``kernel.ring.multiprocess`` (the one-card pair, whose references the
    groups reuse), the ``multicard`` and ``multinode`` groups and
    ``dryrun``."""
    import os
    import tempfile

    from mpqe_tpu_torch.data.sampler import make_random_kg

    if not setup_card():
        return 1
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build_kernels()
    kg = make_random_kg(**KG)
    train_q, _ = sample_train_queries(kg)
    failed = []

    def run(name, fn, *args):
        try:
            return fn(*args)
        except Exception:  # every phase runs; the exit code says it failed
            import traceback

            log(f"{name} FAILED: {traceback.format_exc()}")
            failed.append(name)

    with tempfile.TemporaryDirectory() as keep:
        run("train.spmd", phase_train_spmd, kg, train_q, device, keep)
        run("multiprocess", phase_multiprocess, device)
        out = run("multicard", phase_multicard, kg, device,
                  os.path.join(keep, "run")) or {"ring": {}}
        nodes = run("multinode", phase_multinode, device) or (0, {})
    run("dryrun", phase_dryrun, device)
    log(f"total {time.perf_counter() - t0:.1f} s; failed: {failed}")
    if failed:
        return 1
    print(json.dumps({"ok": True, "multicard": out["ring"],
                      "multinode": nodes[1],
                      "count": torch.cuda.device_count()}), flush=True)
    return 0


def main() -> int:
    if not setup_card():
        return 1

    from mpqe_tpu_torch.data.sampler import make_random_kg
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(label: str) -> None:
        """Log the seconds since the last lap and since the start."""
        now = time.perf_counter()
        log(f"lap {label}: {now - t_lap[0]:.1f} s (at {now - t_start:.1f} s)")
        t_lap[0] = now

    build_kernels()
    lap("build")

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    gen = torch.Generator(device=device).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=device)
    with torch.no_grad():  # non-zero biases, so the kernel's bias path counts
        for lp in model.layers:
            lp.bias.normal_(0.0, 0.1, generator=gen)
    ops = ff.prepare_fused_multi(model, cfg)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)

    fields = phase_kernel(model, cfg, ops, device, gen, flush)
    fields["variants"] = {"bf16_store": phase_kernel_bf16(
        model, cfg, device, gen, flush)}
    lap("kernel.fused_multi")
    tgt_fields = phase_fused_tgt(model, cfg, device, gen, flush)
    tgt_fields["fwd"]["variants"]["bf16_model"] = phase_fused_tgt_bf16(
        model, cfg, device, gen, flush)
    lap("kernel.fused_tgt")
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops

    full_layer = rgcn_ops.init_rgcn_layer(gen, cfg.embed_dim, cfg.embed_dim,
                                          cfg.n_rels, None, device=device)
    k5_fields = phase_rgcn_fused(model.layers[0], full_layer, cfg, device,
                                 gen, flush)
    t_bf16_kernels = time.perf_counter()
    for kid, fl in phase_rgcn_fused_bf16(model.layers[0], full_layer, cfg,
                                         device, gen, flush).items():
        k5_fields[kid]["variants"] = {"bf16_rows": fl}
    bf16_kernels_s = time.perf_counter() - t_bf16_kernels
    lap("kernel.rgcn_fused")
    k6_fields = phase_rgcn_blocked(model.layers[0], cfg, device, gen, flush)
    t_bf16_kernels = time.perf_counter()
    phase_rgcn_blocked_bf16(model.layers[0], cfg, device, gen)
    bf16_kernels_s += time.perf_counter() - t_bf16_kernels
    del full_layer
    lap("kernel.rgcn_blocked")
    k4_fields = phase_segment(cfg, device, flush)
    k7_launches, k7_fields = phase_sddmm(model, cfg, device, flush)
    lap("kernel.segment, kernel.sddmm")
    k8_launches, k8_fields = phase_ring(model.layers[0], cfg, device, gen,
                                        flush)
    t_bf16_kernels = time.perf_counter()
    k8_launches += phase_ring_bf16(model.layers[0], cfg, device, gen)
    bf16_kernels_s += time.perf_counter() - t_bf16_kernels
    lap("kernel.ring")

    t0 = time.perf_counter()
    kg = make_random_kg(**KG)
    log(f"setup: make_random_kg {time.perf_counter() - t0:.2f} s "
        f"({kg.n_entities} entities, {kg.n_triples} triples)")
    if (kg.n_entities, kg.n_modes, kg.n_rels) != (
            cfg.n_entities, cfg.n_modes, cfg.n_rels):
        raise AssertionError("KG does not match the flagship model")
    launches = phase_serve(model, cfg, ops, kg, device)
    del ops
    lap("serve")
    launches += phase_serve_sharded(model, cfg, kg, device)
    lap("serve.sharded")
    t_host = time.perf_counter()
    http_k3 = phase_serve_http(model, cfg, kg, device)
    launches += http_k3
    host_s = time.perf_counter() - t_host
    lap("serve.http")
    train_q, val_q = sample_train_queries(kg)
    k4_launches = phase_eval_sparse(model, cfg, kg, train_q, val_q, device)
    t_bf16_kernels = time.perf_counter()
    for k, v in phase_eval_sparse_bf16(model, cfg, val_q, device).items():
        k4_launches[k] += v
    bf16_kernels_s += time.perf_counter() - t_bf16_kernels
    rk = phase_eval_ranking(model, cfg, kg, val_q, device)
    lap("eval")
    launches += phase_eval_sharded(model, cfg, kg, val_q, device, rk)
    del model
    lap("eval.sharded")
    k1, k2 = phase_train(kg, train_q, val_q, device)
    lap("train")
    sparse = {}
    for label in SPARSE_RUNS:
        for kid, n in phase_train_sparse(kg, train_q, device, label).items():
            sparse[kid] = sparse.get(kid, 0) + n
    lap("train sparse")
    phase_halo_train(kg, train_q, device)
    lap("halo.train")
    phase_train_cli(["--kernel", "fused_fwd", "--fused_backward", "pallas"],
                    then=lambda d: (phase_eval_cli(d), phase_serve_cli(d)))
    phase_train_cli(["--kernel", "blocked"])
    # K6's wide paths on the train path (16 bases, as every CLI run here)
    phase_train_cli(["--kernel", "blocked", "--embed_dim", "256"])
    phase_train_cli(["--parallel", "halo_ring", "--mesh", "1,1"])
    lap("train.cli")
    t_host = time.perf_counter()
    phase_halo_multistep(device)
    host_s += time.perf_counter() - t_host
    lap("halo.train.multistep")
    import os
    import tempfile

    t_shard = time.perf_counter()
    with tempfile.TemporaryDirectory() as keep:
        launches += phase_train_spmd(kg, train_q, device, keep)
        lap("train.spmd")
        phase_multihost(device)
        lap("multihost")
        k8_launches += phase_multiprocess(device)
        lap("multihost.halo, kernel.ring.multiprocess")
        multicard = phase_multicard(kg, device, os.path.join(keep, "run"))
        lap("multicard")
        k8_nodes, node_figures = phase_multinode(device)
    MP_REFS.clear()
    k8_launches += multicard["K8"] + k8_nodes
    launches += multicard["K3"]
    if multicard["ring"]:
        k8_fields["across_cards"] = multicard["ring"]
    if node_figures:
        k8_fields["across_nodes"] = node_figures
    lap("multinode")
    k8_dry, k3_dry = phase_dryrun(device)
    k8_launches += k8_dry
    launches += k3_dry
    lap("dryrun")
    shard_s = time.perf_counter() - t_shard

    t_gqe = time.perf_counter()
    phase_gqe_train(kg, train_q, val_q, device)
    phase_gqe_variants(kg, train_q, device)
    lap("gqe.train")
    phase_gqe_serve(kg, device)
    phase_gqe_ranking(kg, val_q, device)
    lap("gqe.serve, gqe.eval.ranking")
    phase_train_cli(["--model", "gqe_softand", "--decoder", "bibox",
                     "--bibox_w", "0.5", "--gqe_encoder", "neighborhood"],
                    then=lambda d: (phase_eval_cli(d), phase_serve_cli(d),
                                    check_bibox_w(d)), label="gqe.cli")
    log(f"gqe phases {time.perf_counter() - t_gqe:.1f} s")
    lap("gqe.cli")

    t_data = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_launches = [phase_data_npz(kg, tmp, device)]
        del kg
        lap("data.npz")
        t_single = time.perf_counter()
        import_k3 = phase_import(os.path.join(tmp, "kg.npz"), tmp, device)
        lap("import")
        phase_resilient(os.path.join(tmp, "kg.npz"), tmp, device)
        lap("resilient")
        single_s = time.perf_counter() - t_single
        t_host = time.perf_counter()
        phase_native(tmp)
        lap("native")
        host_launches = [
            phase_train_multistep(os.path.join(tmp, "kg.npz"), tmp, device)]
        lap("train.multistep")
        host_launches.append(phase_train_shared_negs(
            os.path.join(tmp, "kg.npz"), tmp, device))
        lap("train.shared_negs")
        host_data_s = time.perf_counter() - t_host
        host_s += host_data_s
        t_bf16 = time.perf_counter()
        bf16_run, bf16_launches = phase_train_bf16(
            os.path.join(tmp, "kg.npz"), tmp, device)
        bf16_k3 = phase_serve_bf16(bf16_run, device)
        for label in BF16_SPARSE_RUNS:
            for kid, n in phase_train_bf16_sparse(
                    os.path.join(tmp, "kg.npz"), tmp, device, label).items():
                sparse[kid] += n
        bf16_s = time.perf_counter() - t_bf16
        lap("bf16 runs")
        data_launches.append(phase_data_pkl(tmp, device))
        lap("data.pkl")
        bench_s = phase_bench()
        lap("bench")
        data_launches.append((0, 0, phase_quality(tmp, device)))
        lap("quality")
        t_tools = time.perf_counter()
        tools = phase_tools(os.path.join(tmp, "rule"))
        tools_s = time.perf_counter() - t_tools
        lap("tools")
    t_single = time.perf_counter()
    phase_am_scale()
    lap("am_scale")
    phase_debug(device)
    lap("debug")
    single_s += time.perf_counter() - t_single
    data_launches += host_launches
    launches += import_k3 + tools["K3"]
    k1 += tools["K1"]
    k2 += tools["K2"]
    for kid in ("K5a", "K5b", "K6a", "K6b"):
        sparse[kid] += tools[kid]
    for kid, key in (("K4a", "K4a"), ("K4b", "K4b"), ("K4L", "layout")):
        k4_launches[key] += tools[kid]
    k7_launches += tools["K7"]
    k1 += sum(n[0] for n in data_launches) + bf16_launches[0]
    k2 += sum(n[1] for n in data_launches) + bf16_launches[1]
    launches += sum(n[2] for n in data_launches) + bf16_launches[2] + \
        bf16_k3
    log(f"host-path phases {host_s:.1f} s (native, serve.http, "
        f"train.multistep, train.shared_negs, halo.train.multistep); their "
        f"launches (K1, K2, K3): serve.http K3={http_k3}, train.multistep "
        f"{host_launches[0]}, train.shared_negs {host_launches[1]}")
    log(f"single-card module phases {single_s:.1f} s (import, "
        f"resilient, am_scale, debug; train.trace is data.npz's run); "
        f"import's K3 launches {import_k3}")
    log(f"sharded-table phases after the halo runs {shard_s:.1f} s "
        f"(train.spmd, multihost, multicard {multicard['seconds']:.1f} s, "
        "multinode, dryrun)")
    log(f"bench phase {bench_s:.1f} s; bf16 phases {bf16_s:.1f} s (and "
        f"the bf16 kernel and evaluate checks {bf16_kernels_s:.1f} s); data "
        f"phases {time.perf_counter() - t_data - bench_s - bf16_s - host_data_s:.1f}"
        " s; "
        f"their launches (K1, K2, K3): npz {data_launches[0]}, pkl "
        f"{data_launches[1]}, quality {data_launches[2]}, train.bf16 "
        f"{bf16_launches}, serve.bf16 K3={bf16_k3}")
    log(f"tools group {tools_s:.1f} s; its launches {tools}")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "fused_tgt_forward_multi",
        "route": "cuda",
        "source": "mpqe_tpu_torch/csrc/fused_multi.cu",
        "replaces": "mpqe_tpu/ops/pallas_fused_fwd.py:335",
        "launches": launches,
        **fields,
    }]
    for name, line, n, kind in (
            ("tgt_mma_forward", 704, k1, "fwd"),
            ("tgt_mma_backward", 569, k2, "bwd")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpqe_tpu_torch/csrc/fused_tgt.cu",
            "replaces": f"mpqe_tpu/ops/pallas_fused_fwd.py:{line}",
            "launches": n,
            **tgt_fields[kind],
        })
    for kid, name, source, line, fl in (
            ("K5a", "rgcn_messages_basis", "rgcn_fused.cu",
             "pallas_rgcn.py:145", k5_fields),
            ("K5b", "rgcn_messages_wrel", "rgcn_fused.cu",
             "pallas_rgcn.py:193", k5_fields),
            ("K6a", "rgcn_messages_blocked", "rgcn_blocked.cu",
             "pallas_rgcn_blocked.py:253", k6_fields),
            ("K6b", "rgcn_grad_blocked", "rgcn_blocked.cu",
             "pallas_rgcn_blocked.py:384", k6_fields)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mpqe_tpu_torch/csrc/{source}",
            "replaces": f"mpqe_tpu/ops/{line}",
            "launches": sparse[kid],
            **fl[kid],
        })
    for kid, name, source, line, n, fl in (
            ("K4a", "segment_sum", "segment.cu", "pallas_segment.py:56",
             k4_launches["K4a"], k4_fields["K4a"]),
            ("K4b", "segment_max", "segment.cu", "pallas_segment.py:120",
             k4_launches["K4b"], k4_fields["K4b"]),
            # the first half of K4a's and K4b's port: the TPU kernels need
            # no layout (a one-hot matmul per chunk of rows)
            ("K4L", "segment_layout", "segment.cu", "pallas_segment.py:56",
             k4_launches["layout"], k4_fields["layout"]),
            ("K7", "sddmm", "sddmm.cu", "pallas_sddmm.py:48", k7_launches,
             k7_fields),
            ("K8", "rgcn_ring_halo", "ring.cu", "pallas_ring.py:159",
             k8_launches, dict(k8_fields, library_calls=(
                 "several: torch.bmm and index_add_ per hop")))):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mpqe_tpu_torch/csrc/{source}",
            "replaces": f"mpqe_tpu/ops/{line}",
            "launches": n,
            **fl,
        })
    log(f"kernels: {[k['name'] for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multiprocess-worker"]:
        sys.exit(multiprocess_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--multinode-worker"]:  # under torchrun
        sys.exit(multiprocess_worker("env", "env", sys.argv[2], "nccl",
                                     *sys.argv[3:]))
    if sys.argv[1:2] == ["--multicard"]:
        sys.exit(main_multicard())
    sys.exit(main())
