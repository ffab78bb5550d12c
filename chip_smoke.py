"""Drive collie_tpu_torch's serving and training paths on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA card (written
for the H100):

    python3 chip_smoke.py [--seed N]

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero before the result line:

1. device: card name and power limit, TF32 switched off for matmuls and cuDNN;
2. build: every CUDA kernel of the paths, compiled from
   ``collie_tpu_torch/csrc`` (one nvcc per source, all started together);
3. kernels: ``topk_tile`` against its plain PyTorch version at the edge
   shapes of the JAX package's tests, at edge shapes of its own tiling
   (``TOPK_EDGES``: its per-range candidates against the plain version at
   the launch plan's range width, then the merged top-k), a tie case (ids,
   scores and candidates exactly equal) and the serving shape, whose launch
   plans at k = 1, 10, 128 it prints; ``topk_select`` (``stable_topk`` on the
   card) against the full stable sort, values and indices bit for bit
   (``SELECT_*``: row counts, row lengths, k up to whole rows, ties, signed
   zeros, infinities, NaN, float16 and bfloat16), then ``SELECT_REQUESTS``
   dense ``recommend`` requests at the serving cell's shape, one selection
   each and no other kernel, timed beside the sort and ``torch.topk``.
   From here every phase that serves (``recommend``, also under a mesh)
   holds its selections to ``recommend_selections``; the kernels line's
   ``launches`` for ``topk_select`` are those of the serving phases;
   ``fused_mf_epoch`` against its plain version at edge shapes (every loss
   kind, metadata, weight decay, K=1, duplicate ids, B not a power of two)
   and at the ML-10M training shape after 3 steps and after one full
   epoch of the engine's real batches; ``fused_mf_explicit_epoch`` against
   its plain version at edge shapes (MSE and MAE, ``y_range``, weight decay,
   duplicate ids, a masked pad tail, B = 1, D up to 256) and at the explicit
   ML-10M shape after 3 steps and after one whole epoch as one call; at
   the ML-10M shapes, two launches of one whole epoch from one state at lr
   0.1, implicit and explicit, bit for bit (the kernels' fixed-point
   sums, ``check_repeatable``); times
   for each kernel, its plain version and (where one exists) one library
   call of the same function, and for the explicit kernel the generic
   autograd epoch (``fused=False``) beside it.  For one ML-10M and one
   gate-config epoch call of each epoch kernel: the device launches and
   kernel times ``torch.profiler`` sees, and the step and update phases
   inside the one launch (device clock stamps).  ``binned_gather_scatter``
   (the microbench's ``pk``) at the microbench's shapes (bins in the
   clusters' shared memory) against its plain version and ``index_select`` +
   ``index_add_``, and at ``GS_OVERSIZE`` (bins too large for a cluster,
   rows in device memory) against its plain version;
4. serving: an MF model at the repo's serving scale (2,000,000 items,
   ``embedding_dim=64``, random weights from the seed) is built from seeded
   interactions, saved to npz and loaded back, then answers four
   ``recommend`` requests of 256 users without seen filtering (the kernel
   path, shown by the launch counter) and two with it (the blockwise path),
   each checked against a dense stable top-k, and runs
   ``evaluate_in_batches`` on 2,048 test users;
5. training: (a) the quality-gate configuration of ``bench.py`` (943 users
   x 1,682 items, ``embedding_dim=10``, batch 1,024, adaptive hinge, K=10)
   fit for 10 epochs through ``CollieTrainer``, whose ``evaluate_in_batches``
   MAP@10, MRR and AUC must clear ``benchmarks/gates.json``; (b) the
   ML-10M-scale configuration of ``benchmarks/bench_ml10m_scale.py`` (72,000
   users x 10,000 items, 10M generated interactions, 90/5/5 split,
   ``embedding_dim=32``, batch 65,536) fit for 3 epochs, with examples/s,
   each epoch's time split into epoch building and kernel, peak memory, and
   a trained-beats-untrained MAP@10 check.  The fused kernel's launch
   counter must equal the epochs the two fits ran.  Explicit ratings: (c)
   the explicit quality-gate configuration of
   ``benchmarks/calibrate_gates.py:84-97`` (943 x 1,682 generated ratings,
   ``embedding_dim=10``, lr 0.01, MSE, ``y_range=(1, 5)``, batch 1,024) fit
   for 10 epochs, whose ``explicit_evaluate_in_batches`` test MSE must clear
   ``benchmarks/gates.json``; (d) the ML-10M-scale data with its ratings
   kept (72,000 x 10,000, 10M generated ratings, 90/5/5 split,
   ``embedding_dim=32``, batch 65,536, MSE, ``y_range=(1, 5)``) fit for 3
   epochs, with examples/s, the epoch split, peak memory and a
   trained-beats-untrained test MSE check.  The explicit kernel's launch
   counter must equal the epochs of (c) and (d);
6. zoo: the single-stage model zoo and embedding dropout at the
   configuration of ``benchmarks/bench_zoo_scale.py`` (20,000 users x
   10,000 items, 1M generated interactions, 90/5/5 split, ``embedding_dim``
   32, batch 8,192, K=10): MLP-MF, Nonlinear-MF, NeuMF, DeepFM, CML and MF
   with ``dropout_p=0.05``, each fit for 3 epochs on the card (examples/s per
   epoch beside the card's name and power limit, finite losses), evaluated
   before and after (test AUC must rise), and asked for one ``recommend`` of
   256 users whose ids must equal a stable top-k of ``score_item_block``
   over the whole catalog; one more epoch of MF with dropout and of NeuMF
   runs under ``torch.profiler`` (device launches, busy time and span).
   No kernel launches on this path;
7. multi_stage: the multi-stage models on the same data at the same
   benchmark's configuration (item metadata of 32 normal columns, buckets
   ``arange % 200``, ``embedding_dim`` 32): HybridModel fit for one epoch
   in ``matrix_factorization``, one in ``metadata_only`` and 3 in ``all``;
   HybridPretrainedModel on an MF donor fit for one epoch through
   ``fused_mf_epoch`` on the card, then 3 epochs with the embeddings frozen;
   ColdStartModel one epoch in ``item_buckets`` and 3 in ``no_buckets``.
   Examples/s per epoch and stage beside the card, finite losses, test AUC
   rising over each fit, the tables each stage gates out bitwise unchanged,
   ColdStart's per-item tables equal to the gathered bucket rows just after
   ``advance_stage``, the donor unchanged by the hybrid's fit, one blockwise
   ``recommend`` held against a full-catalog top-k, a save and load on the
   card (final stage, equal scores); one more Hybrid epoch runs under
   ``torch.profiler``.  ``fused_mf_epoch``'s launch count over the phase
   must equal the donor's epochs and no other kernel may launch;
8. trainer (run after phase 5, on its ML-10M-scale data): (a) the
   bucketed and CSR sampler tables on the card (bytes of each), the
   bucketed ones from the device builder and equal to its build on the
   CPU; on one epoch's per-position uniforms the CSR negatives equal a
   numpy host reference on ``SAMPLER_HOST_CHECKS`` positions, and neither
   sampler's negatives hold a positive; the CSR pass timed (CUDA events,
   median of 5) beside the bucketed one; the bucketed sampler's kernel
   (``csrc/bucketed_sample.cu``) equal to its plain version on one epoch's
   grouped uniforms (K = 10, one dedup round), one launch, both timed
   beside the kernel's bytes bound; (b) a 3-epoch fit with
   ``COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB=0`` (``auto`` takes the CSR
   sampler) through ``fused_mf_epoch``, whose MAP@10 on the 5,000 test
   users must reach 0.85x phase 5(b)'s; (c) a 3-epoch fit with the
   approximate loader, whose MAP@10 must beat the untrained model's; (d)
   the ML-10M-scale fit for 5 epochs with a checkpoint each epoch, and a
   fresh model and trainer resumed from its epoch-3 file for 2 more
   (``RESUME_EPOCHS``, ``RESUME_FROM``); the explicit gate configuration
   for 10, resumed from epoch 5 for 5 more:
   each checkpoint holds the live state bit for bit, the first resumed
   epoch equals the uninterrupted fit's (``compare_epoch``), counters and
   schedulers match, final MAP@10 / test MSE within 5%; (e)
   ``CollieMinimalTrainer(epoch_mode='step')`` for one epoch of the gate
   configuration on the card, on the CPU from the same params and loader
   seed, and on the card through a ``PrefetchLoader`` (params and per-step
   losses within ``STEP_RTOL``; no kernel launches); (f) a momentum-SGD
   optimizer factory at the gate configuration for 2 epochs (the generic
   epoch; the train loss falls).  Over the phase ``fused_mf_epoch`` must
   launch 3 + 3 + 5 + 2 times, ``fused_mf_explicit_epoch`` 15, the bucketed
   sampler kernel (a)'s 14 + 5 + 2 + 2, the others 0 but the cycle-walk
   (every scan-mode epoch shuffles through it).  From phase 5 on, every
   phase that fits through the bucketed sampler holds the sampler kernel's
   launches to one for each epoch drawn (``SAMPLER_WRAPPER``);
9. whole_fit (``phase_whole_fit``; every fit above already took the whole
   fit, ``CollieTrainer``'s default, unless it checkpoints or steps): (a)
   the Feistel cycle-walk kernel (``csrc/shuffle.cu``) against its plain
   version bit for bit at ``SHUFFLE_SIZES`` under ``SHUFFLE_KEY_SETS``,
   timed with its plain version at the two ML-10M sizes; (b) each epoch
   kernel launched with ``live = 0``: tables, biases, moments and count
   bit-identical, NaN losses; (c) the gate configuration (10 epochs, the
   default plateau scheduler) and the ML-10M-scale configuration (3
   epochs) fit with ``torch.cuda.set_sync_debug_mode('error')`` around
   every flight (``trainer.flight_guard``), so any host sync inside a
   flight raises; (d) whole fit against the per-epoch loop
   (``COLLIE_TPU_WHOLE_FIT=0``) from the same initial params and seed: the
   implicit gate configuration (at ``WHOLE_FIT_PAIR_LR``) and the explicit
   one, the implicit one under a plateau that cuts every epoch after the
   first, and one that early-stops inside a flight
   (``early_stopping_patience=1``, a val loader, frozen learning rates):
   ``ran`` mask, learning-rate trajectory, best epoch and epochs completed
   equal, per-epoch train losses within ``WHOLE_FIT_LOSS_RTOL``; (e)
   whole-fit and per-epoch examples/s of the gate, explicit gate and ML-10M
   fits, the ML-10M epoch split with the shuffle kernel, and the explicit
   whole fit's test MSE against ``benchmarks/gates.json`` (phase 5(a) holds
   the implicit gate whole fit, at lr 0.1, to its gates).  ``fused_mf_epoch`` and
   ``fused_mf_explicit_epoch`` must launch in the whole fits;
10. generic_epoch (``phase_generic_epoch``): ``calculate_loss``'s sparse
   forms, the bfloat16 selection and the fused table layout on the generic
   epoch (``fused=False``): (a) at the ML-10M-scale configuration one epoch
   from one state on the same batches in four states (``GENERIC_STATES``:
   dense + named, the reference; sparse-f32 + named; sparse-f32 + fused;
   sparse-bf16 + fused, the default); the sparse form held to the dense
   one and the fused layout to the named one at every step, from the
   reference trajectory's state, as the constants' comment says; each
   epoch's mean loss; the first step's bfloat16 selections held to the
   float32 scores' rounding bound; (b) at
   ``benchmarks/bench_zoo_scale.py``'s configuration MLP-MF, Nonlinear-MF,
   NeuMF, DeepFM (adaptive loss, no dropout), ColdStart in both stages and
   MF with WARP, sparse-f32 (+ fused where the model has the layout) held
   to dense + named in the same way; (c) a NeuMF whole fit with
   ``set_sync_debug_mode('error')``
   around every flight; (d) no epoch kernel launched, the cycle-walk at
   least once an epoch; (e) examples/s an epoch, device launches a step
   and the card's busy share (``torch.profiler``) of each state, beside the
   card's name and power limit;
11. out_of_core (``phase_out_of_core``): the out-of-core HDF5 tier at
   ``benchmarks/bench_outofcore.py``'s configuration (2,000,000
   interactions of ``make_data(default_rng(0))``, 40,000 users x 8,000
   items, ``HDF5InteractionsDataLoader(batch_size=8192, shuffle=True,
   num_negative_samples=10, seed=0)``, MF with ``embedding_dim`` 32, lr
   1e-3, adaptive hinge, ``COLLIE_TPU_HDF5_CHUNK_STEPS=64``).  The store
   is a real HDF5 file when ``h5py`` imports, else an in-memory stand-in
   serving the same ``read_chunk`` (the line says which).  (a) the chunk
   tier runs, in chunks of 64, 64, 64, 32, 16, 4, 1 steps, with one
   cycle-walk launch a chunk and no ``fused_mf_epoch`` launch; (b) epoch
   1's first chunk on the card equals the same chunk on the CPU from the
   same params on the same draws; (c) every chunk loop of the timed epochs
   runs with every host sync an error (``trainer.flight_guard``); (d)
   examples/s an epoch (median of 3 after a warm-up) of the benchmark's
   four labels, ``hdf5_chunk``, ``hdf5_step``, ``hdf5_prefetch`` and
   ``in_memory``, beside the card's name and power limit; (e) the chunk
   tier's train loss falls;
12. movielens (``phase_movielens``, last before the kernels line): the
   periphery.  ML-100K-format files of the synthetic stand-ins (943 x 1,682,
   100,000 ratings) in a temporary ``DATA_PATH``, the download replaced by
   one that raises; (a) the readers' frames equal the frames written, then
   ``run_movielens_example()`` at its defaults (MF, D = 10, dropout 0.05,
   up to 20 epochs with early stopping) on the card with an ``EpochTimer``
   as the fit's logger: the model on ``cuda``, the train loss falling, test
   AUC above 0.5 (printed beside collie_tpu's on the same files on the CPU,
   ``JAX_ML100K_CPU``), the saved npz reloading, the cycle-walk launched
   and no other kernel; (b) the timer's summary; (c)
   ``get_recommendation_visualizations`` of the fitted model equal, as
   HTML, to the same call on a CPU copy of its params; (d) one epoch under
   ``training.profiler.trace`` whose trace names a CUDA kernel and the
   ``annotate``d region, and ``device_memory_stats()``'s peak;
13. mesh (``phase_mesh``, run right after phase 4 on its model): a
   ``torch.distributed`` NCCL group of world size 1 (``file://`` rendezvous
   in a temporary directory) and ``make_mesh(data=1, model=1)`` on the card;
   ``recommend(..., mesh=)`` (``MESH_REQUESTS``: three requests of 256 users
   without seen filtering, the local-table tier's kernel path, whose
   top-k launches are counted, and one with it) equal to ``recommend(...)``
   in ids, scores within ``RTOL``/``ATOL``; ``evaluate_in_batches(...,
   mesh=)`` equal to the single-device values within rtol 1e-5.  NCCL
   takes one rank a card, so world sizes above 1 are held on the CPU only
   (``tests/test_torch_parallel_serving.py``, gloo);
14. mesh_training (``phase_mesh_training``, last before the kernels line):
   the parallel tier's training half at the ML-10M-scale configuration on
   ``make_mesh(data=1, model=1)`` over NCCL (world size 1, after a
   one-epoch warm-up fit): (a) the whole fit through the mesh against the
   single-card generic fit (``COLLIE_TPU_FUSED_EPOCH=0``, the same seed):
   epochs, learning-rate changes, best epoch equal, train losses within
   ``WHOLE_FIT_LOSS_RTOL``, examples/s both ways, one cycle-walk launch an
   epoch and no epoch kernel; (b) a per-epoch mesh fit with a
   ``checkpoint_dir`` writes ``.shards`` directories, and its epoch-2
   checkpoint resumed to epoch 3 on the mesh and on one card equals (a)'s
   third epoch; (c) the model as (a) left it, holding its shards, answers
   ``MESH_TRAIN_REQUESTS`` ``recommend(mesh=)`` requests through the top-k
   kernel (one launch each; ids equal the single-card calls) and
   ``evaluate_in_batches(mesh=)`` (within rtol 1e-5 of one card); (d) mesh
   steps held to single-card steps from one state (``MESH_TRAIN``
   comment) and one mesh step's collectives, counted by kind.
   ``tools/mesh_training.py`` runs the configuration across the cards of
   one host;
15. the kernels line (one JSON object, seven kernels: the sampler kernel's
   launches are those of every phase, its times 8(a)'s), the card's name and
   power limit, and as the last line ``{"ok": true, "device": {...}}``.

``--epoch-times`` runs phases 1-2 and times one epoch call of each epoch
kernel at the gate and ML-10M-scale configurations; ``--kernel-times`` runs
phases 1-2 and times the top-k kernel at the serving shape (k = 1, 10, 128;
the launch alone and the whole ``mf_topk_retrieve``), the binned
gather/scatter's 50 rounds and the selection at the serving cell's request,
each with one ``torch.profiler`` look;
``--generic-times`` runs phases 1-2 and phase 10 (the generic epoch).  All
three are for comparing two checkouts on one card: a copy of this script in
the other checkout times that checkout.
"""
import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) used for the
# bound: FP32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

RTOL = 1e-5
ATOL = 1e-5
DEVICE = 'cuda'

NUM_USERS = 100_000
NUM_ITEMS = 2_000_000            # benchmarks/retrieval_results.json catalog_2000000
EMBEDDING_DIM = 64
NUM_INTERACTIONS = 5_000_000
REQUEST_USERS = 256
EVAL_USERS = 2_048
K = 10

# training: the quality-gate configuration of bench.py:24-49 and the
# ML-10M-scale configuration of benchmarks/bench_ml10m_scale.py:34-72
GATE_DATA = dict(num_users=943, num_items=1682, num_interactions=100_000,
                 num_negative_samples=10, seed=42)
GATE_EPOCHS = 10
ML10M_DATA = dict(num_users=72_000, num_items=10_000, num_interactions=10_000_000,
                  num_negative_samples=10, affinity_bias=3.0, seed=7)
ML10M_BATCH = 65_536
ML10M_DIM = 32
ML10M_EPOCHS = 3
ML10M_EVAL_USERS = 5_000
SPLIT = ('shuffle_ms', 'sample_ms', 'train_ms')     # CollieTrainer.epoch_log
# explicit ratings: the explicit gate configuration of
# benchmarks/calibrate_gates.py:84-97, and the ML-10M-scale data of
# benchmarks/bench_ml10m_scale.py:59-64 with its ratings kept
EXPLICIT_GATE_DATA = dict(num_users=943, num_items=1682, seed=42)
EXPLICIT_LR = 1e-2
Y_RANGE = (1, 5)
# the single-stage zoo at the configuration of benchmarks/bench_zoo_scale.py:
# data and split (:36-43, :93-99), each model's settings (:122-139), and MF
# with embedding dropout; fit for ZOO_EPOCHS where the benchmark times 3
# epochs after a warm-up fit
ZOO_DATA = dict(num_users=20_000, num_items=10_000, num_interactions=1_000_000,
                num_negative_samples=10, affinity_bias=3.0, seed=7)
ZOO_BATCH = 8192
ZOO_DIM = 32
ZOO_EPOCHS = 3
ZOO_MODELS = [
    ('MatrixFactorizationModel', dict(embedding_dim=ZOO_DIM, dropout_p=0.05, lr=1e-1,
                                      loss='adaptive')),
    ('MLPMatrixFactorizationModel', dict(embedding_dim=ZOO_DIM, num_layers=2, lr=1e-2,
                                         loss='adaptive')),
    ('NonlinearMatrixFactorizationModel', dict(
        user_embedding_dim=ZOO_DIM, item_embedding_dim=ZOO_DIM,
        user_dense_layers_dims=[ZOO_DIM, ZOO_DIM], item_dense_layers_dims=[ZOO_DIM, ZOO_DIM],
        lr=1e-2, loss='adaptive')),
    ('NeuralCollaborativeFiltering', dict(embedding_dim=ZOO_DIM, num_layers=2, lr=1e-2,
                                          loss='adaptive')),
    ('DeepFM', dict(embedding_dim=ZOO_DIM, num_layers=2, lr=1e-2, loss='adaptive')),
    ('CollaborativeMetricLearningModel', dict(embedding_dim=ZOO_DIM, lr=1e-2, loss='hinge')),
]
# models of which one more epoch runs under torch.profiler after the checks
ZOO_PROFILED = ('MatrixFactorizationModel', 'NeuralCollaborativeFiltering')
# the multi-stage models at the same configuration
# (benchmarks/bench_zoo_scale.py): item metadata of META_COLS normal columns
# from default_rng(0) (:116-118), buckets arange % 200 (:120), the MF donor
# fit for one epoch (:122-128) and each model's settings (:150-160; lr 0.1
# for both of ColdStart's stages), fit for (stage, epochs) as listed
MULTI_STAGE_META_COLS = 32
MULTI_STAGE_BUCKETS = 200
MULTI_STAGE_DONOR_EPOCHS = 1
MULTI_STAGE_MODELS = [
    ('HybridModel', dict(embedding_dim=ZOO_DIM, combined_layers_dims=[ZOO_DIM, 16], lr=1e-1,
                         loss='adaptive'),
     [('matrix_factorization', 1), ('metadata_only', 1), ('all', ZOO_EPOCHS)]),
    ('HybridPretrainedModel', dict(combined_layers_dims=[ZOO_DIM, 16], lr=1e-2,
                                   loss='adaptive'),
     [(None, ZOO_EPOCHS)]),
    ('ColdStartModel', dict(embedding_dim=ZOO_DIM, item_buckets_stage_lr=1e-1,
                            no_buckets_stage_lr=1e-1, loss='adaptive'),
     [('item_buckets', 1), ('no_buckets', ZOO_EPOCHS)]),
]

# the trainer phase: positions of one ML-10M-scale epoch whose CSR negatives
# are held to a numpy host reference; the per-step path on the card against
# the CPU (params within STEP_RTOL * |cpu| + STEP_ATOL_SCALE * max|cpu|,
# per-step losses within STEP_RTOL); the learning rate of the momentum-SGD
# factory at the gate configuration
SAMPLER_HOST_CHECKS = 4096
# checkpoint/resume of the ML-10M-scale fit: RESUME_EPOCHS uninterrupted, and
# a fresh model and trainer resumed from the RESUME_FROM checkpoint.  The
# epoch held is the first after the plateau's lr cut (lr 0.1 -> 0.01 at the
# end of epoch 3: the train loss rises over epochs 2-3).  Both launches of
# that epoch start from one state, and the epoch kernels' fixed-point sums
# make them repeat bit for bit
RESUME_EPOCHS = 5
RESUME_FROM = 3
STEP_RTOL = 1e-3
STEP_ATOL_SCALE = 1e-5
CUSTOM_SGD_LR = 1.0

# fused_mf_epoch against its plain version: tables and moments within
# EPOCH_RTOL * |ref| + EPOCH_ATOL_SCALE * max|ref| per tensor (the kernel
# sums duplicate ids exactly in 64-bit fixed point and rounds once, the
# plain version sums them in float32 in its own order), per-step losses
# within EPOCH_RTOL.  At the ML-10M shape a rounding-level score difference can
# flip an example's hardest-negative choice, which moves that example's
# rows by an Adam step; there at most MAX_FLIPPED_FRACTION of each tensor's
# elements may fall outside the tolerance.
EPOCH_RTOL = 1e-4
EPOCH_ATOL_SCALE = 1e-5
MAX_FLIPPED_FRACTION = 1e-3
# fused_mf_explicit_epoch at the explicit ML-10M shape: a popular item's row
# sums ~7 examples a step, in fixed point in the kernel and in float32 in
# the plain version, and its near-zero elements carry that (in-tolerance)
# absolute difference as a large relative one into the gradients of the
# users who rated it; where such a gradient is near Adam's eps (1e-8) the
# step direction amplifies it.  So over several steps at most
# EXPLICIT_DRIFT_FRACTION of each tensor's elements may fall outside the
# tolerance; one step from the same state must hold exactly.  Two launches
# of the kernel from one state give the same bits (check_repeatable).
EXPLICIT_DRIFT_FRACTION = 1e-4
# binned_gather_scatter at the shapes of benchmarks/microbench_gather.py:35-39
# and :149 (PITERS): out within GS_ATOL_SCALE * max|plain| (atomics sum a
# round's duplicate ids in a run-dependent order, 50 rounds deep); gathered
# within GS_ATOL_SCALE * (kept examples) * max|plain out| (each round's sum
# of ~8,000 rows taken in another order)
GS_SHAPE = dict(U=72_000, D=32, B=8192, n_bins=16, c_pad=768, iters=50)
GS_ATOL_SCALE = 1e-5
# the same table in 4 bins of 18,048 rows (2.3 MB a bin, more than the shared
# memory of a cluster of 8): the kernel keeps those rows in device memory
GS_OVERSIZE = dict(U=72_000, D=32, B=8192, n_bins=4, c_pad=2560, iters=50)
# topk_tile edge shapes (B, D, k, num_items) for the kernel's tiling: every
# row layout of the 32-dim stages (D = 1, 3, 65: 4-byte loads; 12, 64, 256:
# 16-byte), one and several user chunks, k of one, several and four list
# registers, a last range holding fewer than k items (611 = 4 x 128 + 99),
# and catalogs smaller than one 128-item tile
TOPK_EDGES = [(B, D, k, 611) for (D, k), B in zip(
    [(D, k) for D in (1, 3, 12, 64, 65, 256) for k in (1, 10, 128)], (1, 37, 256, 300) * 5)]
TOPK_EDGES += [(37, 12, 10, 100), (5, 64, 100, 100), (300, 65, 128, 128)]
# the selection kernel (csrc/topk_select.cu) is held bit for bit against the
# stable sort, values and indices: row counts, row lengths (k itself, 1,000
# and 4,106 of one segment, the serving cell's 384,546 of several) and k;
# then ties, signed zeros, infinities and NaN of both signs and payloads
# (SELECT_SPECIAL_BITS, each row holding several of each) and layouts; then
# k past one block's buffer (SELECT_LARGE: rows, length, k; one segment a
# row, several rounds under a ceiling, a last round of several segments) and
# the 16-bit floats with their own special patterns.  The serving cell's
# request (SELECT_SHAPE: rows, length, k) is timed and served through
# ``recommend`` (SELECT_REQUESTS requests)
SELECT_ROWS = (1, 128, 513)
SELECT_LENGTHS = ('k', 1000, 4106, 384_546)
SELECT_KS = (1, 10, 128)
SELECT_LARGE = [(16, 384_546, 129), (8, 384_546, 1000), (4, 100_000, 1025), (128, 4106, 500),
                (2, 384_546, 7677), (2, 384_546, 7678), (2, 384_546, 7977),
                (3, 50_000, 20_000), (1, 30_000, 30_000)]
SELECT_SHAPE = (128, 384_546, 10)
SELECT_TIMED_KS = (1, 10, 128, 1000, 8000)
SELECT_REQUESTS = 3
SELECT_SPECIAL_BITS = (0x7fc00000, 0xffc00000, 0x7f800001, 0xff800001, 0x7fffffff, 0xffffffff,
                       0x7fa00000, 0xffa00000, 0x7f800000, 0xff800000, 0x00000000, 0x80000000,
                       0x3f800000, 0xbf800000)
SELECT_SPECIAL_BITS_16 = {
    'float16': (0x7e00, 0xfe00, 0x7c01, 0xfc01, 0x7fff, 0xffff, 0x7d00, 0xfd00, 0x7c00, 0xfc00,
                0x0000, 0x8000, 0x3c00, 0xbc00),
    'bfloat16': (0x7fc0, 0xffc0, 0x7f81, 0xff81, 0x7fff, 0xffff, 0x7fa0, 0xffa0, 0x7f80, 0xff80,
                 0x0000, 0x8000, 0x3f80, 0xbf80)}
# the whole_fit phase: the cycle-walk kernel is held bit for bit against its
# plain version at these sizes (2 and 3: the smallest Feistel domain; 1,024
# and 1,025: a power of two and one past it; the ML-10M implicit and explicit
# train sets) under each key set (the smallest and largest keys drawn, and
# a mixed set); whole fits against the per-epoch loop: per-epoch train
# losses within WHOLE_FIT_LOSS_RTOL (stated before the first run on the
# card, when the epoch kernels' sums depended on the order of their
# atomics), everything else equal.  The
# implicit gate fits compared run at WHOLE_FIT_PAIR_LR: at the gate's lr 0.1
# two fits whose updates differ at rounding level part by up to 8% within 10
# epochs (hardest-negative choices flip; seen on the CPU, where the order of
# threads plays the atomics' part), at 0.03 by 2e-5
SHUFFLE_SIZES = (2, 3, 1024, 1025, 4_972_266, 8_932_941)
SHUFFLE_KEY_SETS = ((0, 0, 0, 0), (2 ** 31 - 2,) * 4, (12_345, 2 ** 30 + 7, 99, 2 ** 31 - 3))
WHOLE_FIT_LOSS_RTOL = 1e-3
WHOLE_FIT_PAIR_LR = 0.03
IMPLICIT_STATE = ['user_emb', 'item_emb', 'item_bias', 'mu_u', 'nu_u', 'mu_i', 'nu_i']
EXPLICIT_STATE = ['user_emb', 'item_emb', 'user_bias', 'item_bias', 'mu_u', 'nu_u', 'mu_i',
                  'nu_i']
# (loss_kind, adaptive, K, B, D, metadata fields, weight decay, duplicate ids)
EPOCH_EDGES = [
    ('hinge', False, 1, 7, 10, 0, 0.0, False),
    ('hinge', True, 4, 100, 10, 0, 0.0, False),
    ('bpr', False, 4, 100, 33, 0, 0.0, False),
    ('bpr', True, 4, 37, 64, 0, 1e-3, False),
    ('warp', False, 5, 100, 32, 0, 0.0, False),
    ('hinge', True, 4, 100, 16, 2, 0.0, True),
    ('warp', False, 6, 61, 8, 2, 1e-3, True),
    ('bpr', False, 1, 1, 256, 1, 0.0, False),
]
# (loss_kind, y_range, B, D, weight decay, duplicate ids, masked pad tail)
EXPLICIT_EDGES = [
    ('mse', None, 7, 10, 0.0, False, False),
    ('mae', None, 100, 33, 0.0, False, False),
    ('mse', Y_RANGE, 37, 64, 1e-3, True, False),
    ('mae', Y_RANGE, 61, 8, 0.0, True, False),
    ('mse', None, 1, 256, 0.0, False, False),
    ('mse', Y_RANGE, 100, 32, 0.0, False, True),
]


def log(*args):
    print(*args, flush=True)


def kernel_wrappers():
    """Every kernel wrapper of the port, each with its ``launches`` count."""
    from collie_tpu_torch.ops.device_sampling import complement_sample_negatives_bucketed_grouped
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch,
                                                             fused_mf_explicit_epoch)
    from collie_tpu_torch.ops.kernels.gather_scatter import binned_gather_scatter
    from collie_tpu_torch.ops.kernels.retrieval_kernel import mf_topk_retrieve, stable_topk
    from collie_tpu_torch.ops.shuffle import feistel_permutation_from_keys

    return (mf_topk_retrieve, fused_mf_epoch, fused_mf_explicit_epoch, binned_gather_scatter,
            feistel_permutation_from_keys, stable_topk,
            complement_sample_negatives_bucketed_grouped)


def reset_launch_counts():
    """Zero every kernel's launch count, just before a path is driven."""
    for wrapper in kernel_wrappers():
        wrapper.launches = 0


def nvidia_smi() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_median_ms(fn, warmup: int = 2, runs: int = 7) -> float:
    """Median over warm runs of one call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _kernel_name(name: str) -> str:
    """``void (anonymous namespace)::mf_step_kernel<1>(float const*, ...)`` ->
    ``mf_step_kernel<1>``."""
    name = name.split('(float')[0].split('(int')[0].split('(unsigned')[0]
    return name.replace('void ', '').replace('(anonymous namespace)::', '').strip()


def profile_epoch_call(label, call):
    """Run ``call`` once under ``torch.profiler`` and print the device
    activities it launched: count, total and mean time by name, and the
    device's idle time between the first start and the last end.  Returns
    the number of device activities, or None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        log(f'  profiler, {label}: no device activity seen')
        return None
    by_name = {}
    for e in device:
        count, total = by_name.get(_kernel_name(e.name), (0, 0.0))
        by_name[_kernel_name(e.name)] = (count + 1, total + e.time_range.elapsed_us())
    busy = sum(total for _, total in by_name.values())
    span = max(e.time_range.end for e in device) - min(e.time_range.start for e in device)
    log(f'  profiler, {label}: {len(device)} device launches per call, busy {busy:.1f} us of '
        f'a {span:.1f} us span (gaps {span - busy:.1f} us)')
    for name, (count, total) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        log(f'    {name}: {count} x, total {total:.1f} us, mean {total / count:.2f} us')
    return len(device)


def check_topk(name, ids, scores, ref_ids, ref_scores, ref_next):
    """Hold ``(ids, scores) [B, k]`` to a reference top-k.

    Scores must agree within ``RTOL``/``ATOL``.  Ids must be equal, except
    in a row whose reference k-th and (k+1)-th scores (``ref_next`` is the
    (k+1)-th) differ by less than the tolerance: there the last place is a
    near-tie that rounding may decide either way.  Returns the max abs error.
    """
    ids, ref_ids = ids.long().cpu(), ref_ids.long().cpu()
    scores, ref_scores, ref_next = scores.cpu(), ref_scores.cpu(), ref_next.cpu()
    if ids.shape != ref_ids.shape or scores.shape != ref_scores.shape:
        raise AssertionError(f'{name}: shape {tuple(ids.shape)} vs {tuple(ref_ids.shape)}')
    if not torch.isfinite(scores).all():
        raise AssertionError(f'{name}: non-finite scores')
    max_err = float((scores - ref_scores).abs().max())
    if not torch.allclose(scores, ref_scores, rtol=RTOL, atol=ATOL):
        raise AssertionError(f'{name}: scores differ by up to {max_err}')
    bad_rows = (ids != ref_ids).any(dim=1)
    gap = ref_scores[:, -1] - ref_next
    near_tie = gap.abs() <= ATOL + RTOL * ref_scores[:, -1].abs()
    if (bad_rows & ~near_tie).any():
        rows = torch.nonzero(bad_rows & ~near_tie).flatten()[:5].tolist()
        raise AssertionError(f'{name}: ids differ in rows {rows}')
    log(f'  {name}: ids equal in {int((~bad_rows).sum())}/{len(ids)} rows '
        f'({int(bad_rows.sum())} near-tie rows excused), max_abs_err={max_err:.3g}')
    return max_err


def check_candidates(name, scores, ids, ref_scores, ref_ids, ref_next, ue, ie, ib, width,
                     user_bias=None):
    """Hold the kernel's per-range candidates ``[n_ranges, B, k]`` to the
    plain version's at the same range width.

    A float32 dot product taken in another order differs by a rounding
    error that scales with the sum of its terms' magnitudes, not with the
    score (a score near 0 of a D = 256 dot differs by ~1e-5), so each
    candidate's tolerance is ``ATOL + RTOL * m``, ``m = |u| . |i| + |b|``
    for its user and item (plus ``|user_bias|`` where the scores carry it).
    Scores must agree position by position within it, and each candidate's
    score must be its id's score recomputed from the inputs (a padding
    entry, finfo.min, must carry its range's first id).  A row's ids must
    be the plain version's as a set, except in a row whose k-th and
    (k+1)-th plain scores (``ref_next`` is the (k+1)-th) are a near-tie.
    Returns the max abs error."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import NEG_INF

    if scores.shape != ref_scores.shape or ids.shape != ref_ids.shape:
        raise AssertionError(f'{name}: shape {tuple(scores.shape)} vs {tuple(ref_scores.shape)}')
    pad = scores == NEG_INF
    n_ranges, B, k = scores.shape
    base = (torch.arange(n_ranges, device=ids.device) * width)[:, None, None].expand_as(ids)
    if not torch.equal(ids[pad], base[pad].to(ids.dtype)) or not torch.equal(
            pad, ref_scores == NEG_INF):
        raise AssertionError(f'{name}: padding entries differ from the plain version\'s')
    safe = torch.where(pad, torch.zeros_like(ids), ids).long()
    rows = ie[safe]
    recomputed = torch.einsum('bd,rbkd->rbk', ue, rows) + ib[safe]
    magnitude = torch.einsum('bd,rbkd->rbk', ue.abs(), rows.abs()) + ib[safe].abs()
    if user_bias is not None:
        magnitude = magnitude + user_bias.abs()[None, :, None]
    tol = torch.where(pad, torch.zeros_like(magnitude), ATOL + RTOL * magnitude)
    err = (scores - ref_scores).abs()
    max_err = float(err.max())
    if (err > tol).any():
        raise AssertionError(f'{name}: candidate scores differ by up to {max_err}')
    if ((torch.where(pad, scores, recomputed) - scores).abs() > tol).any():
        raise AssertionError(f'{name}: a candidate\'s score is not its id\'s score')
    same = (ids.sort(dim=-1).values == ref_ids.sort(dim=-1).values).all(dim=-1)
    gap = ref_scores[..., -1] - ref_next
    near_tie = gap.abs() <= tol[..., -1] + ATOL + RTOL * ref_scores[..., -1].abs()
    if (~same & ~near_tie).any():
        bad = torch.nonzero(~same & ~near_tie)[:5].tolist()
        raise AssertionError(f'{name}: candidate ids differ at (range, user) {bad}')
    log(f'  {name}: candidates of {n_ranges} ranges x {B} users equal as sets in '
        f'{int(same.sum())}/{same.numel()} rows ({int((~same).sum())} near-tie rows '
        f'excused), max_abs_err={max_err:.3g}')
    return max_err


def compare_topk_kernel(label, ue, ub, ie, ib, k):
    """The top-k kernel's candidates against the plain version at the
    plan's range width, then the merged top-k against a dense stable top-k;
    both through ``check_candidates``.  Returns the max abs error."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import (
        mf_topk_retrieve, stable_topk_plain, topk_plan, topk_tiles_cuda, topk_tiles_plain)

    (B, D), I = ue.shape, ie.shape[0]
    plan = topk_plan(B, D, k, I, torch.cuda.get_device_properties(0).multi_processor_count)
    scores, ids = topk_tiles_cuda(ue, ie, ib, k)
    ref_scores, ref_ids = topk_tiles_plain(ue, ie, ib, k, plan.range_width)
    ref_next = topk_tiles_plain(ue, ie, ib, k + 1, plan.range_width)[0][..., k]
    err = check_candidates(f'{label} (chunk {plan.user_chunk}, {plan.n_ranges} ranges of '
                           f'{plan.range_width})', scores, ids, ref_scores, ref_ids, ref_next,
                           ue, ie, ib, plan.range_width)
    ids, scores = mf_topk_retrieve(ue, ub, ie, ib, k=k)
    dense_scores, dense_ids = stable_topk_plain(ue @ ie.T + ib[None, :], min(k + 1, I))
    dense_next = (dense_scores[:, k] if I > k
                  else torch.full((B,), float('-inf'), device=ue.device))
    torch.cuda.synchronize()
    return max(err, check_candidates(
        f'{label} merged', (scores - ub[:, None])[None], ids[None], dense_scores[None, :, :k],
        dense_ids[None, :, :k].int(), dense_next[None], ue, ie, ib, I, user_bias=ub))


def special_rows(rng, rows: int, n: int, dtype=torch.float32) -> torch.Tensor:
    """``[rows, n]`` normals of ``dtype`` on the card, each row holding up to
    three copies of every special pattern of the dtype
    (``SELECT_SPECIAL_BITS``, ``SELECT_SPECIAL_BITS_16``) at random places."""
    values = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dtype)
    wide = dtype == torch.float32
    bits = values.view(torch.int32 if wide else torch.int16).numpy()
    patterns = SELECT_SPECIAL_BITS if wide else SELECT_SPECIAL_BITS_16[str(dtype).split('.')[-1]]
    special = np.asarray(patterns, dtype=np.uint32 if wide else np.uint16).view(bits.dtype)
    m = min(n, 3 * len(special))
    for r in range(rows):
        bits[r, rng.choice(n, m, replace=False)] = np.resize(special, m)[rng.permutation(m)]
    return values.to(DEVICE)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, as integers of its width."""
    return t.contiguous().view({4: torch.int32, 2: torch.int16}[t.element_size()])


def compare_select(label: str, scores: torch.Tensor, k: int, quiet: bool = False):
    """``stable_topk`` of ``scores`` against ``stable_topk_plain`` (the full
    stable sort): values equal bit for bit, indices equal.  Returns the
    selection kernel's launches and the largest difference of the values
    (0 where both are NaN or equal; NaN where one is NaN and the other not)."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import stable_topk, stable_topk_plain

    before = stable_topk.launches
    values, indices = stable_topk(scores, k)
    ref_values, ref_indices = stable_topk_plain(scores, k)
    torch.cuda.synchronize()
    launches = stable_topk.launches - before
    if values.shape != ref_values.shape or values.dtype != ref_values.dtype \
            or indices.dtype != torch.int64:
        raise AssertionError(f'{label}: {tuple(values.shape)} {values.dtype} {indices.dtype} '
                             f'against {tuple(ref_values.shape)} {ref_values.dtype} int64')
    a, b = values.double(), ref_values.double()
    same = (a == b) | (a.isnan() & b.isnan())
    err = float(torch.where(same, 0.0, (a - b).abs()).max()) \
        if values.numel() else 0.0
    if not torch.equal(_bits(values), _bits(ref_values)) or not torch.equal(indices, ref_indices):
        rows = (indices != ref_indices).reshape(-1, indices.shape[-1]).any(dim=1)
        raise AssertionError(f'{label}: differs from the stable sort in rows '
                             f'{rows.nonzero().flatten()[:5].tolist()} (max abs err {err})')
    if not quiet:
        log(f'  {label}: equal to the stable sort bit for bit ({launches} selection)')
    return launches, err


def recommend_selections(model, users: int, filter_seen: bool, shards: int = 0,
                         item_tile: int = 4096) -> int:
    """Selection launches (``stable_topk`` on the card) of one ``recommend``
    of ``users`` users at k = ``K``, by ``build_retrieval_fn``'s routing:
    one for the dense path's score block, one for the kernel path's merge of
    its ranges, one a tile on the blockwise path; under a mesh of ``shards``
    catalog shards, a rank's local top-k and one merge of the shards."""
    from collie_tpu_torch.models.base import BasePipeline
    from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel
    from collie_tpu_torch.ops.kernels.retrieval_kernel import MAX_K
    from collie_tpu_torch.retrieval import _dense_budget_bytes

    num_items = model.hparams['num_items']
    kernel = (not filter_seen and type(model) is MatrixFactorizationModel and K <= MAX_K
              and all(v.dtype == torch.float32 for v in model.params.values()))
    if shards:
        local = type(model) is MatrixFactorizationModel and num_items % shards == 0
        span = num_items // shards if local else -(-num_items // shards)
        return (1 if local and kernel and K <= span else -(-span // item_tile)) + 1
    within = users * num_items * 4 <= _dense_budget_bytes()
    dense = type(model).score_item_block is not BasePipeline.score_item_block
    return 1 if (kernel and not within) or (dense and within) else -(-num_items // item_tile)


def select_times() -> dict:
    """Median ms at ``SELECT_SHAPE``: ``stable_topk`` (the selection
    kernel), the full stable sort and ``torch.topk`` (the library's
    selection, which promises no tie order), with one ``torch.profiler``
    look at the kernel.  Uses only public calls, so a copy of this script in
    another checkout times that checkout's ``stable_topk``."""
    from collie_tpu_torch.ops.kernels import retrieval_kernel

    rows, n, k = SELECT_SHAPE
    scores = _rand(np.random.default_rng(13), (rows, n))
    plain = getattr(retrieval_kernel, 'stable_topk_plain', retrieval_kernel.stable_topk)
    ms = cuda_median_ms(lambda: retrieval_kernel.stable_topk(scores, k), warmup=3, runs=21)
    plain_ms = cuda_median_ms(lambda: plain(scores, k), warmup=2, runs=7)
    library_ms = cuda_median_ms(lambda: torch.topk(scores, k, dim=-1), warmup=3, runs=21)
    bound_ms = 4.0 * rows * n / PEAK_BYTES_PER_S * 1e3
    by_k = {str(kk): cuda_median_ms(lambda: retrieval_kernel.stable_topk(scores, kk), warmup=2,
                                    runs=9) for kk in SELECT_TIMED_KS}
    log(f'  selection {rows} x {n} k={k}: stable_topk {ms:.4f} ms, stable sort {plain_ms:.4f} '
        f'ms, torch.topk {library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes); stable_topk by '
        f'k {by_k}')
    profile_epoch_call(f'one stable_topk call at {rows} x {n}, k={k}',
                       lambda: retrieval_kernel.stable_topk(scores, k))
    return {'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms, 'bound_ms': bound_ms,
            'ms_by_k': by_k}


def select_request(rows: int, n: int) -> dict:
    """``SELECT_REQUESTS`` ``recommend`` requests of ``rows`` users over an MF
    catalog of ``n`` items (D 64, no seen filtering): the dense path, whose
    top-k is one selection each, with every kernel count zeroed just before.
    Each answer is held to the stable sort of the same score block.  Returns
    the selections and the largest score difference."""
    from collie_tpu_torch import Interactions, MatrixFactorizationModel
    from collie_tpu_torch.ops.kernels.retrieval_kernel import stable_topk, stable_topk_plain
    from collie_tpu_torch.retrieval import recommend

    rng = np.random.default_rng(19)
    train = Interactions(users=rng.integers(0, 10 * rows, 5000), items=rng.integers(0, n, 5000),
                         num_users=10 * rows, num_items=n, allow_missing_ids=True, seed=0)
    model = MatrixFactorizationModel(train=train, embedding_dim=EMBEDDING_DIM, seed=19)
    requests = [rng.choice(10 * rows, rows, replace=False) for _ in range(SELECT_REQUESTS)]
    expected = SELECT_REQUESTS * recommend_selections(model, rows, False)
    reset_launch_counts()
    answers = [recommend(model, users, k=K, filter_seen=False) for users in requests]
    torch.cuda.synchronize()
    launches = _kernel_counts()
    want = dict.fromkeys(launches, 0)
    want['stable_topk'] = expected
    if launches != want or expected != SELECT_REQUESTS:
        raise AssertionError(f'dense requests: kernel launches {launches}, expected {want}')
    worst = 0.0
    for users, (ids, scores) in zip(requests, answers):
        with torch.no_grad():
            block = model.score_item_block(model.params, model._ids(users),
                                           torch.arange(n, device=model.device))
            ref_scores, ref_ids = stable_topk_plain(block, K)
        if not np.array_equal(ids, ref_ids.cpu().numpy()):
            raise AssertionError('dense request: ids differ from the stable sort')
        ref = ref_scores.cpu().numpy()
        worst = max(worst, float(np.abs(scores - ref).max()))
        if not np.array_equal(scores.view(np.int32), ref.view(np.int32)):
            raise AssertionError(f'dense request: scores differ from the stable sort by {worst}')
    log(f'  {SELECT_REQUESTS} recommend requests of {rows} users over {n} items (the dense '
        f'path): {launches["stable_topk"]} selections, no other kernel; ids and scores equal '
        f'the stable sort of the score block (max abs err {worst})')
    del model
    torch.cuda.empty_cache()
    return {'launches': launches['stable_topk'], 'max_abs_err': worst}


def phase_select() -> dict:
    """The selection kernel against the stable sort (``SELECT_*``), then the
    dense path's requests at ``SELECT_SHAPE``; returns its record, whose
    ``launches`` are the selections of those requests (later phases add
    theirs) and ``max_abs_err`` the largest difference measured."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import select_plan

    log('kernel topk_select vs the stable sort (bit for bit)')
    worst, checks = 0.0, 0

    def check(label, scores, k, quiet=True):
        nonlocal worst, checks
        launches, err = compare_select(label, scores, k, quiet=quiet)
        if launches != 1:
            raise AssertionError(f'{label}: {launches} selections, expected 1')
        worst, checks = max(worst, err), checks + 1

    gen = torch.Generator(device=DEVICE).manual_seed(19)
    for rows in SELECT_ROWS:
        for length in SELECT_LENGTHS:
            for k in SELECT_KS:
                n = k if length == 'k' else length
                check(f'normal {rows} x {n} k={k}',
                      torch.randn(rows, n, device=DEVICE, generator=gen), k)
    log(f'  normals: {len(SELECT_ROWS) * len(SELECT_LENGTHS) * len(SELECT_KS)} shapes equal')
    rng = np.random.default_rng(19)
    for n in (10, 128, 1000, 4106, 384_546):
        for k in (k for k in SELECT_KS if k <= n):
            check(f'specials 64 x {n} k={k}', special_rows(rng, 64, n), k, quiet=False)
            few = torch.randint(0, 4, (128, n), device=DEVICE, generator=gen).float()
            check(f'four values 128 x {n} k={k}', few, k)
            check(f'constant 128 x {n} k={k}', torch.full((128, n), 0.5, device=DEVICE), k)
    for rows, n, k in SELECT_LARGE:
        scores = torch.randn(rows, n, device=DEVICE, generator=gen)
        plan = select_plan(scores, k)
        check(f'large k {rows} x {n} k={k} ({plan})', scores, k, quiet=False)
        check(f'four values {rows} x {n} k={k}',
              torch.randint(0, 4, (rows, n), device=DEVICE, generator=gen).float(), k)
        check(f'specials {rows} x {n} k={k}', special_rows(rng, rows, n), k)
    for dtype in (torch.float16, torch.bfloat16):
        for rows, n, k in ((64, 1000, 10), (128, 384_546, 10), (513, 4106, 128),
                           (4, 100_000, 1025), (2, 30_000, 8000)):
            check(f'{dtype} specials {rows} x {n} k={k}', special_rows(rng, rows, n, dtype), k,
                  quiet=False)
            check(f'{dtype} normals {rows} x {n} k={k}',
                  torch.randn(rows, n, device=DEVICE, generator=gen).to(dtype), k)
    log(f'  {checks} selections equal the stable sort bit for bit (max abs err {worst})')
    rows, n, k = SELECT_SHAPE
    served = select_request(rows, n)
    times = select_times()
    torch.cuda.synchronize()
    return {'name': 'topk_select', 'route': 'cuda',
            'source': 'collie_tpu_torch/csrc/topk_select.cu',
            'replaces': "none (lax.top_k under XLA; the port's full stable sort)",
            'launches': served['launches'], 'max_abs_err': max(worst, served['max_abs_err']),
            'ms': times['ms'], 'plain_ms': times['plain_ms'], 'bound_ms': times['bound_ms'],
            'bound_by': 'bytes', 'library_ms': times['library_ms'], 'ms_by_k': times['ms_by_k'],
            'checked': True}


def phase_device():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this check needs a '
              'CUDA card', file=sys.stderr)
        sys.exit(2)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'nvidia-smi: {smi}')
    log(f'torch {torch.__version__} cuda {torch.version.cuda} device '
        f'{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    log(f'torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
        f'torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')
    torch.cuda.synchronize()
    return smi


def phase_build():
    from collie_tpu_torch.ops.kernels import _build

    sources = sorted(p.name for p in _build.CSRC.glob('*.cu'))
    start = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = list(pool.map(_build.build, sources))
    seconds = time.perf_counter() - start
    for source, path in zip(sources, paths):
        log(f'built {source} -> {path.name}')
        report = _build.build_log.get(source, (0.0, 'already built'))[1]
        regs = [line.strip() for line in report.splitlines()
                if 'registers' in line or 'Compiling entry' in line]
        for line in regs:
            log(f'  ptxas: {line}')
    log(f'build_seconds={seconds:.2f}')
    for source in sources:
        _build.load(source)
    torch.cuda.synchronize()


def _rand(rng, shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32), device='cuda')


def phase_kernels():
    """topk_tile against its plain version; returns the kernel's record."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import (
        mf_topk_retrieve, mf_topk_retrieve_plain, stable_topk_plain, topk_plan, topk_tiles_cuda,
        topk_tiles_plain)

    max_err = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f'kernel topk_tile vs plain (rtol={RTOL}, atol={ATOL}), {sms} SMs')

    def compare(label, ue, ub, ie, ib, k, tile):
        ids, scores = mf_topk_retrieve(ue, ub, ie, ib, k=k, tile=tile)
        if k + 1 <= min(128, ie.shape[0]):
            _, plain_next = mf_topk_retrieve_plain(ue, ub, ie, ib, k=k + 1, tile=tile)
            plain_next = plain_next[:, k]
        else:
            plain_next = torch.full((ue.shape[0],), float('-inf'), device='cuda')
        p_ids, p_scores = mf_topk_retrieve_plain(ue, ub, ie, ib, k=k, tile=tile)
        torch.cuda.synchronize()
        return check_topk(label, ids, scores, p_ids, p_scores, plain_next)

    # edge envelopes of tests/test_retrieval.py::test_pallas_kernel_edge_envelopes
    for B, tile, k in ((37, 257, 10), (1, 64, 5), (9, 4096, 10), (16, 128, 128)):
        rng = np.random.default_rng(B * 1000 + tile + k)
        ue, ub = _rand(rng, (B, 12)), _rand(rng, (B,))
        ie, ib = _rand(rng, (611, 12)), _rand(rng, (611,))
        max_err = max(max_err, compare(f'B={B} tile={tile} k={k}', ue, ub, ie, ib, k, tile))

    # the kernel's own tiling: every row layout of its stages, user chunks,
    # list registers, short last ranges and catalogs below one tile
    for B, D, k, I in TOPK_EDGES:
        rng = np.random.default_rng(B * 7 + D * 131 + k + I)
        ue, ub, ie, ib = _rand(rng, (B, D)), _rand(rng, (B,)), _rand(rng, (I, D)), _rand(rng, (I,))
        label = f'B={B} D={D} k={k} items={I}'
        max_err = max(max_err, compare_topk_kernel(label, ue, ub, ie, ib, k))

    # ties: duplicated item rows and biases on a coarse grid, so every sum is
    # exact in float32 whatever its order and the tie-break alone decides
    rng = np.random.default_rng(7)
    grid = lambda shape: torch.tensor(  # noqa: E731
        rng.integers(-2, 3, shape).astype(np.float32) / 4, device='cuda')
    ue, ub = grid((24, 12)), grid((24,))
    ie, ib = grid((611, 12)), grid((611,))
    ie[300:600], ib[300:600] = ie[:300].clone(), ib[:300].clone()
    ids, scores = mf_topk_retrieve(ue, ub, ie, ib, k=40, tile=128)
    full = ue @ ie.T + ub[:, None] + ib[None, :]
    ref_scores, ref_ids = stable_topk_plain(full, 40)
    torch.cuda.synchronize()
    if not torch.equal(ids.long(), ref_ids) or not torch.equal(scores, ref_scores):
        raise AssertionError('tie case: kernel ids/scores differ from the stable top-k')
    plan = topk_plan(24, 12, 40, 611, sms)
    cand = topk_tiles_cuda(ue, ie, ib, 40)
    ref_cand = topk_tiles_plain(ue, ie, ib, 40, plan.range_width)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(cand, ref_cand)):
        raise AssertionError('tie case: kernel candidates differ from the plain version\'s')
    log('  ties: ids and scores equal to the dense stable top-k (lowest id first), and the '
        f'candidates of {plan.n_ranges} ranges equal to the plain version\'s')

    # serving shape
    B, I, D, k, tile = REQUEST_USERS, NUM_ITEMS, EMBEDDING_DIM, K, 4096
    rng = np.random.default_rng(11)
    ue, ub, ie, ib = _rand(rng, (B, D)), _rand(rng, (B,)), _rand(rng, (I, D)), _rand(rng, (I,))
    max_err = max(max_err, compare(f'serving B={B} I={I} D={D} k={k} tile={tile}',
                                   ue, ub, ie, ib, k, tile))
    for kk in (1, 10, 128):
        plan = topk_plan(B, D, kk, I, sms)
        log(f'  launch plan at k={kk}: user chunk {plan.user_chunk} ({plan.threads} threads, '
            f'{plan.n_chunks} chunks), {plan.n_ranges} ranges of {plan.range_width} items, '
            f'lists in {"shared" if plan.lists_in_shared else "device"} memory, '
            f'{plan.shared_bytes} shared bytes, {plan.blocks_per_sm} block(s) an SM; '
            f'registers: the ptxas lines of the build')
    plan = topk_plan(B, D, k, I, sms)
    cand_scores, cand_ids = topk_tiles_cuda(ue, ie, ib, k)
    ref_scores, ref_ids = topk_tiles_plain(ue, ie, ib, k + 1, plan.range_width)
    max_err = max(max_err, check_candidates(
        'serving candidates', cand_scores, cand_ids, ref_scores[..., :k], ref_ids[..., :k],
        ref_scores[..., k], ue, ie, ib, plan.range_width))
    del cand_scores, cand_ids, ref_scores, ref_ids

    def library():
        return torch.topk(ue @ ie.T + ub[:, None] + ib[None, :], k, dim=1)

    kernel_ms = cuda_median_ms(lambda: mf_topk_retrieve(ue, ub, ie, ib, k=k, tile=tile))
    kernel_only_ms = cuda_median_ms(lambda: topk_tiles_cuda(ue, ie, ib, k, tile))
    plain_ms = cuda_median_ms(lambda: mf_topk_retrieve_plain(ue, ub, ie, ib, k=k, tile=tile),
                              warmup=1, runs=3)
    library_ms = cuda_median_ms(library)
    # where the kernel's time goes: scoring is the same for every k, the
    # running top-k's inserts grow with k
    by_k = {kk: cuda_median_ms(lambda kk=kk: topk_tiles_cuda(ue, ie, ib, kk, tile),
                               warmup=1, runs=5) for kk in (1, 10, 128)}
    log('  kernel launch alone by k: ' + ', '.join(f'k={kk} {ms:.4f} ms'
                                                    for kk, ms in by_k.items()))
    ops = 2.0 * B * I * D + B * I               # FMAs of the dots + the item bias
    nbytes = 4.0 * (B * D + B + I * D + I) + 8.0 * B * k
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f'  serving shape: kernel_ms={kernel_ms:.4f} (kernel launch alone '
        f'{kernel_only_ms:.4f}, the rest is the tile merge) plain_ms={plain_ms:.4f} '
        f'library_ms={library_ms:.4f} (matmul + bias + torch.topk) '
        f'bound_ms={bound_ms:.4f} (operations {ops_ms:.4f}, bytes {bytes_ms:.4f})')
    del ue, ub, ie, ib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {
        'name': 'topk_tile',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/topk_tile.cu',
        'replaces': 'collie_tpu/ops/pallas/retrieval_kernel.py:36',
        'launches': 0,
        'max_abs_err': max_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': library_ms,
        'launch_ms': kernel_only_ms,
        'launch_ms_by_k': by_k,
        'checked': True,
    }


def gather_scatter_inputs(seed, U, D, B, n_bins, **_):
    """The microbench's inputs (benchmarks/microbench_gather.py:74-116,
    :180-182) on the card: table ``[D, UPAD]`` with zeros past U, ids
    stably sorted by bin, bin offsets, gradient columns in sorted order;
    and the table ``[U, D]`` for the library yardstick."""
    rng = np.random.default_rng(seed)
    ub = -(-U // n_bins // 128) * 128
    tab = rng.standard_normal((U, D)).astype(np.float32)
    ids = rng.integers(0, U, B).astype(np.int32)
    grads = rng.standard_normal((B, D)).astype(np.float32)
    order = np.argsort(ids // ub, kind='stable')
    offs = np.concatenate([[0], np.cumsum(np.bincount(ids // ub, minlength=n_bins))])
    tab_t = np.zeros((D, n_bins * ub), np.float32)
    tab_t[:, :U] = tab.T
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    return (to(tab_t), to(ids[order]), to(offs.astype(np.int32)), to(grads[order].T)), to(tab)


def phase_gather_scatter():
    """binned_gather_scatter (the port of the microbench's ``pk``) driven at
    the microbench's shapes (bins in the clusters' shared memory) and at
    ``GS_OVERSIZE`` (bins too large for a cluster: rows in device memory),
    each against its plain version, the first also against the library's
    ``index_select`` + ``index_add_``; returns the kernel's record."""
    from collie_tpu_torch.ops.kernels.gather_scatter import (binned_gather_scatter,
                                                             binned_gather_scatter_plain,
                                                             gather_scatter_plan,
                                                             kept_examples, kernel_plan)

    def check(label, shape, want_shared_rows):
        iters, c_pad = shape['iters'], shape['c_pad']
        (tab_t, sids, offs, g_t), tab = gather_scatter_inputs(0, **shape)
        D, upad = tab_t.shape
        B, n_bins = sids.shape[0], offs.shape[0] - 1
        plan = gather_scatter_plan(D, upad, n_bins, B, c_pad)
        built = kernel_plan(D, upad, n_bins, B, c_pad)
        if built != plan:
            raise AssertionError(f'{label}: the kernel plans {built}, the wrapper {plan}')
        if plan.shared_rows != want_shared_rows:
            raise AssertionError(f'{label}: plan {plan}')
        log(f'kernel binned_gather_scatter vs plain, {label}: D={D} UPAD={upad} B={B} '
            f'n_bins={n_bins} C_PAD={c_pad} iters={iters}; {plan.mode}, cluster of '
            f'{plan.cluster}, {plan.shared_bytes} shared bytes a block, example cache '
            f'{plan.cache} (out atol {GS_ATOL_SCALE} x max|ref|, gathered atol '
            f'{GS_ATOL_SCALE} x kept x max|ref|)')
        reset_launch_counts()
        out, gathered = binned_gather_scatter(tab_t, sids, offs, g_t, iters, c_pad)
        torch.cuda.synchronize()
        launches = binned_gather_scatter.launches
        if launches != 1 or binned_gather_scatter.last_plan != plan:
            raise AssertionError(f'{label}: {launches} launches for one call, launched '
                                 f'{binned_gather_scatter.last_plan}')
        ref_out, ref_gathered = binned_gather_scatter_plain(tab_t, sids, offs, g_t, iters, c_pad)
        n_kept = int(kept_examples(sids, offs, upad, c_pad).sum())
        top = float(ref_out.abs().max())
        err_out = float((out - ref_out).abs().max())
        err_gathered = float((gathered - ref_gathered).abs().max())
        if not (torch.isfinite(out).all() and torch.isfinite(gathered).all()):
            raise AssertionError(f'{label}: non-finite output')
        if err_out > GS_ATOL_SCALE * top or err_gathered > GS_ATOL_SCALE * n_kept * top:
            raise AssertionError(f'{label}: differs from plain: out {err_out:.3g}, '
                                 f'gathered {err_gathered:.3g} (max|ref| {top:.3g})')
        log(f'  {n_kept} of {B} examples kept by the bin windows; max_abs_err out '
            f'{err_out:.3g}, gathered {err_gathered:.3g} (max|ref| {top:.3g})')
        kernel_ms = cuda_median_ms(lambda: binned_gather_scatter(tab_t, sids, offs, g_t, iters,
                                                                 c_pad))
        plain_ms = cuda_median_ms(lambda: binned_gather_scatter_plain(tab_t, sids, offs, g_t,
                                                                      iters, c_pad))
        inputs = (tab_t, sids, offs, g_t, tab, ref_out, ref_gathered, n_kept, top)
        return inputs, launches, max(err_out, err_gathered), kernel_ms, plain_ms

    iters, c_pad = GS_SHAPE['iters'], GS_SHAPE['c_pad']
    inputs, launches, max_err, kernel_ms, plain_ms = check('microbench shape', GS_SHAPE, True)
    tab_t, sids, offs, g_t, tab, ref_out, ref_gathered, n_kept, top = inputs
    D, upad = tab_t.shape
    B = sids.shape[0]
    kept = kept_examples(sids, offs, upad, c_pad)
    lib_kept = sids.long()[kept]
    lib_rows = g_t.T[kept]

    def library():
        table = tab.clone()
        sums = torch.empty((iters, D), dtype=torch.float32, device=DEVICE)
        for r in range(iters):
            sums[r] = table.index_select(0, lib_kept).sum(dim=0)
            table.index_add_(0, lib_kept, lib_rows)
        return table, sums

    lib_out, lib_gathered = library()
    torch.cuda.synchronize()
    lib_err = max(float((lib_out.T - ref_out[:, :tab.shape[0]]).abs().max()),
                  float((lib_gathered - ref_gathered).abs().max()) / n_kept)
    if lib_err > GS_ATOL_SCALE * top:
        raise AssertionError(f'the library yardstick computes another function ({lib_err:.3g})')
    library_ms = cuda_median_ms(library)
    # the least the function must move: the table read and ``out`` written
    # once, the gradients, ids and offsets read once, ``gathered`` written;
    # operations: an add per element gathered and per element scattered
    nbytes = 4.0 * (2 * D * upad + D * B + B + offs.numel() + iters * D)
    ops = 2.0 * iters * n_kept * D
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    # what every round moves if the table does not stay on chip: rows
    # gathered, rows read and written by the scatter, the gradients
    round_ms = (iters * 16.0 * n_kept * D + 8.0 * D * upad) / PEAK_BYTES_PER_S * 1e3
    log(f'  {iters} rounds: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} '
        f'library_ms={library_ms:.4f} (index_select + sum + index_add_ per round on the '
        f'[U, D] table) bound_ms={bound_ms:.4f} (operations {ops_ms:.4f}, bytes '
        f'{bytes_ms:.4f}); every round through device memory: {round_ms:.4f} ms')
    del inputs, tab_t, tab, ref_out, lib_out
    torch.cuda.synchronize()

    _, _, oversize_err, oversize_ms, oversize_plain_ms = check('oversize bins', GS_OVERSIZE,
                                                                False)
    log(f'  {GS_OVERSIZE["iters"]} rounds, bins in device memory: kernel_ms={oversize_ms:.4f} '
        f'plain_ms={oversize_plain_ms:.4f}')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {
        'name': 'binned_gather_scatter',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/gather_scatter.cu',
        'replaces': 'benchmarks/microbench_gather.py:151',
        'launches': launches,
        'max_abs_err': max(max_err, oversize_err),
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': library_ms,
        'oversize_ms': oversize_ms,
        'checked': True,
    }


def epoch_inputs(seed, U=37, I=53, D=10, S=3, B=7, K=1, F=0, dup=False):
    """Tables, moments and batches of ``fused_mf_epoch`` on the card, from a
    numpy seed."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    users = rng.integers(0, U, (S, B)).astype(np.int32)
    pos = rng.integers(0, I, (S, B)).astype(np.int32)
    negs = rng.integers(0, I, (S, B, K)).astype(np.int32)
    if dup:
        users[:, :(B + 1) // 2] = users[:, :1]
        pos[:, :(B + 1) // 2] = pos[:, :1]
    mask = np.ones((S, B), np.float32)
    if S:
        mask[-1, B // 2:] = 0.0
    arrays = [f(U, D), f(I, D), f(I), f(U, D, scale=1e-3), np.abs(f(U, D, scale=1e-4)),
              f(I, D, scale=1e-3), np.abs(f(I, D, scale=1e-4))]
    tensors = [torch.from_numpy(a).to(DEVICE) for a in arrays]
    tensors.append(torch.tensor(5, dtype=torch.int32, device=DEVICE))
    tensors += [torch.from_numpy(a).to(DEVICE) for a in (users, pos, negs, mask)]
    tensors += [0.05, 0.01]
    meta = torch.from_numpy(rng.integers(0, 3, (F, I)).astype(np.int32)).to(DEVICE) if F else None
    return tensors, meta


def compare_epoch(label, out, ref, max_flipped=0.0, quiet=False, names=IMPLICIT_STATE):
    """Hold a fused epoch's outputs ``(*state, count, losses)`` to the plain
    version's; ``names`` names the state tensors (``IMPLICIT_STATE`` for
    ``fused_mf_epoch``, ``EXPLICIT_STATE`` for ``fused_mf_explicit_epoch``).
    Returns the max abs error over the state."""
    n = len(names)
    max_err, report = 0.0, []
    for name, a, b in zip(names, out[:n], ref[:n]):
        diff = (a - b).abs()
        tol = EPOCH_RTOL * b.abs() + EPOCH_ATOL_SCALE * b.abs().max()
        if not torch.isfinite(a).all():
            raise AssertionError(f'{label}: non-finite {name}')
        flipped = float((diff > tol).float().mean())
        if flipped > max_flipped:
            raise AssertionError(f'{label}: {name} differs beyond tolerance in {flipped:.3%} '
                                 f'of elements (max abs {float(diff.max()):.3g})')
        max_err = max(max_err, float(diff.max()))
        report.append(f'{name} {flipped:.2e}')
    if int(out[n]) != int(ref[n]):
        raise AssertionError(f'{label}: count {int(out[n])} vs {int(ref[n])}')
    if not torch.allclose(out[n + 1], ref[n + 1], rtol=EPOCH_RTOL, atol=1e-7):
        raise AssertionError(f'{label}: per-step losses differ: {out[n + 1][:5].tolist()} vs '
                             f'{ref[n + 1][:5].tolist()}')
    if not quiet:
        log(f'  {label}: max_abs_err={max_err:.3g}; share of elements beyond tolerance: '
            + ', '.join(report))
    return max_err


def check_repeatable(label, launch, names) -> None:
    """Two launches of one epoch from one state give the same bits: the
    state, the count and every step's loss (``launch()`` builds its state
    afresh).  The epoch kernels sum in fixed point, so nothing is left to
    the order in which the adds land."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    start = time.perf_counter()
    first = launch()
    second = launch()
    torch.cuda.synchronize()
    differ = [name for name, a, b in zip([*names, 'count', 'losses'], first, second)
              if not torch.equal(bits(a), bits(b))]
    if differ:
        raise AssertionError(f'{label}: two launches from one state differ in {differ}')
    log(f'  {label}: two launches from one state are bit-identical in every state tensor, '
        f'the count and all {first[-1].numel()} per-step losses '
        f'({time.perf_counter() - start:.1f}s)')


def ml10m_data():
    """The ML-10M-scale configuration's data, as bench_ml10m_scale.py builds
    it: generated ratings, converted to implicit interactions as
    ``generate_implicit_interactions`` does (``'implicit'``) and kept as
    ratings (``'explicit'``), each split 90/5/5.  The ratings are generated
    once for both."""
    from collie_tpu_torch.data import ExplicitInteractions, Interactions, stratified_split
    from collie_tpu_torch.data.synthetic import generate_interactions_df
    from collie_tpu_torch.utils import convert_to_implicit

    start = time.perf_counter()
    df = generate_interactions_df(**{k: v for k, v in ML10M_DATA.items()
                                     if k != 'num_negative_samples'})
    shape = dict(num_users=ML10M_DATA['num_users'], num_items=ML10M_DATA['num_items'],
                 allow_missing_ids=True)
    kept = convert_to_implicit(df)
    implicit = Interactions(users=kept['user_id'].values, items=kept['item_id'].values,
                            ratings=kept['rating'].values,
                            num_negative_samples=ML10M_DATA['num_negative_samples'],
                            seed=ML10M_DATA['seed'], **shape)
    explicit = ExplicitInteractions(users=df['user_id'].values, items=df['item_id'].values,
                                    ratings=df['rating'].values, **shape)
    splits = {}
    for name, inter in (('implicit', implicit), ('explicit', explicit)):
        train, val, test = splits[name] = stratified_split(inter, val_p=0.05, test_p=0.05,
                                                           seed=7, force_split=True)
        log(f'ML-10M-scale {name} data: {train.num_interactions} train / '
            f'{val.num_interactions} val / {test.num_interactions} test interactions, '
            f'{train.num_users} users x {train.num_items} items')
    log(f'ML-10M-scale data built in {time.perf_counter() - start:.1f}s on the host')
    return splits


def ml10m_model(train):
    from collie_tpu_torch import InteractionsDataLoader, MatrixFactorizationModel

    loader = InteractionsDataLoader(interactions=train, batch_size=ML10M_BATCH, shuffle=True,
                                    seed=7)
    return MatrixFactorizationModel(train=loader, embedding_dim=ML10M_DIM, lr=1e-1,
                                    loss='adaptive', seed=7)


def gate_model():
    """The quality-gate configuration of bench.py:24-49: (model, train, test)."""
    from collie_tpu_torch import InteractionsDataLoader, MatrixFactorizationModel, stratified_split
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions

    train, test = stratified_split(generate_implicit_interactions(**GATE_DATA), test_p=0.2,
                                   seed=42, force_split=True)
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, shuffle=True, seed=42)
    model = MatrixFactorizationModel(train=loader, embedding_dim=10, lr=1e-1, loss='adaptive',
                                     seed=42)
    return model, train, test


def explicit_gate_model():
    """The explicit quality-gate configuration of
    benchmarks/calibrate_gates.py:84-97: (model, train, test)."""
    from collie_tpu_torch import ExplicitInteractions, MatrixFactorizationModel, stratified_split
    from collie_tpu_torch.data.synthetic import generate_interactions_df

    df = generate_interactions_df(seed=EXPLICIT_GATE_DATA['seed'])
    ratings = ExplicitInteractions(users=df['user_id'].values, items=df['item_id'].values,
                                   ratings=df['rating'].values, allow_missing_ids=True,
                                   num_users=EXPLICIT_GATE_DATA['num_users'],
                                   num_items=EXPLICIT_GATE_DATA['num_items'])
    train, test = stratified_split(ratings, test_p=0.2, seed=42, force_split=True)
    model = MatrixFactorizationModel(train=train, embedding_dim=10, lr=EXPLICIT_LR, loss='mse',
                                     y_range=Y_RANGE, seed=0)
    return model, train, test


def engine_epoch_call(model, explicit: bool):
    """One fused epoch call on the engine's first epoch of ``model`` (all S
    steps, fresh Adam state, updated in place from call to call): ``(call,
    S)``; ``call(timeline)`` passes a timeline tensor to the kernel."""
    from collie_tpu_torch.ops.kernels import fused_mf_epoch as fused
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns

    specs = model.optimizer_specs()
    epoch_fn, _, S, _ = build_scan_epoch_fns(model, specs, [True] * len(specs),
                                             model.train_loader, shuffle=True)
    batches = epoch_fn.epoch_batches(7, 1)
    params = model.params
    names = ('user_embeddings', 'item_embeddings') \
        + (('user_biases',) if explicit else ()) + ('item_biases',)
    tables = [params[k].clone() for k in names] \
        + [torch.zeros_like(params[k]) for k in ('user_embeddings', 'user_embeddings',
                                                 'item_embeddings', 'item_embeddings')] \
        + [torch.zeros((), dtype=torch.int32, device=DEVICE)]
    if explicit:
        args = [batches[k] for k in ('users', 'items', 'ratings', 'mask')] + [EXPLICIT_LR, 1e-2]
        kw = dict(loss_kind='mse', y_range=Y_RANGE)
        epoch, epoch_cuda = fused.fused_mf_explicit_epoch, fused.fused_mf_explicit_epoch_cuda
    else:
        args = [batches[k] for k in ('users', 'pos_items', 'neg_items', 'mask')] \
            + [0.1, 0.01, None]
        kw = dict(K=batches['neg_items'].shape[-1], adaptive=True, loss_kind='hinge')
        epoch, epoch_cuda = fused.fused_mf_epoch, fused.fused_mf_epoch_cuda

    def call(timeline=None):
        if timeline is None:
            return epoch(*tables, *args, **kw)
        return epoch_cuda(*tables, *args, timeline=timeline, **kw)
    return call, S


def phase_split(label, call, S):
    """Where one epoch launch spends its time: ``call(timeline)`` stamps
    the device clock after each step phase and each update phase (each
    ends in a grid barrier); prints and returns the mean µs a step."""
    timeline = torch.zeros(2 * S + 1, dtype=torch.int64, device=DEVICE)
    call(timeline)
    torch.cuda.synchronize()
    t = timeline.cpu().numpy().astype(np.float64) / 1e3
    step, update = t[1::2] - t[:-1:2], t[2::2] - t[1::2]
    log(f'  phases inside one launch, {label}: step phase {step.mean():.2f} us a step '
        f'(min {step.min():.2f}, max {step.max():.2f}), update phase {update.mean():.2f} us a '
        f'step (min {update.min():.2f}, max {update.max():.2f}), each with its barrier; '
        f'{t[-1] - t[0]:.1f} us from the first stamp to the last')
    return {'step_us': float(step.mean()), 'update_us': float(update.mean())}


def epoch_times(ml10m) -> dict:
    """Median ms of one epoch call of each fused kernel at the gate and the
    ML-10M-scale configurations (the wrapper's host work included)."""
    times = {}
    configs = (('implicit_gate', lambda: gate_model()[0], False, 21),
               ('implicit_ml10m', lambda: ml10m_model(ml10m['implicit'][0]), False, 7),
               ('explicit_gate', lambda: explicit_gate_model()[0], True, 21),
               ('explicit_ml10m', lambda: ml10m_explicit_model(ml10m['explicit'][0]), True, 7))
    for name, build, explicit, runs in configs:
        call, S = engine_epoch_call(build(), explicit)
        ms = cuda_median_ms(call, warmup=2, runs=runs)
        times[name] = {'ms': ms, 'steps': S}
        log(f'  epoch call {name} ({S} steps): {ms:.4f} ms (median of {runs})')
        del call
        torch.cuda.empty_cache()
    return times


def kernel_times() -> dict:
    """Median ms of the top-k kernel (launch alone and the whole
    ``mf_topk_retrieve`` call, at k = 1, 10 and 128) at the serving shape,
    of ``binned_gather_scatter``'s 50 rounds at the microbench's shape and of
    the selection at ``SELECT_SHAPE`` (``select_times``), with one
    ``torch.profiler`` look at each.  Uses only the wrappers'
    public calls, so a copy of this script in another checkout times that
    checkout's kernels."""
    from collie_tpu_torch.ops.kernels.gather_scatter import binned_gather_scatter
    from collie_tpu_torch.ops.kernels.retrieval_kernel import mf_topk_retrieve, topk_tiles_cuda

    B, I, D, tile = REQUEST_USERS, NUM_ITEMS, EMBEDDING_DIM, 4096
    rng = np.random.default_rng(11)
    ue, ub, ie, ib = _rand(rng, (B, D)), _rand(rng, (B,)), _rand(rng, (I, D)), _rand(rng, (I,))
    times = {'topk': {}}
    for k in (1, 10, 128):
        launch = cuda_median_ms(lambda: topk_tiles_cuda(ue, ie, ib, k, tile), warmup=2, runs=9)
        whole = cuda_median_ms(lambda: mf_topk_retrieve(ue, ub, ie, ib, k=k, tile=tile),
                               warmup=2, runs=9)
        times['topk'][f'k={k}'] = {'launch_ms': launch, 'whole_ms': whole}
        log(f'  topk B={B} I={I} D={D} k={k}: launch alone {launch:.4f} ms, whole call '
            f'{whole:.4f} ms (median of 9)')
    profile_epoch_call('one mf_topk_retrieve call at k=10',
                       lambda: mf_topk_retrieve(ue, ub, ie, ib, k=K, tile=tile))
    del ue, ub, ie, ib
    torch.cuda.empty_cache()

    (tab_t, sids, offs, g_t), _ = gather_scatter_inputs(0, **GS_SHAPE)
    args = (tab_t, sids, offs, g_t, GS_SHAPE['iters'], GS_SHAPE['c_pad'])
    ms = cuda_median_ms(lambda: binned_gather_scatter(*args), warmup=2, runs=15)
    times['binned_gather_scatter'] = {'ms': ms}
    log(f'  binned_gather_scatter {GS_SHAPE}: {ms:.4f} ms (median of 15)')
    # the cost of a round: the same call at fewer rounds
    for iters in (0, 1, 10):
        few = cuda_median_ms(lambda: binned_gather_scatter(*args[:4], iters, args[5]),
                             warmup=2, runs=15)
        times['binned_gather_scatter'][f'iters={iters}'] = few
        log(f'  binned_gather_scatter at iters={iters}: {few:.4f} ms (median of 15)')
    profile_epoch_call('one binned_gather_scatter call', lambda: binned_gather_scatter(*args))
    times['topk_select'] = select_times()
    torch.cuda.synchronize()
    return times


def phase_kernel_fused_epoch(ml10m):
    """fused_mf_epoch against its plain version; returns the kernel's record."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch,
                                                             fused_mf_epoch_cuda,
                                                             fused_mf_epoch_plain)
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns

    log(f'kernel fused_mf_epoch vs plain (rtol={EPOCH_RTOL}, atol={EPOCH_ATOL_SCALE} x '
        f'max|ref|)')
    max_err = 0.0
    for loss_kind, adaptive, K, B, D, F, wd, dup in EPOCH_EDGES:
        args, meta = epoch_inputs(K * 100 + B + D, D=D, B=B, K=K, F=F, dup=dup)
        kw = dict(K=K, adaptive=adaptive, loss_kind=loss_kind,
                  meta_weights=(0.3, 0.2)[:F] if F != 1 else (0.5,), wd_emb=wd, wd_bias=wd)
        ref = fused_mf_epoch_plain(*args, meta, **kw)
        out = fused_mf_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args], meta,
                             **kw)
        torch.cuda.synchronize()
        label = (f'{loss_kind} adaptive={adaptive} K={K} B={B} D={D} F={F} wd={wd} '
                 f'dup={dup}')
        max_err = max(max_err, compare_epoch(label, out, ref))

    # the ML-10M shape: the engine's real first epoch, fresh Adam state
    model = ml10m_model(ml10m[0])
    specs = model.optimizer_specs()
    epoch_fn, _, S, _ = build_scan_epoch_fns(model, specs, [True] * len(specs),
                                             model.train_loader, shuffle=True)
    batches = epoch_fn.epoch_batches(7, 1)
    params = model.params
    U, D = params['user_embeddings'].shape
    I = params['item_embeddings'].shape[0]
    B, K = ML10M_BATCH, ML10M_DATA['num_negative_samples']
    kw = dict(K=K, adaptive=True, loss_kind='hinge')

    def state():
        return [params['user_embeddings'].clone(), params['item_embeddings'].clone(),
                params['item_biases'].clone(),
                *[torch.zeros_like(params[k]) for k in ('user_embeddings', 'user_embeddings',
                                                        'item_embeddings', 'item_embeddings')],
                torch.zeros((), dtype=torch.int32, device=DEVICE)]

    def epoch_args(start, stop):
        return [batches[k][start:stop] for k in ('users', 'pos_items', 'neg_items', 'mask')] \
            + [0.1, 0.01, None]

    shape = f'U={U} I={I} D={D} B={B} K={K}'
    ref = fused_mf_epoch_plain(*state(), *epoch_args(0, 3), **kw)
    out = fused_mf_epoch(*state(), *epoch_args(0, 3), **kw)
    torch.cuda.synchronize()
    max_err = max(max_err, compare_epoch(f'ML-10M shape, 3 steps, {shape}', out, ref,
                                         max_flipped=MAX_FLIPPED_FRACTION))
    # one full epoch, step by step: each step of the kernel starts from the
    # plain version's state before that step, so every step of the epoch is
    # held to the tolerance without the divergence of two trajectories
    # (a flipped hardest negative moves an item row that ~70 examples of the
    # next step score against, and at lr 0.1 the two runs part within a few
    # steps; measured below for the single-call epoch)
    worst = 0.0
    current = state()
    plain_losses = []
    for step in range(S):
        ref = fused_mf_epoch_plain(*current, *epoch_args(step, step + 1), **kw)
        out = fused_mf_epoch(*[t.clone() for t in current], *epoch_args(step, step + 1), **kw)
        torch.cuda.synchronize()
        worst = max(worst, compare_epoch(f'ML-10M shape, step {step}', out, ref,
                                         max_flipped=MAX_FLIPPED_FRACTION, quiet=True))
        plain_losses.append(float(ref[8][0]))
        current = list(ref[:8])
        del out
    max_err = max(max_err, worst)
    log(f'  ML-10M shape, one epoch ({S} steps) held step by step, {shape}: '
        f'max_abs_err={worst:.3g}')
    out = fused_mf_epoch(*state(), *epoch_args(0, S), **kw)
    torch.cuda.synchronize()
    kernel_losses = out[8].tolist()
    if not all(np.isfinite(kernel_losses)):
        raise AssertionError('ML-10M one-call epoch: non-finite losses')
    parted = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    log(f'  ML-10M shape, the same epoch as one call: per-step losses within '
        f'{parted:.3%} of the plain trajectory (first {kernel_losses[0]:.6f} vs '
        f'{plain_losses[0]:.6f}, last {kernel_losses[-1]:.6f} vs {plain_losses[-1]:.6f}); '
        f'user_emb max abs difference {float((out[0] - current[0]).abs().max()):.3g}')
    del out, current, ref
    check_repeatable(f'ML-10M shape, one epoch ({S} steps) at lr 0.1',
                     lambda: fused_mf_epoch(*state(), *epoch_args(0, S), **kw), IMPLICIT_STATE)

    tables = state()
    kernel_ms = cuda_median_ms(lambda: fused_mf_epoch(*tables, *epoch_args(0, S), **kw),
                               warmup=1, runs=5)
    plain_ms = cuda_median_ms(lambda: fused_mf_epoch_plain(*state(), *epoch_args(0, S), **kw),
                              warmup=0, runs=1)
    # least traffic per step (the kernel header's count): the dense update
    # reads and writes the tables and both moments (24 (U + I) D bytes) and
    # the item bias (8 I), and reads the step's ids and mask; the
    # fixed-point gradient accumulators are the kernel's scratch, not counted
    nbytes = S * (24.0 * (U + I) * D + 8.0 * I + 4.0 * B * (K + 3))
    ops = S * 6.0 * B * (K + 1) * D
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f'  ML-10M epoch ({S} steps): kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} '
        f'bound_ms={bound_ms:.4f} (operations {ops_ms:.4f}, bytes {bytes_ms:.4f}); '
        f'library_ms=null: no single PyTorch call computes an epoch of sampled-negative '
        f'MF training with Adam')
    profile = profile_epoch_call(f'one ML-10M fused_mf_epoch call ({S} steps)',
                                 lambda: fused_mf_epoch(*tables, *epoch_args(0, S), **kw))
    split = phase_split(f'ML-10M ({S} steps)', lambda tl: fused_mf_epoch_cuda(
        *tables, *epoch_args(0, S), timeline=tl, **kw), S)
    gate_call, gate_steps = engine_epoch_call(gate_model()[0], explicit=False)
    gate_ms = cuda_median_ms(gate_call, warmup=2, runs=21)
    gate_profile = profile_epoch_call(f'one gate-config fused_mf_epoch call ({gate_steps} steps)',
                                      gate_call)
    gate_split = phase_split(f'gate config ({gate_steps} steps)', gate_call, gate_steps)
    log(f'  gate-config epoch ({gate_steps} steps): kernel_ms={gate_ms:.4f}')
    del tables, batches, epoch_fn, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {
        'name': 'fused_mf_epoch',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/fused_mf_epoch.cu',
        'replaces': 'collie_tpu/ops/pallas/fused_mf_epoch.py:148',
        'launches': 0,
        'max_abs_err': max_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': None,
        'gate_ms': gate_ms,
        'device_launches_per_call': [profile, gate_profile],
        'phases_us': [split, gate_split],
        'checked': True,
    }


def explicit_epoch_inputs(seed, U=37, I=53, D=10, S=3, B=7, dup=False, tail=False):
    """Tables, biases, moments and rating batches of
    ``fused_mf_explicit_epoch`` on the card, from a numpy seed; ``tail``
    masks the second half of the last step, whose ids repeat its first."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    users = rng.integers(0, U, (S, B)).astype(np.int32)
    items = rng.integers(0, I, (S, B)).astype(np.int32)
    if dup:
        users[:, :(B + 1) // 2] = users[:, :1]
        items[:, :(B + 1) // 2] = items[:, :1]
    ratings = rng.integers(1, 6, (S, B)).astype(np.float32)
    mask = np.ones((S, B), np.float32)
    if tail:
        users[-1, B // 2:] = users[-1, 0]
        items[-1, B // 2:] = items[-1, 0]
        mask[-1, B // 2:] = 0.0
    arrays = [f(U, D), f(I, D), f(U), f(I), f(U, D, scale=1e-3), np.abs(f(U, D, scale=1e-4)),
              f(I, D, scale=1e-3), np.abs(f(I, D, scale=1e-4))]
    tensors = [torch.from_numpy(a).to(DEVICE) for a in arrays]
    tensors.append(torch.tensor(5, dtype=torch.int32, device=DEVICE))
    tensors += [torch.from_numpy(a).to(DEVICE) for a in (users, items, ratings, mask)]
    return tensors + [0.05, 0.01]


def ml10m_explicit_model(train, seed=7):
    from collie_tpu_torch import InteractionsDataLoader, MatrixFactorizationModel

    loader = InteractionsDataLoader(interactions=train, batch_size=ML10M_BATCH, shuffle=True,
                                    seed=7)
    return MatrixFactorizationModel(train=loader, embedding_dim=ML10M_DIM, lr=EXPLICIT_LR,
                                    loss='mse', y_range=Y_RANGE, seed=seed)


def phase_kernel_explicit_epoch(ml10m_explicit):
    """fused_mf_explicit_epoch against its plain version, and its epoch
    against the generic autograd epoch; returns the kernel's record."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_explicit_epoch,
                                                             fused_mf_explicit_epoch_cuda,
                                                             fused_mf_explicit_epoch_plain)
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns

    log(f'kernel fused_mf_explicit_epoch vs plain (rtol={EPOCH_RTOL}, atol={EPOCH_ATOL_SCALE} '
        f'x max|ref|)')
    reset_launch_counts()
    calls = 0
    max_err = 0.0
    for loss_kind, y_range, B, D, wd, dup, tail in EXPLICIT_EDGES:
        args = explicit_epoch_inputs(B * 10 + D, D=D, B=B, dup=dup, tail=tail)
        kw = dict(loss_kind=loss_kind, y_range=y_range, wd_emb=wd, wd_bias=wd)
        ref = fused_mf_explicit_epoch_plain(*args, **kw)
        out = fused_mf_explicit_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args],
                                      **kw)
        calls += 1
        torch.cuda.synchronize()
        label = f'{loss_kind} y_range={y_range} B={B} D={D} wd={wd} dup={dup} tail={tail}'
        max_err = max(max_err, compare_epoch(label, out, ref, names=EXPLICIT_STATE))

    # the explicit ML-10M shape: the engine's real first epoch, fresh Adam state
    model = ml10m_explicit_model(ml10m_explicit[0])
    specs = model.optimizer_specs()
    epoch_fn, data, S, _ = build_scan_epoch_fns(model, specs, [True] * len(specs),
                                                model.train_loader, shuffle=True)
    batches = epoch_fn.epoch_batches(7, 1)
    params = model.params
    U, D = params['user_embeddings'].shape
    I = params['item_embeddings'].shape[0]
    B = ML10M_BATCH
    kw = dict(loss_kind='mse', y_range=Y_RANGE)
    names = ('user_embeddings', 'item_embeddings', 'user_biases', 'item_biases')

    def state():
        return [params[k].clone() for k in names] \
            + [torch.zeros_like(params[k]) for k in ('user_embeddings', 'user_embeddings',
                                                     'item_embeddings', 'item_embeddings')] \
            + [torch.zeros((), dtype=torch.int32, device=DEVICE)]

    def epoch_args(start, stop):
        return [batches[k][start:stop] for k in ('users', 'items', 'ratings', 'mask')] \
            + [EXPLICIT_LR, 1e-2]

    shape = f'U={U} I={I} D={D} B={B}'
    ref = fused_mf_explicit_epoch_plain(*state(), *epoch_args(0, 3), **kw)
    out = fused_mf_explicit_epoch(*state(), *epoch_args(0, 3), **kw)
    again = fused_mf_explicit_epoch(*state(), *epoch_args(0, 3), **kw)
    calls += 2
    torch.cuda.synchronize()
    max_err = max(max_err, compare_epoch(f'explicit ML-10M shape, 3 steps, {shape}', out, ref,
                                         max_flipped=EXPLICIT_DRIFT_FRACTION,
                                         names=EXPLICIT_STATE))
    compare_epoch('  the same 3 steps, kernel against a second kernel run', again, out,
                  max_flipped=EXPLICIT_DRIFT_FRACTION, names=EXPLICIT_STATE)
    del again
    # one whole epoch, step by step: each kernel step starts from the plain
    # version's state before that step and must hold the tolerance exactly
    worst = 0.0
    current = state()
    plain_losses = []
    for step in range(S):
        ref = fused_mf_explicit_epoch_plain(*current, *epoch_args(step, step + 1), **kw)
        out = fused_mf_explicit_epoch(*[t.clone() for t in current],
                                      *epoch_args(step, step + 1), **kw)
        calls += 1
        torch.cuda.synchronize()
        worst = max(worst, compare_epoch(f'explicit ML-10M shape, step {step}', out, ref,
                                         quiet=True, names=EXPLICIT_STATE))
        plain_losses.append(float(ref[9][0]))
        current = list(ref[:9])
        del out
    max_err = max(max_err, worst)
    log(f'  explicit ML-10M shape, one epoch ({S} steps) held step by step, {shape}: '
        f'max_abs_err={worst:.3g}')
    # the same epoch as one call: MSE makes no discrete choice, so the two
    # trajectories part only by the drift above; the per-step losses must
    # agree within EPOCH_RTOL
    out = fused_mf_explicit_epoch(*state(), *epoch_args(0, S), **kw)
    calls += 1
    torch.cuda.synchronize()
    kernel_losses = out[9].tolist()
    parted = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    drift = [float(((a - b).abs() > EPOCH_RTOL * b.abs() + EPOCH_ATOL_SCALE * b.abs().max())
                   .float().mean()) for a, b in zip(out[:8], current[:8])]
    log(f'  explicit ML-10M shape, the same epoch as one call: per-step losses within '
        f'{parted:.3%} of the plain trajectory (first {kernel_losses[0]:.6f} vs '
        f'{plain_losses[0]:.6f}, last {kernel_losses[-1]:.6f} vs {plain_losses[-1]:.6f}); '
        f'share of elements beyond tolerance: '
        + ', '.join(f'{n} {d:.2e}' for n, d in zip(EXPLICIT_STATE, drift)))
    if not all(np.isfinite(kernel_losses)) or parted > EPOCH_RTOL:
        raise AssertionError(f'explicit ML-10M one-call epoch: losses part by {parted:.3%}')
    del out, ref, current
    check_repeatable(f'explicit ML-10M shape, one epoch ({S} steps) at lr 0.1',
                     lambda: fused_mf_explicit_epoch(*state(), *epoch_args(0, S)[:-2], 0.1,
                                                     1e-2, **kw), EXPLICIT_STATE)
    calls += 2

    tables = state()
    kernel_runs = dict(warmup=1, runs=5)
    kernel_ms = cuda_median_ms(lambda: fused_mf_explicit_epoch(*tables, *epoch_args(0, S), **kw),
                               **kernel_runs)
    calls += sum(kernel_runs.values())
    profile = profile_epoch_call(
        f'one explicit ML-10M fused_mf_explicit_epoch call ({S} steps)',
        lambda: fused_mf_explicit_epoch(*tables, *epoch_args(0, S), **kw))
    split = phase_split(f'explicit ML-10M ({S} steps)', lambda tl: fused_mf_explicit_epoch_cuda(
        *tables, *epoch_args(0, S), timeline=tl, **kw), S)
    gate_call, gate_steps = engine_epoch_call(explicit_gate_model()[0], explicit=True)
    gate_runs = dict(warmup=2, runs=21)
    gate_ms = cuda_median_ms(gate_call, **gate_runs)
    gate_profile = profile_epoch_call(
        f'one explicit gate-config fused_mf_explicit_epoch call ({gate_steps} steps)', gate_call)
    gate_split = phase_split(f'explicit gate config ({gate_steps} steps)', gate_call, gate_steps)
    log(f'  explicit gate-config epoch ({gate_steps} steps): kernel_ms={gate_ms:.4f}')
    calls += 4 + sum(gate_runs.values())
    plain_ms = cuda_median_ms(
        lambda: fused_mf_explicit_epoch_plain(*state(), *epoch_args(0, S), **kw),
        warmup=0, runs=1)
    # the generic autograd epoch (what the JAX package's auto gate runs for
    # explicit data): its train span, without the epoch building
    generic_fn, generic_data, _, _ = build_scan_epoch_fns(
        model, specs, [True] * len(specs), model.train_loader, shuffle=True, fused=False)
    opt_states = tuple(spec.transform.init({k: params[k] for k in spec.keys})
                       for spec in specs)
    generic = []
    for _ in range(3):
        generic_fn(dict(params), opt_states, generic_data, 7, 1)
        generic.append(generic_fn.split_ms()['train_ms'])
    generic_ms = statistics.median(generic[1:])
    if fused_mf_explicit_epoch.launches != calls or generic_fn.fused:
        raise AssertionError(f'{fused_mf_explicit_epoch.launches} explicit kernel launches for '
                             f'{calls} calls; the fused=False epoch launched the kernel')
    # least traffic per step (the kernel header's count): the dense update
    # reads and writes both tables and both moments (24 (U + I) D bytes) and
    # both bias vectors (8 (U + I)), and reads the step's ids, ratings and
    # mask (16 B); the fixed-point gradient accumulators are not counted
    nbytes = S * (24.0 * (U + I) * D + 8.0 * (U + I) + 16.0 * B)
    ops = S * 8.0 * B * D
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f'  explicit ML-10M epoch ({S} steps): kernel_ms={kernel_ms:.4f} '
        f'plain_ms={plain_ms:.4f} generic_ms={generic_ms:.4f} (fused=False, train span; runs '
        f'{[round(t, 3) for t in generic]}) bound_ms={bound_ms:.4f} (operations '
        f'{ops_ms:.4f}, bytes {bytes_ms:.4f}); library_ms=null: no single PyTorch call '
        f'computes an epoch of MF training with Adam')
    del tables, batches, epoch_fn, generic_fn, data, generic_data, model, opt_states
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {
        'name': 'fused_mf_explicit_epoch',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/fused_mf_epoch.cu',
        'replaces': 'collie_tpu/ops/pallas/fused_mf_epoch.py:337',
        'launches': 0,
        'max_abs_err': max_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': None,
        'generic_epoch_ms': generic_ms,
        'gate_ms': gate_ms,
        'device_launches_per_call': [profile, gate_profile],
        'phases_us': [split, gate_split],
        'checked': True,
    }


def phase_training(ml10m, record: dict):
    """The training path: the gate configuration for 10 epochs, then the
    ML-10M-scale configuration for 3, both through ``CollieTrainer``."""
    from collie_tpu_torch import (CollieTrainer, MatrixFactorizationModel, auc,
                                  evaluate_in_batches, mapk, mrr)
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch

    with open(os.path.join('benchmarks', 'gates.json')) as f:
        gates = {name: spec['gate'] for name, spec in json.load(f).items()}

    # (a) the quality-gate configuration
    model, train, test = gate_model()
    reset_launch_counts()
    trainer = CollieTrainer(model, max_epochs=GATE_EPOCHS, verbosity=0, seed=42)
    trainer.fit(model)
    torch.cuda.synchronize()
    launches = fused_mf_epoch.launches
    epochs = trainer.num_epochs_completed
    if launches != epochs or epochs != GATE_EPOCHS:
        raise AssertionError(f'gate fit: {launches} kernel launches for {epochs} epochs')
    map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], test, model, k=K,
                                              batch_size=256, verbose=False)
    log(f'gate config fit ({train.num_interactions} train interactions, {GATE_EPOCHS} '
        f'epochs): {trainer.last_fit_examples_per_sec:,.0f} examples/s; per epoch ms '
        f'(shuffle, sampler, kernel): '
        f'{[tuple(round(e[k], 3) for k in SPLIT) for e in trainer.epoch_log]}; '
        f'MAP@{K}={map_k:.5f} MRR={mrr_v:.5f} AUC={auc_v:.5f} (gates {gates["mapk"]:.5f}, '
        f'{gates["mrr"]:.5f}, {gates["auc"]:.5f}); fused_mf_epoch launches {launches}')
    for name, value in (('mapk', map_k), ('mrr', mrr_v), ('auc', auc_v)):
        if not value > gates[name]:
            raise AssertionError(f'gate config: {name}={value} does not clear {gates[name]}')
    del model, trainer

    # (b) the ML-10M-scale configuration
    train, _, test = ml10m
    model = ml10m_model(train)
    torch.cuda.reset_peak_memory_stats()
    trainer = CollieTrainer(model, max_epochs=ML10M_EPOCHS, verbosity=0, seed=7)
    start = time.perf_counter()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    epochs += trainer.num_epochs_completed
    launches = fused_mf_epoch.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sampled = _kernel_counts()[SAMPLER_WRAPPER]
    if launches != epochs or trainer.num_epochs_completed != ML10M_EPOCHS or sampled != epochs:
        raise AssertionError(f'{launches} kernel launches, {sampled} sampler kernel launches '
                             f'for {epochs} epochs')
    log(f'ML-10M-scale fit ({train.num_interactions} train interactions, batch {ML10M_BATCH}, '
        f'{ML10M_EPOCHS} epochs): {fit_s:.2f}s incl. epoch-data build, '
        f'{trainer.last_fit_examples_per_sec:,.0f} examples/s, peak device memory '
        f'{peak_gb:.3f} GB')
    for e in trainer.epoch_log:
        host_ms = e['seconds'] * 1e3 - sum(e[k] for k in SPLIT)
        log(f'  epoch {e["epoch"]}: {e["seconds"] * 1e3:.3f} ms = shuffle {e["shuffle_ms"]:.3f} '
            f'+ sampler {e["sample_ms"]:.3f} + kernel {e["train_ms"]:.3f} + host {host_ms:.3f}')

    sub = ml10m_eval_users(test)
    map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], sub, model, k=K,
                                              batch_size=512, verbose=False)
    untrained = MatrixFactorizationModel(train=model.train_loader, embedding_dim=ML10M_DIM,
                                         lr=1e-1, loss='adaptive', seed=99)
    untrained_map = evaluate_in_batches([mapk], sub, untrained, k=K, batch_size=512,
                                        verbose=False)
    torch.cuda.synchronize()
    log(f'  {ML10M_EVAL_USERS} test users: MAP@{K}={map_k:.5f} MRR={mrr_v:.5f} AUC={auc_v:.5f} '
        f'(untrained MAP@{K}={untrained_map:.5f}); fused_mf_epoch launches over both fits '
        f'{launches}, the bucketed sampler kernel {sampled}, for {epochs} epochs')
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in (map_k, mrr_v, auc_v)):
        raise AssertionError(f'metrics out of range: {map_k}, {mrr_v}, {auc_v}')
    if not map_k > untrained_map:
        raise AssertionError(f'trained MAP@{K} {map_k} does not beat untrained {untrained_map}')
    record['launches'] = launches
    record['shuffle_launches'] = _kernel_counts()[SHUFFLE_WRAPPER]
    return {'mapk': map_k, 'untrained_mapk': untrained_map, 'sampler_launches': sampled}


def ml10m_eval_users(test):
    """The ``ML10M_EVAL_USERS`` test users the ML-10M-scale fits are
    evaluated on, drawn with a fixed seed, as an ``Interactions``."""
    from collie_tpu_torch import Interactions

    rng = np.random.default_rng(0)
    sample = np.sort(rng.choice(np.unique(test.mat.row), ML10M_EVAL_USERS, replace=False))
    keep = np.isin(test.mat.row, sample)
    return Interactions(users=test.mat.row[keep], items=test.mat.col[keep],
                        num_users=test.num_users, num_items=test.num_items,
                        allow_missing_ids=True, check_num_negative_samples_is_valid=False,
                        seed=0)


def phase_explicit_training(ml10m_explicit, record: dict):
    """The explicit training path: (c) the explicit gate configuration for
    10 epochs, (d) the explicit ML-10M-scale configuration for 3, both
    through ``CollieTrainer`` and ``explicit_evaluate_in_batches``."""
    from collie_tpu_torch import CollieTrainer, explicit_evaluate_in_batches
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_explicit_epoch

    with open(os.path.join('benchmarks', 'gates.json')) as f:
        mse_gate = json.load(f)['mse']['gate']

    def report(label, trainer, examples):
        log(f'{label} fit ({examples} train ratings, {trainer.num_epochs_completed} epochs): '
            f'{trainer.last_fit_examples_per_sec:,.0f} examples/s')
        for e in trainer.epoch_log:
            host_ms = e['seconds'] * 1e3 - sum(e[k] for k in SPLIT)
            log(f'  epoch {e["epoch"]}: {e["seconds"] * 1e3:.3f} ms = shuffle '
                f'{e["shuffle_ms"]:.3f} + batch gather {e["sample_ms"]:.3f} + kernel '
                f'{e["train_ms"]:.3f} + host {host_ms:.3f}')

    # (c) the explicit quality-gate configuration
    model, train, test = explicit_gate_model()
    reset_launch_counts()
    trainer = CollieTrainer(model, max_epochs=GATE_EPOCHS, verbosity=0, seed=0)
    trainer.fit(model)
    torch.cuda.synchronize()
    epochs = trainer.num_epochs_completed
    if fused_mf_explicit_epoch.launches != epochs or epochs != GATE_EPOCHS:
        raise AssertionError(f'explicit gate fit: {fused_mf_explicit_epoch.launches} kernel '
                             f'launches for {epochs} epochs')
    mse, mae = explicit_evaluate_in_batches(['mse', 'mae'], test, model, verbose=False)
    report('explicit gate config', trainer, train.num_interactions)
    stars = model([0] * 5, list(range(5)))
    log(f'  test MSE={mse:.5f} MAE={mae:.5f} (gate: MSE < {mse_gate:.5f}); predicted stars '
        f'for user 0, items 0-4: {[round(float(v), 3) for v in stars]}; '
        f'fused_mf_explicit_epoch launches {fused_mf_explicit_epoch.launches}')
    if not mse < mse_gate:
        raise AssertionError(f'explicit gate config: test MSE {mse} does not clear {mse_gate}')
    if not (np.all(np.isfinite(stars)) and np.all((stars >= Y_RANGE[0]) & (stars <= Y_RANGE[1]))):
        raise AssertionError(f'predicted stars outside y_range: {stars}')
    del model, trainer

    # (d) the explicit ML-10M-scale configuration
    train, _, test = ml10m_explicit
    model = ml10m_explicit_model(train)
    torch.cuda.reset_peak_memory_stats()
    trainer = CollieTrainer(model, max_epochs=ML10M_EPOCHS, verbosity=0, seed=7)
    start = time.perf_counter()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    epochs += trainer.num_epochs_completed
    launches = fused_mf_explicit_epoch.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != epochs or trainer.num_epochs_completed != ML10M_EPOCHS:
        raise AssertionError(f'{launches} explicit kernel launches for {epochs} epochs')
    report(f'explicit ML-10M-scale (batch {ML10M_BATCH})', trainer, train.num_interactions)
    log(f'  fit {fit_s:.2f}s incl. epoch-data build; peak device memory {peak_gb:.3f} GB')
    eval_kw = dict(batch_size=ML10M_BATCH, verbose=False)
    start = time.perf_counter()
    mse, mae = explicit_evaluate_in_batches(['mse', 'mae'], test, model, **eval_kw)
    eval_s = time.perf_counter() - start
    untrained = ml10m_explicit_model(train, seed=99)
    untrained_mse = explicit_evaluate_in_batches(['mse'], test, untrained, **eval_kw)
    torch.cuda.synchronize()
    log(f'  {test.num_interactions} test ratings: MSE={mse:.5f} MAE={mae:.5f} in {eval_s:.2f}s '
        f'(untrained MSE={untrained_mse:.5f}); fused_mf_explicit_epoch launches over both '
        f'fits {launches} for {epochs} epochs')
    if not all(np.isfinite(v) for v in (mse, mae)):
        raise AssertionError(f'explicit metrics not finite: {mse}, {mae}')
    if not mse < untrained_mse:
        raise AssertionError(f'trained MSE {mse} is not below untrained {untrained_mse}')
    record['launches'] = launches
    record['shuffle_launches'] = _kernel_counts()[SHUFFLE_WRAPPER]


class _LossLog:
    """A trainer logger keeping each epoch's train loss."""

    def __init__(self):
        self.losses = []

    def log_metrics(self, metrics, step):
        self.losses.append(metrics['train_loss_epoch'])


def zoo_data():
    """The zoo-scale data (``ZOO_DATA``, 90/5/5 split), the train CSR for
    seen filtering and the ``REQUEST_USERS`` users of each request."""
    from collie_tpu_torch import stratified_split
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions

    start = time.perf_counter()
    train, _, test = stratified_split(generate_implicit_interactions(**ZOO_DATA), val_p=0.05,
                                      test_p=0.05, seed=7, force_split=True)
    rng = np.random.default_rng(ZOO_DATA['seed'])
    users = np.sort(rng.choice(train.num_users, REQUEST_USERS, replace=False))
    log(f'zoo-scale data: {train.num_interactions} train / {test.num_interactions} test '
        f'interactions, {train.num_users} users x {train.num_items} items, batch {ZOO_BATCH}, '
        f'K={ZOO_DATA["num_negative_samples"]} ({time.perf_counter() - start:.1f}s on the host)')
    return {'train': train, 'test': test, 'seen_csr': train.mat.tocsr(), 'users': users}


def zoo_loader(train):
    from collie_tpu_torch import InteractionsDataLoader

    return InteractionsDataLoader(interactions=train, batch_size=ZOO_BATCH, shuffle=True,
                                  seed=42)


def check_blockwise_recommend(name, model, zoo) -> Tuple[float, int]:
    """One ``recommend`` of the zoo's request users with seen filtering (the
    blockwise path, or the dense one for a model that scores a block
    itself), held against a stable top-k of ``score_item_block`` over the
    whole catalog with the seen items masked, and its selections against
    ``recommend_selections``; returns its ms and its selections."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import (NEG_INF, stable_topk,
                                                               stable_topk_plain)
    from collie_tpu_torch.retrieval import recommend

    users, seen_csr = zoo['users'], zoo['seen_csr']
    expected = recommend_selections(model, len(users), True)
    before = stable_topk.launches
    t0 = time.perf_counter()
    ids, scores = recommend(model, users, k=K)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    selections = stable_topk.launches - before
    if selections != expected:
        raise AssertionError(f'{name}: recommend made {selections} selections, expected '
                             f'{expected}')
    with torch.no_grad():
        block = model.score_item_block(model.params, model._ids(users),
                                       torch.arange(zoo['train'].num_items, device=model.device))
        rows = seen_csr[users]
        r = np.repeat(np.arange(len(users)), np.diff(rows.indptr))
        block[torch.as_tensor(r, device=model.device),
              torch.as_tensor(rows.indices.astype(np.int64), device=model.device)] = NEG_INF
        ref_scores, ref_ids = stable_topk_plain(block, K)
    torch.cuda.synchronize()
    if not np.array_equal(ids, ref_ids.cpu().numpy()):
        raise AssertionError(f'{name}: recommend ids differ from the full-catalog top-k')
    if not np.allclose(scores, ref_scores.cpu().numpy(), rtol=RTOL, atol=ATOL):
        raise AssertionError(f'{name}: recommend scores differ from the full-catalog top-k')
    return request_ms, selections


def phase_zoo(smi: str, zoo: dict) -> dict:
    """The single-stage zoo and embedding dropout: each model of
    ``ZOO_MODELS`` built on the card at the zoo-scale configuration, fit for
    ``ZOO_EPOCHS`` through ``CollieTrainer`` (the generic autograd epoch: no
    zoo model, nor an MF with dropout, is in an epoch kernel's envelope;
    each epoch draws through the bucketed sampler kernel),
    evaluated before and after, and asked for one ``recommend`` of
    ``REQUEST_USERS`` users with seen filtering (the blockwise path for the
    zoo), held against a stable top-k of ``score_item_block`` over the
    whole catalog with the seen items masked."""
    import collie_tpu_torch
    from collie_tpu_torch import CollieTrainer, auc, evaluate_in_batches, mapk, mrr

    train, test = zoo['train'], zoo['test']
    reset_launch_counts()
    results, selections = {}, 0
    for name, kwargs in ZOO_MODELS:
        model = getattr(collie_tpu_torch, name)(train=zoo_loader(train), seed=42, **kwargs)
        if model.device.type != DEVICE:
            raise AssertionError(f'{name} built on {model.device}')
        auc_before = evaluate_in_batches([auc], test, model, k=K, verbose=False)
        losses = _LossLog()
        trainer = CollieTrainer(model, max_epochs=ZOO_EPOCHS, verbosity=0, seed=42,
                                logger=losses, enable_model_summary=False)
        trainer.fit(model)
        torch.cuda.synchronize()
        per_epoch = [train.num_interactions / e['seconds'] for e in trainer.epoch_log]
        t0 = time.perf_counter()
        map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], test, model, k=K,
                                                  verbose=False)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        request_ms, request_selections = check_blockwise_recommend(name, model, zoo)
        selections += request_selections
        log(f'zoo {name} {kwargs}: examples/s per epoch {[round(x) for x in per_epoch]} '
            f'({smi}); per epoch ms (shuffle, sampler, train): '
            f'{[tuple(round(e[k], 3) for k in SPLIT) for e in trainer.epoch_log]}; '
            f'train loss per epoch {[round(x, 5) for x in losses.losses]}; '
            f'{len(np.unique(test.mat.row))} test users: AUC {auc_before:.5f} before the fit, '
            f'MAP@{K}={map_k:.5f} MRR={mrr_v:.5f} AUC={auc_v:.5f} after ({eval_s:.2f}s); '
            f'recommend of {REQUEST_USERS} users (filter_seen) {request_ms:.1f} ms, '
            f'{request_selections} selections')
        if len(losses.losses) != ZOO_EPOCHS or not np.all(np.isfinite(losses.losses)):
            raise AssertionError(f'{name}: train losses {losses.losses}')
        if not (np.isfinite(auc_v) and auc_v > auc_before):
            raise AssertionError(f'{name}: test AUC {auc_v} after the fit, {auc_before} before')
        results[name] = {'examples_per_s': per_epoch, 'losses': list(losses.losses),
                         'auc_before': auc_before, 'mapk': map_k, 'mrr': mrr_v, 'auc': auc_v}
        if name in ZOO_PROFILED:
            trainer.max_epochs += 1
            profile_epoch_call(f'zoo {name}, one more epoch of the fit', lambda: trainer.fit(model))
        del model, trainer
        torch.cuda.empty_cache()
    launches = _kernel_counts()
    log(f'zoo phase: kernel launches {launches} (the zoo and MF with dropout train through '
        f'the generic epoch, shuffled by the cycle-walk kernel, and serve through the dense '
        f'and blockwise paths)')
    sampled = ZOO_EPOCHS * len(ZOO_MODELS) + len(ZOO_PROFILED)
    if launches.pop(SHUFFLE_WRAPPER) < 1 or launches.pop('stable_topk') != selections \
            or launches.pop(SAMPLER_WRAPPER) != sampled or any(launches.values()):
        raise AssertionError(f'zoo path: kernel launches {_kernel_counts()}, expected '
                             f'{selections} selections, {sampled} sampler launches')
    results['selections'] = selections
    results['sampler_launches'] = sampled
    return results


def _trained_keys(model) -> set:
    """The params the current stage's optimizer specs train."""
    return {k for spec in model.optimizer_specs() if spec.stage in (None, model.current_stage)
            for k in spec.keys}


def _save_and_load(name, model, users: np.ndarray) -> None:
    """``save_model`` then a load on the card: the loaded model is in the
    final stage, holds equal params and gives equal scores."""
    import shutil

    import collie_tpu_torch

    path = os.path.join('data', f'chip_smoke_{name}_{os.getpid()}')
    if name == 'ColdStartModel':
        path += '.npz'
    try:
        model.save_model(path)
        loaded = getattr(collie_tpu_torch, name)(load_model_path=path)
    finally:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.unlink(path)
    if loaded.device.type != DEVICE or loaded.current_stage != model.current_stage:
        raise AssertionError(f'{name}: loaded on {loaded.device} in stage '
                             f'{loaded.current_stage}, saved in {model.current_stage}')
    for key, value in model.params.items():
        if not torch.equal(value, loaded.params[key]):
            raise AssertionError(f'{name}: the save and load changed {key}')
    items = (users * 37) % model.hparams['num_items']
    if not np.allclose(loaded(users, items), model(users, items), rtol=RTOL, atol=ATOL):
        raise AssertionError(f'{name}: the loaded model scores differently')


def hold_donor_fit(donor, trainer) -> dict:
    """The donor's fit by ``trainer``, held against ``fused_mf_epoch_plain``
    before it runs: the very batches the fit draws (the trainer's seed, each
    of its epochs) at the donor's shape, each step of the kernel starting
    from the plain version's state before that step and held as the ML-10M
    epoch is (``compare_epoch`` with ``MAX_FLIPPED_FRACTION``), and the first
    3 steps also as one launch.  Returns the max abs error and the steps
    held."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch, fused_mf_epoch_plain
    from collie_tpu_torch.training.scan_engine import _fused_epoch_config, build_scan_epoch_fns

    specs = donor.optimizer_specs()
    active = [True] * len(specs)
    loader = donor.train_loader
    epoch_fn, _, S, _ = build_scan_epoch_fns(donor, specs, active, loader, shuffle=loader.shuffle,
                                             dedup_rounds=trainer.exact_sampling_dedup_rounds)
    cfg = _fused_epoch_config(donor, specs, active, loader, None)
    if not epoch_fn.fused or cfg is None or cfg['meta_names']:
        raise AssertionError('the donor is outside fused_mf_epoch\'s envelope')
    lr_emb = specs[cfg['emb_idx']].transform.lr
    lr_bias = specs[cfg['bias_idx']].transform.lr
    params = donor.params
    current = [params[k].clone() for k in ('user_embeddings', 'item_embeddings', 'item_biases')] \
        + [torch.zeros_like(params[k]) for k in ('user_embeddings', 'user_embeddings',
                                                 'item_embeddings', 'item_embeddings')] \
        + [torch.zeros((), dtype=torch.int32, device=DEVICE)]
    U, D = params['user_embeddings'].shape
    worst, steps = 0.0, 0
    for epoch in range(1, trainer.max_epochs + 1):
        batches = epoch_fn.epoch_batches(trainer.seed, epoch)
        K = batches['neg_items'].shape[-1]
        kw = dict(K=K, adaptive=cfg['adaptive'], loss_kind=cfg['loss_kind'],
                  wd_emb=cfg['wd_emb'], wd_bias=cfg['wd_bias'])

        def epoch_args(start, stop):
            return [batches[k][start:stop] for k in ('users', 'pos_items', 'neg_items', 'mask')] \
                + [lr_emb, lr_bias, None]
        if epoch == 1:
            # the first 3 steps as one launch: the kernel's own step loop
            ref = fused_mf_epoch_plain(*current, *epoch_args(0, 3), **kw)
            out = fused_mf_epoch(*[t.clone() for t in current], *epoch_args(0, 3), **kw)
            torch.cuda.synchronize()
            one_launch = compare_epoch('donor epoch 1, its first 3 steps as one launch', out,
                                       ref, max_flipped=MAX_FLIPPED_FRACTION)
        for step in range(S):
            args = epoch_args(step, step + 1)
            ref = fused_mf_epoch_plain(*current, *args, **kw)
            out = fused_mf_epoch(*[t.clone() for t in current], *args, **kw)
            torch.cuda.synchronize()
            worst = max(worst, compare_epoch(f'donor epoch {epoch}, step {step}', out, ref,
                                             max_flipped=MAX_FLIPPED_FRACTION, quiet=True))
            current = list(ref[:8])
            steps += 1
    log(f'  multi_stage donor fit ({steps} steps: epochs 1 to {trainer.max_epochs}, {S} steps '
        f'each) held step by step against fused_mf_epoch_plain, U={U} '
        f'I={params["item_embeddings"].shape[0]} D={D} B={loader.batch_size} K={K} '
        f'{cfg["loss_kind"]} adaptive={cfg["adaptive"]}: max_abs_err={worst:.3g}')
    return {'max_abs_err': max(worst, one_launch), 'steps': steps}


def phase_multi_stage(smi: str, zoo: dict) -> dict:
    """The multi-stage models at the zoo-scale configuration: HybridModel
    through its three stages, HybridPretrainedModel on an MF donor fit for
    ``MULTI_STAGE_DONOR_EPOCHS`` through ``fused_mf_epoch`` (first held
    step by step against its plain version on the fit's own batches; the
    launch count of the fit must equal the donor's epochs, and the donor's
    test AUC must rise), ColdStartModel through its two.
    Each stage's fit must leave the tables it gates out bitwise unchanged;
    just after ColdStart's ``advance_stage`` the per-item tables must equal
    the gathered bucket rows exactly; the HybridPretrained fit must leave the
    donor unchanged.  Each model: finite losses, test AUC rising over the
    fit, one blockwise ``recommend`` held against a full-catalog top-k, and
    a save and load on the card in the final stage with equal scores."""
    import collie_tpu_torch
    from collie_tpu_torch import CollieTrainer, MatrixFactorizationModel, auc, \
        evaluate_in_batches, mapk, mrr
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch

    start = time.perf_counter()
    train, test = zoo['train'], zoo['test']
    n = train.num_interactions
    item_metadata = np.random.default_rng(0).normal(
        size=(train.num_items, MULTI_STAGE_META_COLS)).astype(np.float32)
    item_buckets = np.arange(train.num_items) % min(MULTI_STAGE_BUCKETS, train.num_items)
    donor = MatrixFactorizationModel(train=zoo_loader(train), embedding_dim=ZOO_DIM, lr=1e-1,
                                     loss='adaptive', seed=42)
    donor_trainer = CollieTrainer(donor, max_epochs=MULTI_STAGE_DONOR_EPOCHS, verbosity=0, seed=42,
                                  enable_model_summary=False)
    results = {'donor': hold_donor_fit(donor, donor_trainer)}
    results['donor']['auc_before'] = evaluate_in_batches([auc], test, donor, k=K, verbose=False)
    reset_launch_counts()
    selections = 0
    for name, kwargs, plan in MULTI_STAGE_MODELS:
        extra, donor_before = {}, None
        if name == 'ColdStartModel':
            extra['item_buckets'] = item_buckets
        else:
            extra['item_metadata'] = item_metadata
        if name == 'HybridPretrainedModel':
            donor_trainer.fit(donor)
            torch.cuda.synchronize()
            if not donor_trainer.epoch_log or fused_mf_epoch.launches != len(
                    donor_trainer.epoch_log):
                raise AssertionError(f'donor fit: {fused_mf_epoch.launches} fused_mf_epoch '
                                     f'launches for {len(donor_trainer.epoch_log)} epochs')
            donor_auc = evaluate_in_batches([auc], test, donor, k=K, verbose=False)
            donor_auc_before = results['donor']['auc_before']
            log(f'multi_stage donor MF: examples/s per epoch '
                f'{[round(n / e["seconds"]) for e in donor_trainer.epoch_log]} ({smi}) through '
                f'fused_mf_epoch ({fused_mf_epoch.launches} launches); test AUC '
                f'{donor_auc_before:.5f} before the fit, {donor_auc:.5f} after')
            if not (np.isfinite(donor_auc) and donor_auc > donor_auc_before):
                raise AssertionError(f'donor: test AUC {donor_auc} after the fit, '
                                     f'{donor_auc_before} before')
            results['donor']['auc'] = donor_auc
            extra['trained_model'] = donor
            donor_before = {k: v.clone() for k, v in donor.params.items()}
        model = getattr(collie_tpu_torch, name)(train=zoo_loader(train), seed=42, **kwargs,
                                                **extra)
        if model.device.type != DEVICE:
            raise AssertionError(f'{name} built on {model.device}')
        auc_before = evaluate_in_batches([auc], test, model, k=K, verbose=False)
        losses = _LossLog()
        trainer = CollieTrainer(model, max_epochs=0, verbosity=0, seed=42, logger=losses,
                                enable_model_summary=False)
        stages = []
        for stage, epochs in plan:
            if stage is not None and model.current_stage != stage:
                params = model.params
                model.advance_stage()
                if name == 'ColdStartModel':
                    buckets = torch.as_tensor(item_buckets, device=model.device)
                    for key in ('embeddings', 'biases'):
                        if not torch.equal(model.params[f'item_{key}'],
                                           params[f'item_bucket_{key}'][buckets]):
                            raise AssertionError(f'{name}: item_{key} after advance_stage are '
                                                 f'not the gathered bucket rows')
            gated = {k: v.clone() for k, v in model.params.items()
                     if k not in _trained_keys(model)}
            trainer.max_epochs += epochs
            trainer.fit(model)
            torch.cuda.synchronize()
            for key, value in gated.items():
                if not torch.equal(model.params[key], value):
                    raise AssertionError(f'{name}: {key} changed in stage {stage}, which '
                                         f'gates it out')
            stages.append({'stage': stage, 'gated': sorted(gated),
                           'examples_per_s': [n / e['seconds'] for e in trainer.epoch_log],
                           'split_ms': [tuple(round(e[k], 3) for k in SPLIT)
                                        for e in trainer.epoch_log]})
        t0 = time.perf_counter()
        map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], test, model, k=K,
                                                  verbose=False)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        request_ms, request_selections = check_blockwise_recommend(name, model, zoo)
        selections += request_selections
        for stage in stages:
            log(f'multi_stage {name} stage {stage["stage"]}: examples/s per epoch '
                f'{[round(x) for x in stage["examples_per_s"]]} ({smi}); per epoch ms (shuffle, '
                f'sampler, train): {stage["split_ms"]}; bitwise unchanged: {stage["gated"]}')
        log(f'multi_stage {name} {kwargs}: train loss per epoch '
            f'{[round(x, 5) for x in losses.losses]}; {len(np.unique(test.mat.row))} test '
            f'users: AUC {auc_before:.5f} before the fit, MAP@{K}={map_k:.5f} MRR={mrr_v:.5f} '
            f'AUC={auc_v:.5f} after ({eval_s:.2f}s); recommend of {REQUEST_USERS} users '
            f'(filter_seen) {request_ms:.1f} ms ({smi})')
        if len(losses.losses) != sum(e for _, e in plan) or not np.all(np.isfinite(losses.losses)):
            raise AssertionError(f'{name}: train losses {losses.losses}')
        if not (np.isfinite(auc_v) and auc_v > auc_before):
            raise AssertionError(f'{name}: test AUC {auc_v} after the fit, {auc_before} before')
        if donor_before is not None:
            for key, value in donor_before.items():
                if not torch.equal(extra['trained_model'].params[key], value):
                    raise AssertionError(f'{name}: the fit changed the donor\'s {key}')
        _save_and_load(name, model, zoo['users'])
        results[name] = {'stages': stages, 'losses': list(losses.losses),
                         'auc_before': auc_before, 'mapk': map_k, 'mrr': mrr_v, 'auc': auc_v,
                         'recommend_ms': request_ms}
        if name == 'HybridModel':
            trainer.max_epochs += 1
            profile_epoch_call(f'multi_stage {name}, one more epoch in stage {model.current_stage}',
                               lambda: trainer.fit(model))
        del model, trainer, extra
        torch.cuda.empty_cache()
    launches = {w.__name__: w.launches for w in kernel_wrappers()}
    log(f'multi_stage phase: kernel launches {launches} (the donor MF\'s fit through '
        f'fused_mf_epoch, {MULTI_STAGE_DONOR_EPOCHS} epoch; the multi-stage models train through '
        f'the generic epoch and serve through the blockwise path); '
        f'{time.perf_counter() - start:.1f}s')
    expected = {w.__name__: 0 for w in kernel_wrappers()}
    expected['fused_mf_epoch'] = MULTI_STAGE_DONOR_EPOCHS
    expected[SHUFFLE_WRAPPER] = launches[SHUFFLE_WRAPPER]
    expected['stable_topk'] = selections
    # the donor's epoch, every stage's epochs and HybridModel's profiled one
    expected[SAMPLER_WRAPPER] = MULTI_STAGE_DONOR_EPOCHS + 1 + sum(
        epochs for _, _, plan in MULTI_STAGE_MODELS for _, epochs in plan)
    if launches != expected or not launches[SHUFFLE_WRAPPER]:
        raise AssertionError(f'multi_stage kernel launches {launches}, expected {expected}')
    results['selections'] = selections
    results['sampler_launches'] = expected[SAMPLER_WRAPPER]
    return results


class _MetricLog:
    """A trainer logger keeping each epoch's and each logged step's train
    loss."""

    def __init__(self):
        self.epochs, self.steps = [], []

    def log_metrics(self, metrics, step):
        if 'train_loss_epoch' in metrics:
            self.epochs.append(metrics['train_loss_epoch'])
        if 'train_loss_step' in metrics:
            self.steps.append(metrics['train_loss_step'])


class _MomentumSGD:
    """A custom optimizer factory's transform: optax.sgd(learning_rate,
    momentum=0.9) written to the port's ``Transform`` contract."""

    def __init__(self, learning_rate, momentum=0.9):
        self.learning_rate, self.momentum = learning_rate, momentum

    def init(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads, state, params):
        trace = {k: grads[k] + self.momentum * state[k] for k in grads}
        return {k: -self.learning_rate * t for k, t in trace.items()}, trace


#: the cycle-walk's wrapper in ``_kernel_counts``
SHUFFLE_WRAPPER = 'feistel_permutation_from_keys'
#: the bucketed sampler kernel's dispatcher in ``_kernel_counts``: one
#: launch for each epoch a fit draws through the bucketed sampler, training
#: and validation alike (a whole fit draws every epoch of the blocks it
#: dispatched, also those after an early stop)
SAMPLER_WRAPPER = 'complement_sample_negatives_bucketed_grouped'
#: 8(a)'s launches of the sampler kernel: its pass through the reorder
#: wrapper and its held launch, each checked once and timed (1 + 5 calls)
SAMPLER_CHECK_LAUNCHES = 2 * (1 + 1 + 5)


def _kernel_counts() -> dict:
    return {w.__name__: w.launches for w in kernel_wrappers()}


def _count_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _kernel_counts().items()}


def drawn_epochs(fit: dict) -> int:
    """The epochs a ``record_fit`` of an implicit model drew, each through
    the bucketed sampler kernel once: every epoch its blocks dispatched (the
    per-epoch loop: every epoch it ran), twice with a validation loader."""
    return len(fit['ran']) * (2 if fit['model'].val_loader is not None else 1)


def sampler_problem(chunk: int, device):
    """The bucketed tables of interactions whose degrees fill every bucket
    from width 128 to 16,384 on 9,000 items: a user holding every item,
    users of degree 5,000, 3,000, 1,500, 700, 300, 129, 128 and 127, 400 of
    1 to 60, and an odd number of pairs; built on ``device`` with
    ``chunk``.  Returns ``(bucket_specs, row_counts, users_g, num_items)``."""
    from collie_tpu_torch.ops.device_sampling import build_bucketed_complement_tables_torch

    rng = np.random.default_rng(chunk)
    num_items = 9_000
    degrees = [num_items, 5_000, 3_000, 1_500, 700, 300, 129, 128, 127]
    degrees += rng.integers(1, 61, 400).tolist()
    degrees += [1] * (1 - sum(degrees) % 2)
    users = np.repeat(np.arange(len(degrees)), degrees)
    items = np.concatenate([rng.choice(num_items, d, replace=False) for d in degrees])
    order = rng.permutation(users.shape[0])
    specs, counts, users_g, _ = build_bucketed_complement_tables_torch(
        torch.as_tensor(users[order], device=device), torch.as_tensor(items[order], device=device),
        len(degrees), num_items, chunk=chunk)
    return specs, counts, users_g, num_items


def sampler_uniforms(n_slots: int, width: int, seed: int) -> np.ndarray:
    """Float32 uniforms ``[n_slots, width]`` built to repeat values within a
    row: every third row's first four from one uniform, every ninth row's
    all of them (so spares collide again and duplicates remain), and the
    ends of the range, 0 and the largest float32 below 1."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_slots, width), dtype=np.float32)
    u[::3, 1:4] = u[::3, :1]
    u[::9] = u[::9, :1]
    u[5::7, -1] = np.nextafter(np.float32(1), np.float32(0))
    u[6::7, 0] = 0
    return u


def check_samplers(train, smi: str) -> dict:
    """8(a): the bucketed and CSR tables of the ML-10M-scale train set on
    the card, the bucketed ones from the device builder and equal to the
    same builder run on the CPU copies of the ids; the CSR sampler on one
    epoch's per-position uniforms (the engine's reorder layout, 2 rounds
    with dedup 1) equal to a numpy host reference on
    ``SAMPLER_HOST_CHECKS`` positions, and no positive among its or the
    bucketed sampler's negatives; the CSR pass timed beside the bucketed
    pass over the same epoch."""
    from collie_tpu_torch.ops import device_sampling as sampling

    mat = train.mat.tocsr()
    mat.sort_indices()
    num_items, k = train.num_items, ML10M_DATA['num_negative_samples']

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=DEVICE)

    ids = (train.mat.row.astype(np.int64), train.mat.col.astype(np.int64))
    plan = sampling.plan_bucketed_complement_tables(*map(put, ids), *mat.shape)
    tables = sampling.build_bucketed_complement_tables_torch(*map(put, ids), *mat.shape,
                                                             plan=plan)
    ref = sampling.build_bucketed_complement_tables_torch(*map(torch.as_tensor, ids),
                                                          *mat.shape)
    flat = [t for spec in tables[0] for t in spec] + list(tables[1:])
    flat_ref = [t for spec in ref[0] for t in spec] + list(ref[1:])
    if len(tables[0]) != len(ref[0]) or not all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b) for a, b in zip(flat, flat_ref)):
        raise AssertionError('the bucketed tables built on the card differ from the CPU build')
    bucket_specs, counts, users_g, pos_of = tables
    indptr_np, shifted_np = sampling.build_complement_tables(mat)
    indptr, shifted = put(indptr_np), put(shifted_np)
    keys = sampling.csr_keys(indptr, shifted)
    nbytes = {
        'bucketed': sum(t.numel() * t.element_size() for spec in bucket_specs for t in spec)
        + users_g.numel() * 4 + pos_of.numel() * 4,
        'csr': indptr.numel() * 4 + shifted.numel() * 4 + keys.numel() * 8}
    log(f'trainer (a) sampler tables on the card, {train.num_users} users: bucketed '
        f'{nbytes["bucketed"]:,} B (tables + slot maps; budget rule counts '
        f'{plan.table_bytes:,} B; equal to the CPU build), '
        f'CSR {nbytes["csr"]:,} B (indptr, shifted, int64 keys)')

    n = train.num_interactions
    steps = -(-n // ML10M_BATCH)
    generator = torch.Generator(device=DEVICE)
    generator.manual_seed(7)
    perm = torch.randperm(n, generator=generator, device=DEVICE)
    idx = torch.cat([perm, perm[:steps * ML10M_BATCH - n]])
    users = put(train.mat.row.astype(np.int32))[idx]
    u01 = torch.rand((2, steps * ML10M_BATCH, k), generator=generator, device=DEVICE)
    u01_grouped = torch.rand((users_g.shape[0], k + sampling.SPARES_PER_ROUND),
                             generator=generator, device=DEVICE)
    passes = {
        'csr': lambda: sampling.complement_sample_negatives_impl(
            u01, users, indptr, shifted, num_items, k, dedup_rounds=1, keys=keys),
        'bucketed': lambda: sampling.complement_sample_negatives_bucketed(
            u01_grouped, idx, pos_of, users_g, bucket_specs, counts, num_items, k,
            dedup_rounds=1)}
    negs = {name: fn() for name, fn in passes.items()}
    torch.cuda.synchronize()
    positives = sampling.csr_keys(put(mat.indptr.astype(np.int64)), put(mat.indices))
    for name in ('csr', 'bucketed'):
        hits = int(sampling.keys_contain(positives, users[:, None], negs[name]).sum())
        if hits:
            raise AssertionError(f'{hits} {name} negatives are positives')
    if int(negs['csr'].min()) < 0 or int(negs['csr'].max()) >= num_items:
        raise AssertionError('CSR negatives out of the item range')

    # numpy host reference: the r-th non-positive item, then one redraw of
    # the within-row duplicates from the second round's uniforms
    pick = np.random.default_rng(1).choice(n, SAMPLER_HOST_CHECKS, replace=False)
    u_host = u01[:, pick].cpu().numpy()
    users_host = users[pick].cpu().numpy()
    got = negs['csr'][pick].cpu().numpy()
    for j, user in enumerate(users_host):
        complement = np.setdiff1d(np.arange(num_items),
                                  mat.indices[mat.indptr[user]:mat.indptr[user + 1]])
        size = np.float32(len(complement))

        def draw(u):
            return complement[np.minimum((u * size).astype(np.int32), len(complement) - 1)]

        row = draw(u_host[0, j])
        dup = np.array([row[i] in row[:i] for i in range(k)])
        row = np.where(dup, draw(u_host[1, j]), row)
        if not np.array_equal(row, got[j]):
            raise AssertionError(f'position {pick[j]} (user {user}): {got[j]} vs host {row}')

    times = {name: cuda_median_ms(fn, warmup=1, runs=5) for name, fn in passes.items()}
    log(f'trainer (a) one epoch of negatives ({steps * ML10M_BATCH} positions x {k}, dedup 1): '
        f'CSR equal to the host reference on {SAMPLER_HOST_CHECKS} positions, no positive '
        f'among {negs["csr"].numel():,} CSR or bucketed negatives; pass ms (CUDA events, '
        f'median of 5): CSR {times["csr"]:.3f}, bucketed {times["bucketed"]:.3f} ({smi})')
    del negs, passes, u01
    torch.cuda.empty_cache()
    grouped = check_sampler_kernel(u01_grouped, users_g, bucket_specs, counts, num_items, k, smi)
    del u01_grouped
    torch.cuda.empty_cache()
    return {'bytes': nbytes, 'ms': times, 'table_bytes': plan.table_bytes, 'kernel': grouped}


def check_sampler_kernel(u01, users_g, bucket_specs, counts, num_items, k, smi) -> dict:
    """8(a): the bucketed sampler's kernel against its plain version on one
    epoch's grouped uniforms at the main path's shape (one dedup round),
    value for value in one launch; both timed (CUDA events, median of 5)
    beside the kernel's bound, the bytes it must move over 3.35 TB/s: the
    uniforms, each slot's user, row index and count read, its negatives
    written, the tables read once."""
    from collie_tpu_torch.ops import device_sampling as sampling

    fns = {'kernel': lambda: sampling.complement_sample_negatives_bucketed_grouped_cuda(
               u01, users_g, bucket_specs, counts, num_items, k, dedup_rounds=1),
           'plain': lambda: sampling.complement_sample_negatives_bucketed_grouped_plain(
               u01, users_g, bucket_specs, counts, num_items, k, dedup_rounds=1)}
    before = sampling.complement_sample_negatives_bucketed_grouped.launches
    got, want = fns['kernel'](), fns['plain']()
    torch.cuda.synchronize()
    launches = sampling.complement_sample_negatives_bucketed_grouped.launches - before
    differ = int((got != want).sum())
    if launches != 1 or differ:
        raise AssertionError(f'sampler kernel: {launches} launches, {differ} of {got.numel():,} '
                             f'negatives differ from the plain version')
    n_slots, width = u01.shape
    nbytes = (n_slots * (4 * width + 12 + 4 * k)
              + sum(table.numel() * 4 for _, table in bucket_specs))
    ms = {name: cuda_median_ms(fn, warmup=1, runs=5) for name, fn in fns.items()}
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f'trainer (a) sampler kernel, {n_slots:,} grouped slots x {width} uniforms, '
        f'{len(bucket_specs)} buckets: equal to the plain version in all {got.numel():,} '
        f'negatives, 1 launch; ms (CUDA events, median of 5): kernel {ms["kernel"]:.4f}, '
        f'bound {bound_ms:.4f} ({nbytes:,} B), plain {ms["plain"]:.3f} ({smi})')
    return {
        'name': 'bucketed_sample',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/bucketed_sample.cu',
        'replaces': 'collie_tpu/ops/device_sampling.py:237',
        'launches': 0,
        'max_abs_err': 0.0,
        'ms': ms['kernel'],
        'plain_ms': ms['plain'],
        'bound_ms': bound_ms,
        'bound_by': 'bytes',
        'library_ms': None,
        'checked': True,
    }


def _ml10m_fit(model, epochs, label, smi, sub, **trainer_kw):
    """Fit ``model`` on the card and evaluate MAP@K on ``sub``; returns
    ``(trainer, map)``."""
    from collie_tpu_torch import CollieTrainer, evaluate_in_batches, mapk

    trainer = CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=7,
                            enable_model_summary=False, **trainer_kw)
    trainer.fit(model)
    torch.cuda.synchronize()
    map_k = evaluate_in_batches([mapk], sub, model, k=K, batch_size=512, verbose=False)
    log(f'trainer {label}: {trainer.last_fit_examples_per_sec:,.0f} examples/s ({smi}); '
        f'per epoch ms (shuffle, sampler, kernel): '
        f'{[tuple(round(e[s], 3) for s in SPLIT) for e in trainer.epoch_log]}; '
        f'MAP@{K}={map_k:.5f}')
    return trainer, map_k


def _live_state(params, opt_states, schedulers, trainer) -> dict:
    from collie_tpu_torch.training.trainer import state_from_leaves, state_leaves

    def clone(state):
        return state_from_leaves(state, iter([x.clone() if torch.is_tensor(x) else x
                                              for x in state_leaves(state)]))
    return {'params': {k: v.clone() for k, v in params.items()},
            'opt_states': [clone(s) for s in opt_states],
            'schedulers': [None if s is None else dict(vars(s)) for s in schedulers],
            'global_step': trainer.global_step, 'best_epoch_loss': trainer.best_epoch_loss}


def _checkpointed_fit(model, epochs, directory, resume=None, seed=7):
    """Fit with a checkpoint every epoch, keeping a copy of the live state
    each checkpoint was written from; ``resume`` arms the fit from a file."""
    from collie_tpu_torch import CollieTrainer

    log_ = _MetricLog()
    trainer = CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=seed,
                            enable_model_summary=False, checkpoint_dir=directory, logger=log_)
    live, write = {}, trainer._write_checkpoint

    def capture(params, opt_states, schedulers, epoch):
        live[epoch] = _live_state(params, opt_states, schedulers, trainer)
        write(params, opt_states, schedulers, epoch)

    trainer._write_checkpoint = capture
    if resume is not None:
        trainer.resume_from_checkpoint(resume)
    trainer.fit(model)
    torch.cuda.synchronize()
    first = min(live)
    return trainer, {e: dict(state, loss=log_.epochs[e - first]) for e, state in live.items()}


def _check_checkpoint_file(label, path, live, epoch):
    """The file holds the live state it was written from, bit for bit."""
    from collie_tpu_torch import read_checkpoint
    from collie_tpu_torch.training.trainer import state_leaves

    ckpt = read_checkpoint(path)
    for k, v in live['params'].items():
        if not np.array_equal(ckpt['params'][k], v.cpu().numpy()):
            raise AssertionError(f'{label}: checkpoint param {k} differs from the live one')
    for saved, state in zip(ckpt['opt_states'], live['opt_states']):
        for a, b in zip(saved, state_leaves(state), strict=True):
            same = (np.array_equal(a, b.cpu().numpy()) if torch.is_tensor(b) else a == b)
            if not same:
                raise AssertionError(f'{label}: checkpoint optimizer leaf differs: {a} vs {b}')
    if (ckpt['schedulers'], ckpt['epoch'], ckpt['global_step'], ckpt['best_epoch_loss']) != \
            (live['schedulers'], epoch, live['global_step'], live['best_epoch_loss']):
        raise AssertionError(f'{label}: checkpoint counters or schedulers differ')


def _epoch_state(live, explicit):
    """A captured epoch's state as ``compare_epoch`` takes a kernel's
    outputs: tables, moments, Adam count, losses."""
    p, emb = live['params'], live['opt_states'][0]
    tables = [p['user_embeddings'], p['item_embeddings']] \
        + ([p['user_biases']] if explicit else []) + [p['item_biases']]
    moments = [emb.mu['user_embeddings'], emb.nu['user_embeddings'],
               emb.mu['item_embeddings'], emb.nu['item_embeddings']]
    return (*tables, *moments, emb.adam_count,
            torch.tensor([live['loss']], dtype=torch.float32))


def _check_resumed(label, whole, resumed, first, last, explicit):
    """The first resumed epoch against the uninterrupted fit's same epoch
    (both from the same checkpointed state) at the epoch kernels'
    tolerance; counters and schedulers at the last epoch."""
    names = EXPLICIT_STATE if explicit else IMPLICIT_STATE
    err = compare_epoch(f'{label} resumed epoch {first} vs uninterrupted',
                        _epoch_state(resumed[first], explicit), _epoch_state(whole[first],
                                                                              explicit),
                        max_flipped=MAX_FLIPPED_FRACTION, names=names)
    a, b = whole[last], resumed[last]
    for sa, sb in zip(a['opt_states'], b['opt_states']):
        if (sa.count, sa.learning_rate) != (sb.count, sb.learning_rate) or \
                (sa.adam_count is not None and int(sa.adam_count) != int(sb.adam_count)):
            raise AssertionError(f'{label}: optimizer counters or lr differ at epoch {last}')
    for sa, sb in zip(a['schedulers'], b['schedulers']):
        if sa['num_bad_epochs'] != sb['num_bad_epochs'] or \
                not np.isclose(sa['best'], sb['best'], rtol=EPOCH_RTOL):
            raise AssertionError(f'{label}: scheduler state {sa} vs {sb}')
    if a['global_step'] != b['global_step'] or a['best_epoch_loss'][0] != \
            b['best_epoch_loss'][0]:
        raise AssertionError(f'{label}: counters {a["global_step"]}, {a["best_epoch_loss"]} vs '
                             f'{b["global_step"]}, {b["best_epoch_loss"]}')
    return err


def check_resume(ml10m, sub, smi) -> float:
    """8(d): the implicit ML-10M-scale fit for ``RESUME_EPOCHS`` epochs
    with a checkpoint each epoch, and a fresh model and trainer resumed
    from its ``RESUME_FROM`` file for the rest; the explicit gate
    configuration for 10, resumed from epoch 5 for 5 more.  Returns the max
    abs error of the resumed epochs."""
    from collie_tpu_torch import explicit_evaluate_in_batches, evaluate_in_batches, mapk

    train, _, test = ml10m
    errors = []
    with tempfile.TemporaryDirectory() as whole_dir, \
            tempfile.TemporaryDirectory() as resumed_dir:
        model = ml10m_model(train)
        _, whole = _checkpointed_fit(model, RESUME_EPOCHS, whole_dir)
        map_whole = evaluate_in_batches([mapk], sub, model, k=K, batch_size=512, verbose=False)
        checkpoint = os.path.join(whole_dir, f'checkpoint_epoch_{RESUME_FROM}.pkl')
        _check_checkpoint_file('implicit', checkpoint, whole[RESUME_FROM], RESUME_FROM)
        resumed_model = ml10m_model(train)
        _, resumed = _checkpointed_fit(resumed_model, RESUME_EPOCHS, resumed_dir,
                                       resume=checkpoint)
        map_resumed = evaluate_in_batches([mapk], sub, resumed_model, k=K, batch_size=512,
                                          verbose=False)
        errors.append(_check_resumed('implicit ML-10M', whole, resumed, RESUME_FROM + 1,
                                     RESUME_EPOCHS, False))
        log(f'trainer (d) implicit ML-10M-scale: {RESUME_EPOCHS} epochs uninterrupted '
            f'MAP@{K}={map_whole:.5f}, {RESUME_FROM} + {RESUME_EPOCHS - RESUME_FROM} resumed '
            f'MAP@{K}={map_resumed:.5f}; epoch-{RESUME_FROM} checkpoint equals the live state '
            f'bit for bit; train loss by epoch {[round(whole[e]["loss"], 5) for e in sorted(whole)]}'
            f'; lr after each epoch '
            f'{[whole[e]["opt_states"][0].learning_rate for e in sorted(whole)]}')
        if abs(map_resumed - map_whole) > 0.05 * map_whole:
            raise AssertionError(f'resumed MAP@{K} {map_resumed} vs {map_whole}')
        del model, resumed_model, whole, resumed

    with tempfile.TemporaryDirectory() as whole_dir, \
            tempfile.TemporaryDirectory() as resumed_dir:
        model, _, test_e = explicit_gate_model()
        _, whole = _checkpointed_fit(model, GATE_EPOCHS, whole_dir, seed=0)
        mse_whole = explicit_evaluate_in_batches(['mse'], test_e, model, verbose=False)
        _check_checkpoint_file('explicit', os.path.join(whole_dir, 'checkpoint_epoch_5.pkl'),
                               whole[5], 5)
        resumed_model = explicit_gate_model()[0]
        _, resumed = _checkpointed_fit(resumed_model, GATE_EPOCHS, resumed_dir, seed=0,
                                       resume=os.path.join(whole_dir, 'checkpoint_epoch_5.pkl'))
        mse_resumed = explicit_evaluate_in_batches(['mse'], test_e, resumed_model,
                                                   verbose=False)
        errors.append(_check_resumed('explicit gate', whole, resumed, 6, GATE_EPOCHS, True))
        log(f'trainer (d) explicit gate config: 10 epochs uninterrupted test MSE '
            f'{mse_whole:.5f}, 5 + 5 resumed {mse_resumed:.5f}')
        if abs(mse_resumed - mse_whole) > 0.05 * mse_whole:
            raise AssertionError(f'resumed test MSE {mse_resumed} vs {mse_whole}')
    return max(errors)


def check_step_path(smi) -> None:
    """8(e): ``CollieMinimalTrainer(epoch_mode='step')`` for one epoch of
    the gate configuration on the card, the same epoch on the CPU from the
    same params and loader seed, and the card's fit through a
    ``PrefetchLoader``; params and per-step losses held at ``STEP_RTOL``."""
    from collie_tpu_torch import (CollieMinimalTrainer, InteractionsDataLoader,
                                  MatrixFactorizationModel, PrefetchLoader)

    model, train, _ = gate_model()
    params0 = {k: v.clone() for k, v in model.params.items()}
    runs = {}
    for name, device, wrap in (('card', None, None), ('cpu', 'cpu', None),
                               ('card, PrefetchLoader', None, PrefetchLoader)):
        loader = InteractionsDataLoader(interactions=train, batch_size=1024, shuffle=True,
                                        seed=42)
        m = MatrixFactorizationModel(train=wrap(loader) if wrap else loader, embedding_dim=10,
                                     lr=1e-1, loss='adaptive', seed=42, map_location=device)
        m.load_params({k: v.to(m.device) for k, v in params0.items()})
        log_ = _MetricLog()
        trainer = CollieMinimalTrainer(m, max_epochs=1, verbosity=0, seed=42,
                                       epoch_mode='step', logger=log_, log_every_n_steps=1,
                                       enable_model_summary=False)
        trainer.fit(m)
        if device is None:
            torch.cuda.synchronize()
        steps = trainer.epoch_log[0]['steps']
        runs[name] = {'params': {k: v.cpu() for k, v in m.params.items()},
                      'losses': np.asarray(log_.steps), 'steps': steps}
        log(f'trainer (e) per-step path on the {name}: {steps} steps, '
            f'{steps / trainer.epoch_log[0]["seconds"]:.1f} steps/s, '
            f'{trainer.last_fit_examples_per_sec:,.0f} examples/s'
            + (f' ({smi})' if device is None else ''))
    ref = runs['cpu']
    for name in ('card', 'card, PrefetchLoader'):
        run = runs[name]
        if run['steps'] != ref['steps'] or len(run['losses']) != ref['steps']:
            raise AssertionError(f'{name}: {run["steps"]} steps vs {ref["steps"]}')
        if not np.allclose(run['losses'], ref['losses'], rtol=STEP_RTOL, atol=0):
            raise AssertionError(f'{name}: per-step losses differ from the CPU\'s: '
                                 f'{run["losses"][:4]} vs {ref["losses"][:4]}')
        for k, b in ref['params'].items():
            a = run['params'][k]
            diff = (a - b).abs()
            if not bool((diff <= STEP_RTOL * b.abs() + STEP_ATOL_SCALE * b.abs().max()).all()):
                raise AssertionError(f'{name}: param {k} differs from the CPU\'s by up to '
                                     f'{float(diff.max()):.3g}')
        log(f'  {name} vs cpu: per-step losses within rtol {STEP_RTOL}, params within '
            f'{STEP_RTOL} x |cpu| + {STEP_ATOL_SCALE} x max|cpu| (max abs difference '
            f'{max(float((run["params"][k] - b).abs().max()) for k, b in ref["params"].items()):.3g})')


def check_custom_optimizer(smi) -> None:
    """8(f): the gate configuration for 2 epochs with a momentum-SGD
    factory: the generic epoch on the card, the train loss falls."""
    from collie_tpu_torch import CollieTrainer, InteractionsDataLoader, MatrixFactorizationModel

    _, train, _ = gate_model()
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, shuffle=True, seed=42)
    model = MatrixFactorizationModel(train=loader, embedding_dim=10, lr=CUSTOM_SGD_LR,
                                     loss='adaptive', seed=42,
                                     optimizer=lambda learning_rate: _MomentumSGD(learning_rate))
    log_ = _MetricLog()
    trainer = CollieTrainer(model, max_epochs=2, verbosity=0, seed=42, logger=log_,
                            enable_model_summary=False)
    trainer.fit(model)
    torch.cuda.synchronize()
    log(f'trainer (f) momentum-SGD factory, gate config, 2 epochs through the generic epoch: '
        f'{trainer.last_fit_examples_per_sec:,.0f} examples/s ({smi}); train loss '
        f'{[round(x, 5) for x in log_.epochs]}')
    if not (len(log_.epochs) == 2 and log_.epochs[1] < log_.epochs[0]):
        raise AssertionError(f'custom optimizer fit: train loss {log_.epochs}')


def phase_trainer(ml10m, smi: str, ml10m_fit: dict) -> dict:
    """The rest of the single-device trainer on the card: (a) the bucketed
    tables and the CSR sampler at the ML-10M scale; (b) a fit there through the CSR
    sampler; (c) one with the approximate loader; (d) checkpoint/resume,
    implicit and explicit; (e) the per-step path against the CPU; (f) a
    custom optimizer factory.  Launch counts over the phase: fused_mf_epoch
    3 + 3 + 5 + 2, fused_mf_explicit_epoch 10 + 5, the bucketed sampler
    kernel ``SAMPLER_CHECK_LAUNCHES`` + 5 + 2 + 2 (the fits through the CSR
    sampler and the approximate loader draw none), the others 0 but the
    cycle-walk."""
    from collie_tpu_torch import (ApproximateNegativeSamplingInteractionsDataLoader,
                                  MatrixFactorizationModel)
    from collie_tpu_torch.training.scan_engine import select_sampler

    train, _, test = ml10m
    sub = ml10m_eval_users(test)
    start = time.perf_counter()
    reset_launch_counts()
    samplers = check_samplers(train, smi)

    # (b) above the table budget, auto routes to the CSR sampler
    os.environ['COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB'] = '0'
    try:
        if select_sampler(samplers['table_bytes']) != 'csr':
            raise AssertionError('a budget of 0 does not route auto to the CSR sampler')
        before = _kernel_counts()
        _, map_csr = _ml10m_fit(ml10m_model(train), ML10M_EPOCHS,
                                '(b) ML-10M-scale fit through the CSR sampler', smi, sub)
    finally:
        del os.environ['COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB']
    if _count_delta(before)['fused_mf_epoch'] != ML10M_EPOCHS \
            or _count_delta(before)[SAMPLER_WRAPPER]:
        raise AssertionError(f'CSR fit: launches {_count_delta(before)}')
    if not map_csr >= 0.85 * ml10m_fit['mapk']:
        raise AssertionError(f'CSR-sampled MAP@{K} {map_csr} < 0.85 x {ml10m_fit["mapk"]}')

    # (c) the approximate loader switches the shared Interactions in place:
    # put it back for the fits after it
    saved = train.max_number_of_samples_to_consider
    try:
        before = _kernel_counts()
        loader = ApproximateNegativeSamplingInteractionsDataLoader(
            interactions=train, batch_size=ML10M_BATCH, shuffle=True, seed=7)
        model = MatrixFactorizationModel(train=loader, embedding_dim=ML10M_DIM, lr=1e-1,
                                         loss='adaptive', seed=7)
        _, map_approx = _ml10m_fit(model, ML10M_EPOCHS,
                                   '(c) ML-10M-scale fit with the approximate loader', smi, sub)
    finally:
        train.max_number_of_samples_to_consider = saved
    if _count_delta(before)['fused_mf_epoch'] != ML10M_EPOCHS \
            or _count_delta(before)[SAMPLER_WRAPPER]:
        raise AssertionError(f'approximate fit: launches {_count_delta(before)}')
    if not map_approx > ml10m_fit['untrained_mapk']:
        raise AssertionError(f'approximate MAP@{K} {map_approx} does not beat untrained '
                             f'{ml10m_fit["untrained_mapk"]}')
    del model, loader

    resume_err = check_resume(ml10m, sub, smi)
    before = _kernel_counts()
    check_step_path(smi)
    if any(_count_delta(before).values()):
        raise AssertionError(f'a kernel launched on the per-step path: {_count_delta(before)}')
    check_custom_optimizer(smi)
    launches = _kernel_counts()
    expected = {'mf_topk_retrieve': 0,
                'fused_mf_epoch': 2 * ML10M_EPOCHS + 2 * RESUME_EPOCHS - RESUME_FROM,
                'fused_mf_explicit_epoch': 15, 'binned_gather_scatter': 0,
                SHUFFLE_WRAPPER: launches[SHUFFLE_WRAPPER], 'stable_topk': 0,
                # 8(a), the checkpointed fit and its resumed tail, (f)'s 2 epochs
                SAMPLER_WRAPPER: SAMPLER_CHECK_LAUNCHES + 2 * RESUME_EPOCHS - RESUME_FROM + 2}
    log(f'trainer phase: kernel launches {launches} (expected {expected}); '
        f'{time.perf_counter() - start:.1f}s')
    if launches != expected or not launches[SHUFFLE_WRAPPER]:
        raise AssertionError(f'trainer phase launches {launches}, expected {expected}')
    torch.cuda.empty_cache()
    return {'samplers': samplers, 'map_csr': map_csr, 'map_approx': map_approx,
            'resume_max_abs_err': resume_err, 'launches': launches}


@contextlib.contextmanager
def sync_errors():
    """Every host sync raises (``torch.cuda.set_sync_debug_mode('error')``)."""
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode('default')


def check_cycle_walk(n: int, keys) -> None:
    """The cycle-walk kernel at ``n`` under ``keys`` against its plain
    version, bit for bit."""
    from collie_tpu_torch.ops.shuffle import feistel_permutation_cuda, feistel_permutation_plain

    keys = torch.tensor(keys, dtype=torch.int64, device=DEVICE)
    got = feistel_permutation_cuda(keys, n)
    ref = feistel_permutation_plain(keys, n)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or not torch.equal(got, ref):
        bad = int((got.long() != ref.long()).sum())
        raise AssertionError(f'cycle-walk n={n} keys={keys.tolist()}: {bad} values differ')


def check_skipped_launch(explicit: bool) -> None:
    """One epoch kernel launched with ``live = 0`` at an edge shape:
    tables, biases, moments and count bit-identical, every loss NaN."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch,
                                                             fused_mf_explicit_epoch)

    live = torch.zeros((), dtype=torch.bool, device=DEVICE)
    if explicit:
        args = explicit_epoch_inputs(5, dup=True, tail=True)
        out = fused_mf_explicit_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args],
                                      loss_kind='mse', y_range=Y_RANGE, wd_emb=1e-3,
                                      wd_bias=1e-3, live=live)
        n_state = len(EXPLICIT_STATE) + 1
    else:
        args, meta = epoch_inputs(5, K=4, F=1, dup=True)
        out = fused_mf_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args], meta,
                             K=4, adaptive=True, meta_weights=(0.5,), wd_emb=1e-3,
                             wd_bias=1e-3, live=live)
        n_state = len(IMPLICIT_STATE) + 1
    torch.cuda.synchronize()
    for got, ref in zip(out[:n_state], args[:n_state]):
        if not torch.equal(got, torch.as_tensor(ref, device=DEVICE).to(got.dtype)):
            raise AssertionError(f'a skipped {"explicit" if explicit else "implicit"} launch '
                                 f'changed its state')
    if not bool(torch.isnan(out[-1]).all()):
        raise AssertionError('a skipped launch reported a non-NaN loss')


def record_fit(build, whole: bool, label: str, smi: str, guard=None, **trainer_kw) -> dict:
    """Fit ``build()``'s model through ``CollieTrainer`` as the whole fit or
    the per-epoch loop (``COLLIE_TPU_WHOLE_FIT``); returns the per-epoch
    train losses, the learning-rate changes in epoch then optimizer order,
    the ``ran`` mask (the per-epoch loop: one True an epoch it ran), best
    epoch, epochs completed, examples/s and the epoch log.  ``guard``
    replaces ``trainer.flight_guard`` for the fit."""
    from collie_tpu_torch import CollieTrainer
    from collie_tpu_torch.training import trainer as trainer_module
    from collie_tpu_torch.training.optimizers import get_lr

    model = build()
    blocks, changes = [], []
    saved = (trainer_module.build_scan_fit_fn, trainer_module.set_lr,
             trainer_module.flight_guard)

    def recording_build(*args, **kwargs):
        fn = saved[0](*args, **kwargs)

        def fit_fn(*a, **k):
            out = fn(*a, **k)
            blocks.append((out[6], out[7]))           # tensors, read after the fit
            return out
        return fit_fn

    def recording_set_lr(state, lr):
        if float(np.float32(lr)) != get_lr(state):     # a cut of 0 is no change
            changes.append(float(np.float32(lr)))
        return saved[1](state, lr)

    os.environ['COLLIE_TPU_WHOLE_FIT'] = '1' if whole else '0'
    trainer_module.build_scan_fit_fn, trainer_module.set_lr = recording_build, recording_set_lr
    if guard is not None:
        trainer_module.flight_guard = guard
    losses = _LossLog()
    try:
        specs = model.optimizer_specs()
        initial = [get_lr(s.transform.init({k: model.params[k] for k in s.keys}))
                   for s in specs]
        trainer = CollieTrainer(model, max_epochs=trainer_kw.pop('epochs'), verbosity=0,
                                logger=losses, enable_model_summary=False, **trainer_kw)
        trainer.fit(model)
        torch.cuda.synchronize()
    finally:
        (trainer_module.build_scan_fit_fn, trainer_module.set_lr,
         trainer_module.flight_guard) = saved
        del os.environ['COLLIE_TPU_WHOLE_FIT']
    if whole:
        if not blocks or changes:
            raise AssertionError(f'{label}: the whole fit did not run as one')
        ran = torch.cat([r for _, r in blocks]).tolist()
        lrs = [torch.cat([b[0][i] for b in blocks]).tolist() for i in range(len(specs))]
        for j in range(len(ran)):
            for i, trace in enumerate(lrs):
                before = initial[i] if j == 0 else trace[j - 1]
                if ran[j] and trace[j] == trace[j] and trace[j] != before:
                    changes.append(trace[j])
    else:
        if blocks:
            raise AssertionError(f'{label}: the per-epoch loop dispatched a whole-fit block')
        ran = [True] * trainer.num_epochs_completed
    return {'model': model, 'trainer': trainer, 'losses': list(losses.losses),
            'changes': changes, 'ran': ran, 'best_epoch': trainer.best_epoch_loss[0],
            'epochs': trainer.num_epochs_completed,
            'examples_per_s': trainer.last_fit_examples_per_sec,
            'epoch_log': list(trainer.epoch_log)}


def compare_fits(label: str, whole: dict, per_epoch: dict, smi: str) -> None:
    """(d): the whole fit against the per-epoch loop."""
    n = per_epoch['epochs']
    expected_ran = [True] * n + [False] * (len(whole['ran']) - n)
    equal = {'epochs': whole['epochs'] == n, 'ran': whole['ran'] == expected_ran,
             'lr trajectory': whole['changes'] == per_epoch['changes'],
             'best epoch': whole['best_epoch'] == per_epoch['best_epoch']}
    a, b = np.asarray(whole['losses']), np.asarray(per_epoch['losses'])
    parted = float(np.max(np.abs(a - b) / np.abs(b))) if len(a) == len(b) and len(b) else None
    log(f'whole_fit (d) {label}: {n} epochs, ran {whole["ran"]}, lr changes '
        f'{whole["changes"]} (per-epoch loop {per_epoch["changes"]}), best epoch '
        f'{whole["best_epoch"]}; train losses within {parted} of the per-epoch loop\'s '
        f'(rtol {WHOLE_FIT_LOSS_RTOL}); examples/s whole fit '
        f'{whole["examples_per_s"]:,.0f}, per-epoch loop {per_epoch["examples_per_s"]:,.0f} '
        f'({smi})')
    if not all(equal.values()) or parted is None or parted > WHOLE_FIT_LOSS_RTOL:
        raise AssertionError(f'whole fit vs per-epoch loop, {label}: {equal}, losses parted '
                             f'{parted}: {whole["losses"]} vs {per_epoch["losses"]}')


def phase_whole_fit(ml10m: dict, smi: str) -> dict:
    """(a)-(e) of phase 9 (module docstring); returns the cycle-walk's
    record of the kernels line, its launches those of the fits here."""
    from collie_tpu_torch import (InteractionsDataLoader, MatrixFactorizationModel,
                                  ReduceLROnPlateau, explicit_evaluate_in_batches)
    from collie_tpu_torch.ops.shuffle import feistel_permutation_cuda, feistel_permutation_plain

    start = time.perf_counter()
    # (a) the cycle-walk kernel against its plain version
    for n in SHUFFLE_SIZES:
        for keys in SHUFFLE_KEY_SETS:
            check_cycle_walk(n, keys)
    times = {}
    keys = torch.tensor(SHUFFLE_KEY_SETS[2], dtype=torch.int64, device=DEVICE)
    for n in SHUFFLE_SIZES[-2:]:
        kernel_ms = cuda_median_ms(lambda: feistel_permutation_cuda(keys, n), warmup=2, runs=15)
        plain_ms = cuda_median_ms(lambda: feistel_permutation_plain(keys, n), warmup=1, runs=5)
        times[n] = {'ms': kernel_ms, 'plain_ms': plain_ms,
                    'bound_ms': 4.0 * n / PEAK_BYTES_PER_S * 1e3}
        log(f'whole_fit (a) feistel_cycle_walk n={n}: kernel_ms={kernel_ms:.4f} '
            f'plain_ms={plain_ms:.4f} bound_ms={times[n]["bound_ms"]:.4f} (bytes: 4n written); '
            f'library_ms=null: no single PyTorch call computes this keyed bijection ({smi})')
    log(f'whole_fit (a) the cycle-walk kernel equals its plain version bit for bit at n in '
        f'{SHUFFLE_SIZES} under {len(SHUFFLE_KEY_SETS)} key sets')
    # (b) live = 0
    check_skipped_launch(explicit=False)
    check_skipped_launch(explicit=True)
    log('whole_fit (b) fused_mf_epoch and fused_mf_explicit_epoch launched with live = 0: '
        'tables, biases, moments and count bit-identical, losses NaN')

    # (c) no host sync inside a flight; then (e)'s ML-10M pair
    reset_launch_counts()
    train, _, _ = ml10m
    gate_whole = record_fit(lambda: gate_model()[0], True, 'gate', smi, guard=sync_errors,
                            epochs=GATE_EPOCHS, seed=42)
    ml_whole = record_fit(lambda: ml10m_model(train), True, 'ML-10M', smi, guard=sync_errors,
                          epochs=ML10M_EPOCHS, seed=7)
    launches = _kernel_counts()
    if not launches['fused_mf_epoch'] == launches[SAMPLER_WRAPPER] == GATE_EPOCHS + ML10M_EPOCHS:
        raise AssertionError(f'whole fits under sync errors: launches {launches}')
    log(f'whole_fit (c) the gate fit ({GATE_EPOCHS} epochs) and the ML-10M fit '
        f'({ML10M_EPOCHS}) ran with set_sync_debug_mode("error") around every flight: no '
        f'host sync inside a flight; kernel launches {launches}')
    log(f'  (c) examples/s: gate {gate_whole["examples_per_s"]:,.0f}, ML-10M '
        f'{ml_whole["examples_per_s"]:,.0f} ({smi})')
    del gate_whole, ml_whole
    torch.cuda.empty_cache()

    # (e) examples/s of each tier, in the order per-epoch, whole, whole,
    # per-epoch, so that neither tier alone pays for a cold first fit
    rates, before = {}, _kernel_counts()
    for label, build, kw, epochs in (
            ('gate config', lambda: gate_model()[0], dict(seed=42), GATE_EPOCHS),
            ('explicit gate config', lambda: explicit_gate_model()[0], dict(seed=0),
             GATE_EPOCHS),
            ('ML-10M-scale', lambda: ml10m_model(train), dict(seed=7), ML10M_EPOCHS)):
        rates[label] = {'whole fit': [], 'per-epoch loop': []}
        for whole in (False, True, True, False):
            fit = record_fit(build, whole, label, smi, epochs=epochs, **kw)
            name = 'whole fit' if whole else 'per-epoch loop'
            rates[label][name].append(fit['examples_per_s'])
            if label == 'ML-10M-scale':
                log(f'whole_fit (e) ML-10M-scale {name}: {fit["examples_per_s"]:,.0f} '
                    f'examples/s; per epoch ms (seconds, shuffle, sampler, kernel): '
                    + str([(round(e['seconds'] * 1e3, 3),) + tuple(round(e[k], 3)
                                                                   for k in SPLIT)
                           for e in fit['epoch_log']]))
            del fit
        log(f'whole_fit (e) {label}, examples/s (per-epoch, whole, whole, per-epoch): '
            f'whole fit {[round(r) for r in rates[label]["whole fit"]]}, per-epoch loop '
            f'{[round(r) for r in rates[label]["per-epoch loop"]]} ({smi})')
    sampled = _count_delta(before)[SAMPLER_WRAPPER]
    if sampled != 4 * (GATE_EPOCHS + ML10M_EPOCHS):
        raise AssertionError(f'(e): {sampled} sampler kernel launches for the implicit fits\' '
                             f'{4 * (GATE_EPOCHS + ML10M_EPOCHS)} epochs')
    sampled += launches[SAMPLER_WRAPPER]
    torch.cuda.empty_cache()

    # (d) whole fit against the per-epoch loop; (e) the gate pairs
    def val_gate_model():
        model, train_g, test_g = gate_model()
        return MatrixFactorizationModel(
            train=model.train_loader,
            val=InteractionsDataLoader(interactions=test_g, batch_size=1024, seed=42),
            embedding_dim=10, lr=0.0, bias_lr=0.0, loss='adaptive', seed=42)

    def pair_gate_model(**kwargs):
        model, _, _ = gate_model()
        return MatrixFactorizationModel(train=model.train_loader, embedding_dim=10,
                                        lr=WHOLE_FIT_PAIR_LR, loss='adaptive', seed=42, **kwargs)

    def plateau_gate_model():
        return pair_gate_model(
            lr_scheduler_func=ReduceLROnPlateau(factor=0.5, patience=0, threshold=0.5))

    cases = [('implicit gate config', pair_gate_model, dict(seed=42)),
             ('explicit gate config', lambda: explicit_gate_model()[0], dict(seed=0)),
             ('gate config, a plateau cut every epoch', plateau_gate_model, dict(seed=42)),
             ('gate config, early stop in a flight', val_gate_model,
              dict(seed=42, early_stopping_patience=1))]
    before = _kernel_counts()
    pairs, drawn = {}, 0
    for label, build, kw in cases:
        whole = record_fit(build, True, label, smi, epochs=GATE_EPOCHS, **kw)
        per_epoch = record_fit(build, False, label, smi, epochs=GATE_EPOCHS, **kw)
        compare_fits(label, whole, per_epoch, smi)
        pairs[label] = (whole, per_epoch)
        if label != 'explicit gate config':
            drawn += drawn_epochs(whole) + drawn_epochs(per_epoch)
    stop = pairs['gate config, early stop in a flight'][0]['epochs']
    if not stop < GATE_EPOCHS:
        raise AssertionError(f'the early-stopping fit ran all {stop} epochs')
    if not any(pairs['gate config, a plateau cut every epoch'][0]['changes']):
        raise AssertionError('no plateau cut in the plateau fit')
    delta = _count_delta(before)
    if not (delta['fused_mf_epoch'] and delta['fused_mf_explicit_epoch']):
        raise AssertionError(f'(d): the whole fits did not launch both epoch kernels: {delta}')
    if delta[SAMPLER_WRAPPER] != drawn:
        raise AssertionError(f'(d): {delta[SAMPLER_WRAPPER]} sampler kernel launches for '
                             f'{drawn} epochs drawn')
    with open(os.path.join('benchmarks', 'gates.json')) as f:
        gates = {name: spec['gate'] for name, spec in json.load(f).items()}
    # the implicit gate metrics are phase 5(a)'s, whose fit at lr 0.1 is a whole fit
    _, _, explicit_test = explicit_gate_model()
    mse = explicit_evaluate_in_batches(['mse'], explicit_test,
                                       pairs['explicit gate config'][0]['model'], verbose=False)
    log(f'whole_fit (e) the explicit gate whole fit: test MSE={mse:.5f} (gate: MSE < '
        f'{gates["mse"]:.5f}); early stop at epoch {stop}; kernel launches in (d) {delta}; '
        f'{time.perf_counter() - start:.1f}s')
    if not mse < gates['mse']:
        raise AssertionError(f'explicit gate whole fit: test MSE {mse} misses {gates["mse"]}')
    big = times[SHUFFLE_SIZES[-1]]
    return {
        'name': 'feistel_cycle_walk',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/shuffle.cu',
        'replaces': 'collie_tpu/ops/shuffle.py:65',
        'launches': launches[SHUFFLE_WRAPPER] + delta[SHUFFLE_WRAPPER],
        'sampler_launches': sampled + delta[SAMPLER_WRAPPER],
        'max_abs_err': 0.0,
        'ms': big['ms'],
        'plain_ms': big['plain_ms'],
        'bound_ms': big['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'times_by_n': {str(n): t for n, t in times.items()},
        'checked': True,
    }


# the generic_epoch phase: the generic epoch in each route of calculate_loss
# and the table layout.  At lr 0.1 an epoch from one state cannot be held
# step for step against another form of it: a rounding-level difference
# flips a hardest negative, and the flips cascade (on the H100, sparse and
# dense per-step losses are equal for the first steps and 3.4e-3 apart
# later in one ML-10M-scale epoch; two launches of one kernel epoch drift
# the same way, tools/epoch_repeatability.py).  So each form is held STEP BY STEP
# from the states the reference trajectory visits: at every step of the
# reference epoch, the step's loss within the rtol and the gradients of
# the tables (what the sparse form changes: the rows the backward
# scatters into) within the scale * their largest element, at most
# MAX_FLIPPED_FRACTION of a table's elements beyond (a rounding-level
# score difference may still flip one example's hardest negative or its
# hinge's kink); the dense weights' gradients within
# GENERIC_DENSE_GRAD_SCALE * the largest element: a weight's gradient is a
# sum over the batch in both forms, in another order, and may cancel to
# nothing (NeuMF's predict bias is shared by the positive and the
# negative, so its gradient is zero in exact arithmetic; at a toy step on
# the CPU the dense form leaves 1.2e-5 of the largest element there, the
# sparse form 0).  Sparse against dense: GENERIC_SPARSE_RTOL and
# GENERIC_GRAD_SCALE from the dense trajectory's states; fused against
# named: GENERIC_FUSED_RTOL for both from the named trajectory's states.
# The bfloat16 selection against the float32 one: at the first step (the
# same params) a row may select another negative only where the float32
# scores of the two lie within the bfloat16 rounding bound (2^-7 *
# sum|u_d v_d| + 2^-8 * |item bias| for each), and the step's loss stays
# within GENERIC_BF16_LOSS_RTOL.  Each state's epoch as a whole (its own
# trajectory): finite step losses and a mean within GENERIC_EPOCH_MEAN_RTOL
# of the reference's.
# Knobs of each state: (label, COLLIE_TPU_SPARSE_ADAPTIVE, _BF16_SELECT,
# _FUSED_TABLES)
GENERIC_SPARSE_RTOL = 1e-5
GENERIC_GRAD_SCALE = 1e-5
GENERIC_FUSED_RTOL = 1e-6
GENERIC_DENSE_GRAD_SCALE = 1e-3
GENERIC_BF16_LOSS_RTOL = 1e-3
GENERIC_EPOCH_MEAN_RTOL = 1e-2
GENERIC_STATES = [('dense+named', '0', '0', '0'), ('sparse-f32+named', '1', '0', '0'),
                  ('sparse-f32+fused', '1', '0', '1'), ('sparse-bf16+fused', '1', '1', '1')]
GENERIC_ZOO = [name for name, _ in ZOO_MODELS
               if name in ('MLPMatrixFactorizationModel', 'NonlinearMatrixFactorizationModel',
                           'NeuralCollaborativeFiltering', 'DeepFM')]
GENERIC_WHOLE_FIT_EPOCHS = 2
# steps of each state run under torch.profiler (a whole zoo epoch is ~18,000
# device launches, which the profiler takes seconds to collect)
GENERIC_PROFILED_STEPS = 5
# the out_of_core phase: benchmarks/bench_outofcore.py's configuration
# (:39-45, :111-118): make_data(default_rng(0)) over 40,000 users x 8,000
# items, the loader (batch 8,192, K = 10, shuffled, seed 0), MF with
# embedding_dim 32, lr 1e-3, adaptive hinge; chunks of OOC_CHUNK_STEPS steps,
# so the 245 steps an epoch run as OOC_PLAN.  Each label's examples/s is the
# median of OOC_EPOCHS - 1 epochs after one warm-up, as the benchmark times
# it.  The first chunk on the card is held to the same chunk on the CPU
# from the same params on the same draws: shuffled batches bit for bit,
# per-step losses within STEP_RTOL.  Over a whole 64-step chunk the two
# runs' tables part beyond STEP_RTOL * |cpu| + STEP_ATOL_SCALE * max|cpu|
# in 0.150% of item_embeddings' elements on an H100 (a hardest negative
# the two devices' summation orders pick differently moves that example's
# rows by an Adam step, and later steps score against the moved rows), so
# each step is also taken on the card from the CPU's state before it and
# its tables held within that tolerance in all but MAX_FLIPPED_FRACTION of
# the elements
OOC_NUM_INTERACTIONS = 2_000_000
OOC_NUM_USERS = 40_000
OOC_NUM_ITEMS = 8_000
OOC_BATCH = 8192
OOC_DIM = 32
OOC_K = 10
OOC_LR = 1e-3
OOC_CHUNK_STEPS = 64
OOC_PLAN = [64, 64, 64, 32, 16, 4, 1]
OOC_EPOCHS = 4
# phase 12: users whose visualization the card and a CPU copy must render
# alike, the region the traced epoch annotates, and collie_tpu's
# run_movielens_example() on the same files on the CPU
# (tools/movielens_jax_reference.py --runs 3; its split and model are seeded
# from the clock, in both packages)
MOVIELENS_VIS_USERS = (1, 2, 3)
MOVIELENS_REGION = 'chip_smoke_movielens_epoch'
JAX_ML100K_CPU = ('AUC 0.65885-0.66931, MRR 0.13238-0.15245, MAP@10 0.02437-0.02821 '
                  'in 3 runs')
# phase 13: the requests through the mesh on phase 4's model
# (filter_seen=False takes the local-table tier's kernel path; the first
# request also sets up the NCCL communicators)
MESH_SEED = 13
MESH_REQUESTS = (False, False, False, True)
# phase 14: mesh training at the ML-10M-scale configuration
# (benchmarks/bench_ml10m_scale.py:34-72) on make_mesh(data=1, model=1);
# the mesh fit's epochs, its checkpointed fit's, and the kernel-path
# requests of REQUEST_USERS users its model then serves.  Two fits are held
# by their epochs, learning-rate changes, best epoch and train losses
# (WHOLE_FIT_LOSS_RTOL); their params as phase 10 holds generic states:
# step by step from one state (MESH_TRAIN_HELD_STEPS steps of the trained
# model's next epoch, the mesh step against the single-card step: losses
# within GENERIC_SPARSE_RTOL, each table's elements beyond
# GENERIC_GRAD_SCALE of its update's largest element in at most
# MAX_FLIPPED_FRACTION), since over whole fits at lr 0.1 a hardest negative
# that two summation orders pick differently cascades; the whole fits'
# largest param difference is printed
MESH_TRAIN_EPOCHS = 3
MESH_TRAIN_HELD_STEPS = 3
MESH_TRAIN_RESUME_FROM = 2
MESH_TRAIN_REQUESTS = 3


@contextlib.contextmanager
def knobs(sparse: str, bf16: str, fused_tables: str):
    """``COLLIE_TPU_SPARSE_ADAPTIVE``, ``_BF16_SELECT`` and ``_FUSED_TABLES``
    set for the block, the old values back after it."""
    names = ('COLLIE_TPU_SPARSE_ADAPTIVE', 'COLLIE_TPU_BF16_SELECT', 'COLLIE_TPU_FUSED_TABLES')
    saved = {n: os.environ.get(n) for n in names}
    os.environ.update(zip(names, (sparse, bf16, fused_tables)))
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def device_activity(call):
    """``call()`` once under ``torch.profiler``: ``(device launches, busy us,
    span us)``; ``(0, 0.0, 0.0)`` when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return 0, 0.0, 0.0
    busy = sum(e.time_range.elapsed_us() for e in device)
    span = max(e.time_range.end for e in device) - min(e.time_range.start for e in device)
    return len(device), busy, span


def generic_epoch_state(model, state, seed: int, epoch: int, keep_steps: bool = False) -> dict:
    """One generic epoch (``fused=False``) of ``model`` from its params and
    fresh optimizer states under ``state``'s knobs, on the batches of
    ``(seed, epoch)``: the params it returns and its per-step losses (a
    recording ``scan_engine.train_step``), with ``keep_steps`` each step's
    params before it and its batch.  Then the epoch runs once more from the
    same state, timed (examples/s), and its first ``GENERIC_PROFILED_STEPS``
    steps run again under ``torch.profiler`` (device launches a step, the
    card's busy share of their span)."""
    from collie_tpu_torch.training import scan_engine

    label, sparse, bf16, fused_tables = state
    with knobs(sparse, bf16, fused_tables):
        specs = model.optimizer_specs()
        active = [spec.stage in (None, model.current_stage) for spec in specs]
        epoch_fn, data, S, n = scan_engine.build_scan_epoch_fns(
            model, specs, active, model.train_loader, shuffle=True, fused=False)
        if epoch_fn.fused or epoch_fn.fused_tables != (fused_tables == '1'
                                                       and model.supports_fused_tables()):
            raise AssertionError(f'{label}: epoch route fused={epoch_fn.fused}, '
                                 f'fused_tables={epoch_fn.fused_tables}')
        params = dict(model.params)

        def fresh_states():
            return tuple(spec.transform.init({k: params[k] for k in spec.keys})
                         for spec in specs)

        losses, steps, train_step = [], [], scan_engine.train_step

        def recording_step(model_, specs_, active_, params_, states_, batch, *rest):
            out = train_step(model_, specs_, active_, params_, states_, batch, *rest)
            losses.append(out[2])
            if keep_steps or len(steps) < GENERIC_PROFILED_STEPS:
                steps.append((params_, batch))
            return out
        scan_engine.train_step = recording_step
        try:
            new_params, _, mean = epoch_fn(params, fresh_states(), data, seed, epoch)
        finally:
            scan_engine.train_step = train_step
        losses = torch.stack(losses)
        if not torch.allclose(losses.mean(), mean, rtol=1e-6, atol=0):
            raise AssertionError(f'{label}: epoch loss {float(mean)} is not the mean of its '
                                 f'steps {float(losses.mean())}')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch_fn(params, fresh_states(), data, seed, epoch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0

        def window():
            carried, states = steps[0][0], fresh_states()
            for _, batch in steps[:GENERIC_PROFILED_STEPS]:
                carried, states, _ = train_step(model, specs, active, carried, states, batch,
                                                None, epoch_fn.fused_tables)
        launches, busy, span = device_activity(window)
    profiled = min(GENERIC_PROFILED_STEPS, S)
    return {'params': new_params, 'losses': losses, 'steps': steps if keep_steps else [],
            'S': S, 'epochs': 2, 'examples_per_s': n / seconds,
            'launches_per_step': launches / profiled,
            'busy_share': busy / span if span else 0.0}


def step_grads(model, state, params, batch):
    """One step's loss and every param's gradient (named keys) from the
    named ``params`` on ``batch`` under ``state``'s knobs."""
    label, sparse, bf16, fused_tables = state
    with knobs(sparse, bf16, fused_tables):
        fused = fused_tables == '1' and model.supports_fused_tables()
        params = model.fuse_params(dict(params)) if fused else dict(params)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = model.calculate_loss(leaves, batch, training=True)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), model.unfuse_params(grads) if fused else grads


def hold_steps(label, model, state, ref_state, steps, loss_rtol: float,
               grad_scale: float) -> dict:
    """``state``'s step against ``ref_state``'s from each (params, batch) of
    ``steps``, as the constants' comment says; returns the largest loss
    gap, table share beyond and weight gap over the steps."""
    worst = {'loss': 0.0, 'table_share': 0.0, 'table_max': 0.0, 'weights': 0.0}
    for s, (params, batch) in enumerate(steps):
        loss, grads = step_grads(model, state, params, batch)
        ref_loss, ref_grads = step_grads(model, ref_state, params, batch)
        scale = max(float(g.abs().max()) for g in ref_grads.values())
        gap = {'loss': float((loss - ref_loss).abs() / ref_loss.abs())}
        for key, ref in ref_grads.items():
            diff = (grads[key] - ref).abs()
            if 'embeddings' in key or key.endswith('_biases'):
                gap['table_share'] = max(gap.get('table_share', 0.0),
                                         float((diff > grad_scale * scale).float().mean()))
                gap['table_max'] = max(gap.get('table_max', 0.0), float(diff.max()) / scale)
            else:
                gap['weights'] = max(gap.get('weights', 0.0), float(diff.max()) / scale)
        if (gap['loss'] > loss_rtol or gap.get('table_share', 0.0) > MAX_FLIPPED_FRACTION
                or gap.get('weights', 0.0) > GENERIC_DENSE_GRAD_SCALE):
            raise AssertionError(f'{label}: step {s} apart from the reference step: {gap}')
        worst = {k: max(v, gap.get(k, 0.0)) for k, v in worst.items()}
    return worst


def epoch_report(label, got: dict, ref: dict) -> dict:
    """The epoch as a whole: finite step losses and a mean within
    GENERIC_EPOCH_MEAN_RTOL of ``ref``'s; with the largest per-step loss gap
    and each param's largest difference over max|ref| for the log."""
    a, b = got['losses'], ref['losses']
    mean_gap = float((a.mean() - b.mean()).abs() / b.mean().abs())
    if not torch.isfinite(a).all() or mean_gap > GENERIC_EPOCH_MEAN_RTOL:
        raise AssertionError(f'{label}: epoch loss apart by {mean_gap:.3g} (rtol '
                             f'{GENERIC_EPOCH_MEAN_RTOL})')
    params = max(float((got['params'][k].float() - v.float()).abs().max())
                 / max(float(v.float().abs().max()), 1e-30) for k, v in ref['params'].items())
    return {'mean_gap': mean_gap, 'step_loss_gap': float(((a - b).abs() / b.abs()).max()),
            'param_gap': params}


def check_bf16_selection(model, batch) -> dict:
    """The bfloat16 selection pass against the float32 scores at one step's
    batch: a row may select another negative only where the float32 scores
    of the two lie within their bfloat16 rounding bounds; the step's loss
    within GENERIC_BF16_LOSS_RTOL of the float32 selection's."""
    params = model.params
    users, negs = batch['users'].long(), batch['neg_items'].long().T
    with torch.no_grad():
        f32 = model.pairwise_scores(params, users, negs)
        with knobs('1', '1', '1'):
            bf16 = model.pairwise_scores_select(params, users, negs)
            bf16_loss = model.calculate_loss(params, batch, training=True)
        with knobs('1', '0', '1'):
            f32_loss = model.calculate_loss(params, batch, training=True)
        ue, ie = params['user_embeddings'], params['item_embeddings']
        bound = (2.0 ** -7 * (ue[users].abs()[None] * ie[negs].abs()).sum(-1)
                 + 2.0 ** -8 * params['item_biases'][negs].abs())
    cols = torch.arange(negs.shape[1], device=negs.device)
    pick_f32, pick_bf16 = f32.argmax(0), bf16.argmax(0)
    flipped = pick_f32 != pick_bf16
    gap = f32[pick_f32, cols] - f32[pick_bf16, cols]
    allowed = bound[pick_f32, cols] + bound[pick_bf16, cols]
    bad = int((flipped & (gap > allowed)).sum())
    loss_gap = float((bf16_loss - f32_loss).abs() / f32_loss.abs())
    if bad or loss_gap > GENERIC_BF16_LOSS_RTOL:
        raise AssertionError(f'bf16 selection: {bad} rows select a negative the rounding '
                             f'bound does not allow; loss apart by {loss_gap:.3g}')
    return {'flipped_share': float(flipped.float().mean()), 'loss_gap': loss_gap,
            'max_abs_err': float((bf16 - f32).abs().max())}


def _state_line(run: dict) -> str:
    return (f'{run["examples_per_s"]:,.0f} examples/s an epoch, {run["launches_per_step"]:.1f} '
            f'device launches a step, card busy {run["busy_share"]:.1%} of the span')


def phase_generic_epoch(ml10m: dict, zoo: dict, smi: str) -> dict:
    """Phase 10 (module docstring): the generic epoch in each route of
    ``calculate_loss`` and the table layout at the ML-10M-scale and zoo-scale
    configurations; a NeuMF whole fit with every host sync an error; no
    epoch kernel launched, the cycle-walk and the bucketed sampler kernel
    once an epoch.  Returns the kernels' launches."""
    import collie_tpu_torch

    start = time.perf_counter()
    reset_launch_counts()
    epochs = 0
    dense, sparse_named, sparse_fused, default = GENERIC_STATES
    # (a) ML-10M scale, the four states
    model = ml10m_model(ml10m[0])
    runs = {}
    for state in GENERIC_STATES:
        runs[state[0]] = generic_epoch_state(model, state, seed=7, epoch=1,
                                             keep_steps=state in (dense, sparse_named))
        epochs += runs[state[0]]['epochs']
    held = {
        'sparse-f32 vs dense, each step': hold_steps(
            'ML-10M sparse-f32+named', model, sparse_named, dense, runs['dense+named']['steps'],
            GENERIC_SPARSE_RTOL, GENERIC_GRAD_SCALE),
        'fused vs named, each step': hold_steps(
            'ML-10M sparse-f32+fused', model, sparse_fused, sparse_named,
            runs['sparse-f32+named']['steps'], GENERIC_FUSED_RTOL, GENERIC_FUSED_RTOL)}
    epochs_held = {label: epoch_report(f'ML-10M {label}', run, runs['dense+named'])
                   for label, run in runs.items() if label != 'dense+named'}
    selection = check_bf16_selection(model, runs['dense+named']['steps'][0][1])
    for label, run in runs.items():
        log(f'generic_epoch (a) ML-10M-scale {label}: {_state_line(run)}; step losses '
            f'{[round(x, 6) for x in run["losses"][:3].tolist()]} ... ({smi})')
    log(f'generic_epoch (a) ML-10M-scale, each step from the reference\'s state: {held}; '
        f'each epoch against dense+named: {epochs_held}; first step: the bf16 selection picks '
        f'another negative in {selection["flipped_share"]:.3%} of rows, each within the '
        f'rounding bound, loss within {selection["loss_gap"]:.3g} of the f32 selection\'s '
        f'(max |bf16 - f32| score {selection["max_abs_err"]:.3g}); '
        f'{time.perf_counter() - start:.1f}s')
    del model, runs
    torch.cuda.empty_cache()

    # (b) zoo scale: the zoo models (adaptive, no dropout), ColdStart in both
    # stages and MF with WARP, sparse (+ fused where the model has the
    # layout) against dense + named
    train = zoo['train']
    kwargs_of = dict(ZOO_MODELS)
    cold_kwargs = dict(MULTI_STAGE_MODELS[2][1])
    builds = [(name, lambda name=name: getattr(collie_tpu_torch, name)(
        train=zoo_loader(train), seed=42, **kwargs_of[name]), None) for name in GENERIC_ZOO]

    def cold():
        return collie_tpu_torch.ColdStartModel(
            train=zoo_loader(train), seed=42,
            item_buckets=np.arange(train.num_items) % MULTI_STAGE_BUCKETS, **cold_kwargs)

    def mf_warp():
        return collie_tpu_torch.MatrixFactorizationModel(
            train=zoo_loader(train), seed=42, embedding_dim=ZOO_DIM, lr=1e-1, loss='warp')

    builds += [('ColdStartModel', cold, 'item_buckets'), ('ColdStartModel', cold, 'no_buckets'),
               ('MatrixFactorizationModel warp', mf_warp, None)]
    for label, build, stage in builds:
        t0 = time.perf_counter()
        model = build()
        while stage is not None and model.current_stage != stage:
            model.advance_stage()
        if model.selection_route(ZOO_DATA['num_negative_samples']) != 'sparse':
            raise AssertionError(f'{label}: the sparse form does not apply')
        # MF selects in bfloat16 by default; the held comparison is float32
        ref = generic_epoch_state(model, dense, seed=42, epoch=1, keep_steps=True)
        got = generic_epoch_state(model, sparse_fused, seed=42, epoch=1)
        epochs += ref['epochs'] + got['epochs']
        check = {'each step': hold_steps(f'zoo {label}', model, sparse_fused, dense,
                                         ref['steps'], GENERIC_SPARSE_RTOL, GENERIC_GRAD_SCALE),
                 'epoch': epoch_report(f'zoo {label}', got, ref)}
        extra = ''
        if model.selection_precision() == 'bf16':
            run = generic_epoch_state(model, default, seed=42, epoch=1)
            epochs += run['epochs']
            check['bf16 epoch'] = epoch_report(f'zoo {label} bf16', run, ref)
            extra = f'; default (bf16 selection): {_state_line(run)}'
        layout = 'fused' if model.supports_fused_tables() else 'named'
        log(f'generic_epoch (b) zoo {label}{" stage " + stage if stage else ""}: dense+named '
            f'{_state_line(ref)}; sparse-f32+{layout} {_state_line(got)}{extra}; {check} '
            f'({smi}); {time.perf_counter() - t0:.1f}s')
        del model, ref, got
        torch.cuda.empty_cache()

    # (c) a NeuMF whole fit on the sparse form and fused tables, every host
    # sync inside a flight an error
    fit = record_fit(lambda: collie_tpu_torch.NeuralCollaborativeFiltering(
        train=zoo_loader(train), seed=42, **kwargs_of['NeuralCollaborativeFiltering']),
        True, 'NeuMF generic whole fit', smi, guard=sync_errors,
        epochs=GENERIC_WHOLE_FIT_EPOCHS, seed=42)
    epochs += fit['epochs']
    if fit['epochs'] != GENERIC_WHOLE_FIT_EPOCHS or not np.all(np.isfinite(fit['losses'])):
        raise AssertionError(f'NeuMF whole fit: {fit["epochs"]} epochs, losses {fit["losses"]}')
    log(f'generic_epoch (c) NeuMF whole fit, {GENERIC_WHOLE_FIT_EPOCHS} epochs, sparse + fused '
        f'tables, set_sync_debug_mode("error") around every flight: no host sync; losses '
        f'{[round(x, 5) for x in fit["losses"]]}; {fit["examples_per_s"]:,.0f} examples/s '
        f'({smi})')
    del fit
    torch.cuda.empty_cache()

    # (d) no epoch kernel on these paths; the cycle-walk once an epoch, the
    # bucketed sampler kernel once an epoch
    launches = _kernel_counts()
    log(f'generic_epoch (d) kernel launches {launches} over {epochs} epochs; '
        f'{time.perf_counter() - start:.1f}s')
    if launches.pop(SHUFFLE_WRAPPER) < epochs or launches.pop(SAMPLER_WRAPPER) != epochs \
            or any(launches.values()):
        raise AssertionError(f'generic_epoch kernel launches {_kernel_counts()}, '
                             f'{epochs} epochs')
    return _kernel_counts()


def ooc_data():
    """``benchmarks/bench_outofcore.py``'s ``make_data(default_rng(0))``:
    ``(users, items)`` int32, the first occurrence of each distinct pair
    among 4,000,000 uniform draws, cut to 2,000,000."""
    rng = np.random.default_rng(0)
    users = rng.integers(0, OOC_NUM_USERS, OOC_NUM_INTERACTIONS * 2)
    items = rng.integers(0, OOC_NUM_ITEMS, OOC_NUM_INTERACTIONS * 2)
    _, first = np.unique(users.astype(np.int64) * OOC_NUM_ITEMS + items, return_index=True)
    first = first[:OOC_NUM_INTERACTIONS]
    return users[first].astype(np.int32), items[first].astype(np.int32)


def memory_store_class():
    """``HDF5Interactions`` over two arrays in host memory: the same
    ``read_chunk`` (the one read of the store) and size attributes, for a
    machine without ``h5py``.  Everything above the read is the port's own
    code."""
    from collie_tpu_torch import HDF5Interactions

    class MemoryStore(HDF5Interactions):
        def __init__(self, users, items, num_users, num_items, num_negative_samples, shuffle,
                     seed):
            self.hdf5_path = None
            self.users, self.items = users, items
            self.num_interactions = len(users)
            self.num_users, self.num_items = num_users, num_items
            self.num_negative_samples = num_negative_samples
            self.shuffle, self.seed = shuffle, seed
            self._rng = np.random.default_rng(seed)

        def read_chunk(self, start, stop):
            return self.users[start:stop], self.items[start:stop]

    return MemoryStore


def ooc_store(users, items, directory):
    """``(make_loader, kind)``: ``make_loader()`` builds the benchmark's
    loader over a real HDF5 store in ``directory`` when ``h5py`` imports,
    else over ``memory_store_class()``."""
    from collie_tpu_torch import HDF5InteractionsDataLoader, write_hdf5_meta

    kw = dict(batch_size=OOC_BATCH, shuffle=True, seed=0)
    try:
        import h5py
    except ImportError:
        store = memory_store_class()

        def make_loader():
            return HDF5InteractionsDataLoader(
                interactions=store(users, items, OOC_NUM_USERS, OOC_NUM_ITEMS, OOC_K,
                                   shuffle=True, seed=0), **kw)
        return make_loader, 'an in-memory stand-in serving read_chunk (no h5py here)'
    path = os.path.join(directory, 'interactions.h5')
    with h5py.File(path, 'w') as f:
        group = f.require_group('interactions')
        group.create_dataset('user_id', data=users)
        group.create_dataset('item_id', data=items)
    write_hdf5_meta(path, OOC_NUM_USERS, OOC_NUM_ITEMS)

    def make_loader():
        return HDF5InteractionsDataLoader(hdf5_path=path, num_negative_samples=OOC_K, **kw)
    return make_loader, f'h5py {h5py.__version__}, {os.path.getsize(path) / 1e6:.1f} MB'


def ooc_model(loader, device=None):
    from collie_tpu_torch import MatrixFactorizationModel

    return MatrixFactorizationModel(train=loader, embedding_dim=OOC_DIM, lr=OOC_LR,
                                    loss='adaptive_hinge', seed=0, map_location=device)


def chunk_tensors(loader, start: int, steps: int, device):
    """A chunk's ``(users, items, mask)`` on ``device``, read and copied by
    the trainer's own helpers (pinned host buffers and non-blocking copies
    on the card)."""
    from collie_tpu_torch.training import trainer

    _, n_used = trainer.hdf5_epoch_extent(loader)
    return trainer.hdf5_chunk_to_device(
        trainer.read_hdf5_chunk(loader, start, steps, n_used, device), device)


def profile_chunk(make_loader, steps: int = 16) -> dict:
    """11(d): one chunk of ``steps`` steps of the chunk tier, after a warm
    run, under ``torch.profiler``: device launches a step and the card's
    busy share of the span (the rest is the host issuing launches)."""
    from collie_tpu_torch.training import scan_engine

    loader = make_loader()
    model = ooc_model(loader)
    plan = scan_engine.hdf5_chunk_plan(-(-loader.num_interactions // OOC_BATCH),
                                       OOC_CHUNK_STEPS)
    start = next(s for s, n in plan if n == steps)
    specs = model.optimizer_specs()
    params = dict(model.params)
    states = tuple(spec.transform.init({k: params[k] for k in spec.keys}) for spec in specs)
    chunk_fn = scan_engine.build_hdf5_chunk_make(model, specs, [True] * len(specs), loader,
                                                 shuffle=True)(steps)
    tensors = chunk_tensors(loader, start, steps, model.device)

    def call():
        chunk_fn(params, states, *tensors, 0, 1, 0)
    call()
    launches, busy, span = device_activity(call)
    out = {'launches_per_step': launches / steps, 'busy_share': busy / span if span else 0.0}
    log(f'out_of_core (d) one {steps}-step chunk under torch.profiler: '
        f'{out["launches_per_step"]:.1f} device launches a step, the card busy '
        f'{out["busy_share"]:.1%} of the span ({span / 1e3:.1f} ms)')
    return out


def hold_first_chunk(make_loader) -> float:
    """11(b): epoch 1's first chunk, read and copied by the trainer's own
    helpers, through the chunk function on the card and on the CPU, from
    the same params on the same draws (the port's
    ``draw_chunk`` on the CPU, handed to both).  The card's shuffled
    batches (ids, negatives, mask) equal the CPU's bit for bit and the two
    runs' per-step losses agree within STEP_RTOL; every step of the CPU's
    run is also taken on the card from the CPU's state before it, and its
    tables held as the constants' comment says.  Returns the max abs table
    difference of a held step."""
    from collie_tpu_torch.training import scan_engine
    from collie_tpu_torch.training.optimizers import state_from_leaves, state_leaves

    def to(device, tree):
        if isinstance(tree, dict):
            return {k: v.to(device) for k, v in tree.items()}
        return tuple(state_from_leaves(st, iter([leaf.to(device) if torch.is_tensor(leaf)
                                                 else leaf for leaf in state_leaves(st)]))
                     for st in tree)

    loader = make_loader()
    card_model, cpu_model = ooc_model(loader), ooc_model(loader, 'cpu')
    cpu_model.load_params({k: v.cpu() for k, v in card_model.params.items()})
    plan = scan_engine.hdf5_chunk_plan(-(-loader.num_interactions // OOC_BATCH),
                                       OOC_CHUNK_STEPS)
    start, steps = plan[np.random.default_rng((loader.seed, 1)).permutation(len(plan))[0]]
    C = steps * OOC_BATCH
    keys, negs, _ = scan_engine.draw_chunk(0, 1, 0, 'cpu', C, (C, OOC_K), OOC_NUM_ITEMS,
                                           steps, False)
    card_specs = card_model.optimizer_specs()
    draw_chunk, train_step = scan_engine.draw_chunk, scan_engine.train_step
    runs, held = {}, {'worst': 0.0, 'beyond': 0.0, 'loss': 0.0}

    def hold(params_, states_, batch, rest, cpu_out):
        """The CPU step's inputs through one card step, against its outputs."""
        card_out = train_step(card_model, card_specs, [True] * len(card_specs),
                              to('cuda', params_), to('cuda', states_),
                              {k: v.cuda() for k, v in batch.items()}, *rest)
        held['loss'] = max(held['loss'], abs(float(card_out[2]) / float(cpu_out[2]) - 1))
        for k, b in cpu_out[0].items():
            diff = (card_out[0][k].cpu() - b).abs()
            beyond = float((diff > STEP_RTOL * b.abs() + STEP_ATOL_SCALE * b.abs().max())
                           .float().mean())
            held['worst'] = max(held['worst'], float(diff.max()))
            held['beyond'] = max(held['beyond'], beyond)

    for name, model in (('card', card_model), ('cpu', cpu_model)):
        device = model.device
        losses, batches = [], []

        def recording_step(model_, specs_, active_, params_, states_, batch, *rest):
            out = train_step(model_, specs_, active_, params_, states_, batch, *rest)
            losses.append(out[2])
            batches.append({k: v.cpu() for k, v in batch.items()})
            if model_ is cpu_model:
                hold(params_, states_, batch, rest, out)
            return out
        scan_engine.draw_chunk = lambda *a, **k: (keys.to(device), negs.to(device), None)
        scan_engine.train_step = recording_step
        try:
            specs = model.optimizer_specs()
            params = dict(model.params)
            states = tuple(spec.transform.init({k: params[k] for k in spec.keys})
                           for spec in specs)
            chunk_fn = scan_engine.build_hdf5_chunk_make(model, specs, [True] * len(specs),
                                                         loader, shuffle=True)(steps)
            _, _, loss_sum = chunk_fn(params, states,
                                      *chunk_tensors(loader, start, steps, device), 0, 1, 0)
        finally:
            scan_engine.draw_chunk, scan_engine.train_step = draw_chunk, train_step
        runs[name] = {'losses': torch.stack(losses).cpu(), 'batches': batches,
                      'sum': float(loss_sum)}
    card, cpu = runs['card'], runs['cpu']
    if not all(all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(card['batches'], cpu['batches'])):
        raise AssertionError('out_of_core (b): the card\'s shuffled batches differ from the '
                             'CPU\'s')
    if not torch.allclose(card['losses'], cpu['losses'], rtol=STEP_RTOL, atol=0):
        raise AssertionError(f'out_of_core (b): per-step losses differ: '
                             f'{card["losses"][:4].tolist()} vs {cpu["losses"][:4].tolist()}')
    if held['beyond'] > MAX_FLIPPED_FRACTION or held['loss'] > STEP_RTOL:
        raise AssertionError(f'out_of_core (b): a held step differs from the CPU\'s: loss by '
                             f'{held["loss"]:.3g}, tables beyond tolerance in '
                             f'{held["beyond"]:.3%} of elements')
    log(f'out_of_core (b) epoch 1, chunk 0 ({steps} steps from step {start}), card vs CPU on '
        f'the same draws: shuffled batches bit-identical, per-step losses within rtol '
        f'{STEP_RTOL} (sum {card["sum"]:.6f} vs {cpu["sum"]:.6f}); each step from the CPU\'s '
        f'state: loss within {held["loss"]:.3g}, max abs table difference {held["worst"]:.3g}, '
        f'at most {held["beyond"]:.2e} of a table\'s elements beyond tolerance')
    return held['worst']


def ooc_timed_fit(label, build, smi, epoch_mode='auto', guard=None) -> dict:
    """One label of the benchmark: a warm-up epoch, then OOC_EPOCHS - 1
    one-epoch fits (the trainer's ``max_epochs`` raised by one each), each
    timed to the card's idle; with ``guard`` as ``trainer.flight_guard``."""
    from collie_tpu_torch import CollieTrainer
    from collie_tpu_torch.training import trainer as trainer_module

    model = build()
    metrics = _MetricLog()
    trainer = CollieTrainer(model, max_epochs=1, verbosity=0, epoch_mode=epoch_mode, seed=0,
                            logger=metrics)
    start = time.perf_counter()
    trainer.fit(model)
    torch.cuda.synchronize()
    warm = time.perf_counter() - start
    seconds, guard_before = [], trainer_module.flight_guard
    trainer_module.flight_guard = guard or guard_before
    try:
        for _ in range(OOC_EPOCHS - 1):
            trainer.max_epochs += 1
            start = time.perf_counter()
            trainer.fit(model)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
    finally:
        trainer_module.flight_guard = guard_before
    n = model.train_loader.num_interactions
    rate = n / statistics.median(seconds)
    log(f'out_of_core (d) {label}: warm-up {warm:.2f}s, epochs '
        f'{[round(x, 4) for x in seconds]} s, {rate:,.0f} examples/s an epoch (median of '
        f'{len(seconds)}); train loss by epoch {[round(x, 6) for x in metrics.epochs]} ({smi})')
    return {'examples_per_s': rate, 'losses': metrics.epochs, 'trainer': trainer}


def phase_out_of_core(smi: str) -> dict:
    """Phase 11 (module docstring): the out-of-core chunk tier at
    ``benchmarks/bench_outofcore.py``'s configuration.  Returns the
    launches of the cycle-walk, and of ``fused_mf_epoch`` and the bucketed
    sampler kernel (the in-memory label's, one an epoch) over the phase."""
    from collie_tpu_torch import Interactions, MatrixFactorizationModel, PrefetchLoader
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch
    from collie_tpu_torch.ops.shuffle import feistel_permutation_from_keys
    from collie_tpu_torch.training import scan_engine, trainer as trainer_module

    started = time.perf_counter()
    users, items = ooc_data()
    with tempfile.TemporaryDirectory() as directory:
        make_loader, kind = ooc_store(users, items, directory)
        log(f'out_of_core: {len(users):,} interactions, {OOC_NUM_USERS:,} users x '
            f'{OOC_NUM_ITEMS:,} items; the store: {kind}')
        os.environ['COLLIE_TPU_HDF5_CHUNK_STEPS'] = str(OOC_CHUNK_STEPS)
        try:
            worst = hold_first_chunk(make_loader)
            activity = profile_chunk(make_loader)
            # (a) + (c) + (d): the chunk tier, every chunk loop under sync errors
            made, build_make = [], trainer_module.build_hdf5_chunk_make

            def recording_make(*args, **kwargs):
                make = build_make(*args, **kwargs)

                def make_recorded(num_steps):
                    made.append(num_steps)
                    return make(num_steps)
                return make_recorded
            trainer_module.build_hdf5_chunk_make = recording_make
            reset_launch_counts()
            try:
                chunk = ooc_timed_fit('hdf5_chunk', lambda: ooc_model(make_loader()), smi,
                                      guard=sync_errors)
            finally:
                trainer_module.build_hdf5_chunk_make = build_make
            walks, fused = feistel_permutation_from_keys.launches, fused_mf_epoch.launches
            steps = -(-OOC_NUM_INTERACTIONS // OOC_BATCH)
            plan = [n for _, n in scan_engine.hdf5_chunk_plan(steps, OOC_CHUNK_STEPS)]
            log_ = chunk['trainer'].epoch_log
            if plan != OOC_PLAN or sorted(set(made)) != sorted(set(OOC_PLAN)) \
                    or any(row['steps'] != steps for row in log_):
                raise AssertionError(f'out_of_core (a): plan {plan}, chunk functions built for '
                                     f'{made}, steps an epoch {[r["steps"] for r in log_]}')
            if walks != len(OOC_PLAN) * OOC_EPOCHS or fused:
                raise AssertionError(f'out_of_core (a): {walks} cycle-walk launches for '
                                     f'{OOC_EPOCHS} epochs of {len(OOC_PLAN)} chunks, '
                                     f'{fused} fused_mf_epoch launches')
            log(f'out_of_core (a) the chunk tier ran: {steps} steps an epoch in chunks of '
                f'{plan}; {walks} cycle-walk launches over {OOC_EPOCHS} epochs, fused_mf_epoch '
                f'0; (c) every chunk loop of the {OOC_EPOCHS - 1} timed epochs ran under '
                f'set_sync_debug_mode("error"): no host sync but the epoch loss\'s read')
            losses = chunk['losses']
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f'out_of_core (e): train loss {losses} does not fall')
            log(f'out_of_core (e) the chunk tier\'s train loss falls: {losses[0]:.6f} -> '
                f'{losses[-1]:.6f} over {len(losses)} epochs')
            rates = {'hdf5_chunk': chunk['examples_per_s']}
            reset_launch_counts()
            for label, wrap in (('hdf5_step', None), ('hdf5_prefetch', PrefetchLoader)):
                rates[label] = ooc_timed_fit(
                    label, lambda: ooc_model(wrap(make_loader()) if wrap else make_loader()),
                    smi, epoch_mode='step')['examples_per_s']
            if any(w.launches for w in kernel_wrappers()):
                raise AssertionError('out_of_core: the per-step path launched a kernel')
        finally:
            os.environ.pop('COLLIE_TPU_HDF5_CHUNK_STEPS', None)
    reset_launch_counts()
    rates['in_memory'] = ooc_timed_fit(
        'in_memory', lambda: MatrixFactorizationModel(
            train=Interactions(users=users, items=items, num_negative_samples=OOC_K,
                               allow_missing_ids=True),
            embedding_dim=OOC_DIM, lr=OOC_LR, loss='adaptive_hinge', seed=0), smi)['examples_per_s']
    in_memory = {'walks': feistel_permutation_from_keys.launches,
                 'fused': fused_mf_epoch.launches, 'sampled': _kernel_counts()[SAMPLER_WRAPPER]}
    if in_memory['sampled'] != OOC_EPOCHS:
        raise AssertionError(f'out_of_core (d) in_memory: {in_memory["sampled"]} sampler kernel '
                             f'launches for {OOC_EPOCHS} epochs')
    log(f'out_of_core (d) examples/s an epoch: '
        + ', '.join(f'{k} {v:,.0f}' for k, v in rates.items())
        + f'; chunk tier / in-memory {rates["hdf5_chunk"] / rates["in_memory"]:.3f}, '
        f'/ per-step {rates["hdf5_chunk"] / rates["hdf5_step"]:.3f} ({smi}); '
        f'phase {time.perf_counter() - started:.1f}s')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {'shuffle': walks + in_memory['walks'], 'fused': in_memory['fused'],
            'sampled': in_memory['sampled'], 'max_abs_err': worst, 'rates': rates,
            'activity': activity}


def serving_data(seed: int):
    """Seeded implicit interactions at the serving scale, split per user."""
    from collie_tpu_torch.data import Interactions, stratified_split

    rng = np.random.default_rng(seed)
    users = rng.integers(0, NUM_USERS, NUM_INTERACTIONS)
    # skewed item popularity: low ranks are popular, ranks map to random ids
    ranks = np.floor(NUM_ITEMS * rng.random(NUM_INTERACTIONS) ** 3).astype(np.int64)
    items = rng.permutation(NUM_ITEMS)[ranks]
    inter = Interactions(users=users, items=items, num_users=NUM_USERS,
                         num_items=NUM_ITEMS, allow_missing_ids=True,
                         num_negative_samples=10, seed=seed)
    train, test = stratified_split(inter, test_p=0.2, seed=seed, force_split=True)
    eval_users = np.sort(rng.choice(np.unique(test.mat.row), EVAL_USERS, replace=False))
    keep = np.isin(test.mat.row, eval_users)
    test_eval = Interactions(users=test.mat.row[keep], items=test.mat.col[keep],
                             num_users=NUM_USERS, num_items=NUM_ITEMS,
                             allow_missing_ids=True,
                             check_num_negative_samples_is_valid=False, seed=seed)
    return train, test_eval


def dense_reference(model, users: np.ndarray, seen_csr=None, k: int = K):
    """Dense stable top-(k+1) on the card: the whole catalog scored with one
    matmul, seen items masked by CSR row scatter."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import NEG_INF, stable_topk_plain

    with torch.no_grad():
        scores = model.score_all_items(model.params, model._ids(users))
        if seen_csr is not None:
            rows = seen_csr[users]
            r = np.repeat(np.arange(len(users)), np.diff(rows.indptr))
            scores[torch.as_tensor(r, device=model.device),
                   torch.as_tensor(rows.indices.astype(np.int64), device=model.device)] = NEG_INF
        ref_scores, ref_ids = stable_topk_plain(scores, k + 1)
    return ref_ids[:, :k], ref_scores[:, :k], ref_scores[:, k]


def phase_serving(seed: int, record: dict, select_record: dict):
    from collie_tpu_torch import MatrixFactorizationModel, auc, evaluate_in_batches, mapk, mrr
    from collie_tpu_torch.ops import metrics as metrics_lib
    from collie_tpu_torch.ops.kernels.retrieval_kernel import mf_topk_retrieve
    from collie_tpu_torch.retrieval import recommend

    start = time.perf_counter()
    train, test = serving_data(seed)
    log(f'serving data: {train.num_interactions} train / {test.num_interactions} test '
        f'interactions, {NUM_USERS} users x {NUM_ITEMS} items '
        f'({time.perf_counter() - start:.1f}s)')

    built = MatrixFactorizationModel(train=train, embedding_dim=EMBEDDING_DIM, seed=seed)
    path = os.path.join('data', f'chip_smoke_mf_{os.getpid()}.npz')
    try:
        built.save_model(path)
        model = MatrixFactorizationModel(train=train, load_model_path=path)
    finally:
        if os.path.exists(path):
            os.unlink(path)
    for name, value in built.params.items():
        if not torch.equal(value, model.params[name]):
            raise AssertionError(f'npz round trip changed {name}')
    if model.device.type != 'cuda':
        raise AssertionError(f'model loaded on {model.device}')
    del built
    torch.cuda.synchronize()
    log(f'model: MF embedding_dim={EMBEDDING_DIM} built, saved to npz and reloaded '
        f'on {model.device}; params {sorted(model.state_dict())}')

    rng = np.random.default_rng(seed + 1)
    seen_csr = train.mat.tocsr()
    torch.cuda.reset_peak_memory_stats()
    timings = {False: [], True: []}
    requests = [(False, rng.choice(NUM_USERS, REQUEST_USERS, replace=False)) for _ in range(4)]
    requests += [(True, rng.choice(NUM_USERS, REQUEST_USERS, replace=False)) for _ in range(2)]
    selections = sum(recommend_selections(model, REQUEST_USERS, filter_seen)
                     for filter_seen, _ in requests)
    answers = []
    reset_launch_counts()
    for filter_seen, users in requests:
        t0 = time.perf_counter()
        ids, scores = recommend(model, users, k=K, filter_seen=filter_seen)
        torch.cuda.synchronize()
        timings[filter_seen].append((time.perf_counter() - t0) * 1e3)
        answers.append((filter_seen, users, ids, scores))
    counts = _kernel_counts()
    launches = counts['mf_topk_retrieve']
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = dict.fromkeys(counts, 0)
    expected.update(mf_topk_retrieve=4, stable_topk=selections)
    if counts != expected:
        raise AssertionError(f'kernel launches during serving: {counts}, expected {expected}')
    reset_launch_counts()
    record['launches'] = launches
    select_record['launches'] += counts['stable_topk']

    for n, (filter_seen, users, ids, scores) in enumerate(answers):
        ref_ids, ref_scores, ref_next = dense_reference(
            model, users, seen_csr if filter_seen else None)
        check_topk(f'request {n} filter_seen={filter_seen}', torch.as_tensor(ids),
                   torch.as_tensor(scores), ref_ids, ref_scores, ref_next)
        if filter_seen:
            for row, u in zip(ids, users):
                seen = seen_csr.indices[seen_csr.indptr[u]:seen_csr.indptr[u + 1]]
                if np.isin(row, seen).any():
                    raise AssertionError(f'user {u}: a seen item was recommended')
        del ref_ids, ref_scores, ref_next
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f'recommend ms per request of {REQUEST_USERS} users: kernel path (filter_seen=False) '
        f'{[round(t, 3) for t in timings[False]]}, blockwise path (filter_seen=True) '
        f'{[round(t, 3) for t in timings[True]]}; topk_tile launches {launches}, selections '
        f'{counts["stable_topk"]}; peak device memory {peak_gb:.3f} GB')

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], test, model, k=K)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in (map_k, mrr_v, auc_v)):
        raise AssertionError(f'metrics out of range: {map_k}, {mrr_v}, {auc_v}')
    # the rank-count metrics against the dense-relevance ones on 64 users
    users = np.unique(test.mat.row)[:64]
    targets = test.mat.tocsr()
    with torch.no_grad():
        preds = model.score_all_items(model.params, model._ids(users))
        pos, mask = metrics_lib.padded_positives(targets, users)
        fused = metrics_lib.metrics_from_positive_ranks(
            preds, torch.as_tensor(pos, device=model.device),
            torch.as_tensor(mask, device=model.device),
            K).mean(dim=1).tolist()
    dense = [mapk(targets, users, preds, K), mrr(targets, users, preds), auc(targets, users, preds)]
    if not np.allclose(fused, dense, rtol=1e-5, atol=1e-6):
        raise AssertionError(f'rank-count metrics {fused} vs dense {dense}')
    torch.cuda.synchronize()
    log(f'evaluate_in_batches on {len(np.unique(test.mat.row))} test users: MAP@{K}={map_k:.6f} '
        f'MRR={mrr_v:.6f} AUC={auc_v:.6f} in {eval_s:.2f}s, peak device memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; rank counts equal dense '
        f'metrics on 64 users ({fused} vs {dense})')
    return model, train, test


def phase_mesh(serving, record: dict, select_record: dict) -> None:
    """Phase 13: ``recommend`` and ``evaluate_in_batches`` under a
    ``make_mesh(data=1, model=1)`` on the card (NCCL, world size 1, a
    ``file://`` rendezvous in a temporary directory) against the
    single-device calls, on phase 4's model.  The mesh requests run first,
    with the counts zeroed: the top-k kernel must launch once for each
    ``filter_seen=False`` one (the local-table tier's kernel path)."""
    import torch.distributed as dist

    from collie_tpu_torch import auc, evaluate_in_batches, mapk, mrr
    from collie_tpu_torch.ops.kernels.retrieval_kernel import mf_topk_retrieve
    from collie_tpu_torch.parallel import distributed, make_mesh
    from collie_tpu_torch.retrieval import recommend

    model, train, test = serving
    rng = np.random.default_rng(MESH_SEED)
    requests = [(filter_seen, rng.choice(NUM_USERS, REQUEST_USERS, replace=False))
                for filter_seen in MESH_REQUESTS]
    with tempfile.TemporaryDirectory() as directory:
        distributed.initialize(f'file://{directory}/rendezvous', num_processes=1, process_id=0)
        if dist.is_initialized():
            raise AssertionError('initialize(num_processes=1) must be a no-op')
        dist.init_process_group('nccl', init_method=f'file://{directory}/rendezvous',
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(data=1, model=1)
            backend = dist.get_backend()
            log(f'mesh: {mesh} on {backend}, device {torch.cuda.current_device()}')
            reset_launch_counts()
            answers, mesh_ms = [], []
            for filter_seen, users in requests:
                t0 = time.perf_counter()
                answers.append(recommend(model, users, k=K, filter_seen=filter_seen, mesh=mesh))
                torch.cuda.synchronize()
                mesh_ms.append((time.perf_counter() - t0) * 1e3)
            launches = {w.__name__: w.launches for w in kernel_wrappers()}
            expected = dict.fromkeys(launches, 0)
            expected['mf_topk_retrieve'] = MESH_REQUESTS.count(False)
            expected['stable_topk'] = sum(recommend_selections(model, REQUEST_USERS, filter_seen,
                                                               shards=1)
                                          for filter_seen in MESH_REQUESTS)
            if launches != expected:
                raise AssertionError(f'mesh recommend launches {launches}, expected {expected}')
            record['launches'] += launches['mf_topk_retrieve']
            select_record['launches'] += launches['stable_topk']
            t0 = time.perf_counter()
            mesh_metrics = evaluate_in_batches([mapk, mrr, auc], test, model, k=K, mesh=mesh)
            torch.cuda.synchronize()
            mesh_eval_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    single_ms, worst = [], 0.0
    for (filter_seen, users), (ids, scores) in zip(requests, answers):
        t0 = time.perf_counter()
        ref_ids, ref_scores = recommend(model, users, k=K, filter_seen=filter_seen)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(ids, ref_ids):
            raise AssertionError(f'mesh recommend filter_seen={filter_seen}: ids differ in '
                                 f'{int((ids != ref_ids).any(axis=1).sum())} rows')
        if not np.allclose(scores, ref_scores, rtol=RTOL, atol=ATOL):
            raise AssertionError(f'mesh recommend filter_seen={filter_seen}: scores differ')
        worst = max(worst, float(np.abs(scores - ref_scores).max()))
    mf_topk_retrieve.launches = 0
    single = evaluate_in_batches([mapk, mrr, auc], test, model, k=K)
    if not np.allclose(mesh_metrics, single, rtol=1e-5, atol=1e-7):
        raise AssertionError(f'mesh evaluate {mesh_metrics} vs single device {single}')
    log(f'mesh (data=1, model=1, {backend}): recommend of {REQUEST_USERS} users filter_seen='
        f'{list(MESH_REQUESTS)}: ids equal the single-device calls, max_abs_err={worst:.3g}; '
        f'ms mesh {[round(t, 3) for t in mesh_ms]} vs single {[round(t, 3) for t in single_ms]}; '
        f'topk_tile launches on the mesh path {launches["mf_topk_retrieve"]}, selections '
        f'{launches["stable_topk"]}; evaluate_in_batches MAP@{K}, MRR, AUC {mesh_metrics} (single device {single}) in '
        f'{mesh_eval_s:.2f}s')
    torch.cuda.empty_cache()


def _params_gap(got: dict, ref: dict) -> float:
    """The largest difference over max|ref| of any param (``epoch_report``'s
    measure)."""
    return max(float((got[k].float() - v.float()).abs().max())
               / max(float(v.float().abs().max()), 1e-30) for k, v in ref.items())


def _record_collectives(log_rows, mesh):
    """Wrap ``torch.distributed``'s collectives to keep ``(op, axis, dtype,
    elements)`` of each call; returns the originals."""
    import torch.distributed as dist

    groups = {}
    for axis in mesh.mesh_dim_names:      # a 1 x 1 mesh's axes share one group
        key = id(mesh.get_group(axis))
        groups[key] = f'{groups[key]}+{axis}' if key in groups else axis
    saved = dist.all_reduce, dist.all_gather

    def reduce_(tensor, *args, **kwargs):
        log_rows.append(('all_reduce', groups.get(id(kwargs.get('group'))),
                         str(tensor.dtype).replace('torch.', ''), tensor.numel()))
        return saved[0](tensor, *args, **kwargs)

    def gather_(parts, tensor, *args, **kwargs):
        log_rows.append(('all_gather', groups.get(id(kwargs.get('group'))),
                         str(tensor.dtype).replace('torch.', ''), tensor.numel() * len(parts)))
        return saved[1](parts, tensor, *args, **kwargs)

    dist.all_reduce, dist.all_gather = reduce_, gather_
    return saved


def hold_mesh_steps(model, mesh, epoch_idx: int, sync=None) -> dict:
    """``MESH_TRAIN_HELD_STEPS`` steps of epoch ``epoch_idx``'s batches,
    each from ``model``'s state (it holds its shards on ``mesh``; fresh
    optimizer states), through the mesh step on this rank's ``data`` slice
    and through the single-card step on the whole batch, on this rank's
    card: losses within ``GENERIC_SPARSE_RTOL``, the gathered params'
    elements beyond ``GENERIC_GRAD_SCALE`` of the update's largest element
    in at most ``MAX_FLIPPED_FRACTION`` (the ``MESH_TRAIN`` comment).
    Returns the worst gaps, the first mesh step's collectives
    (``{'op/axis/dtype': [calls, elements]}``) and its milliseconds
    (``sync``: the wait for the device, ``torch.cuda.synchronize`` by
    default)."""
    import torch.distributed as dist

    from collie_tpu_torch.parallel.distributed import all_reduce_sum, gather_global
    from collie_tpu_torch.parallel.sharding import data_slice, init_sharded_opt_states
    from collie_tpu_torch.training import scan_engine

    specs = model.optimizer_specs()
    active = [True] * len(specs)
    fn, _, _, _ = scan_engine.build_scan_epoch_fns(model, specs, active, model.train_loader,
                                                   shuffle=True, mesh=mesh)
    batches = fn.epoch_batches(7, epoch_idx)
    layout = model.param_layout()[1]
    shards, whole = model.params, model.whole_params()
    mesh_states = init_sharded_opt_states(specs, shards, mesh)
    card_states = init_sharded_opt_states(specs, whole)
    width = batches['mask'].shape[1]
    row0, rows = data_slice(width, mesh)
    sync = sync or torch.cuda.synchronize
    held, log_rows, step_ms = {'loss': 0.0, 'share': 0.0, 'max': 0.0}, [], None
    for step in range(MESH_TRAIN_HELD_STEPS):
        batch = {k: v[step] for k, v in batches.items()}
        local = {}
        for key, value in batch.items():
            extra = row0 + rows - width
            if extra > 0:
                value = torch.cat([value, value.new_zeros((extra,) + value.shape[1:])])
            local[key] = value[row0:row0 + rows]
        scale = local['mask'].sum().clamp(min=1.0) / batch['mask'].sum().clamp(min=1.0)
        saved = _record_collectives(log_rows, mesh) if step == 0 else None
        try:
            sync()
            t0 = time.perf_counter()
            got, _, loss = scan_engine.train_step(
                model, specs, active, model.fuse_params(shards), mesh_states, local,
                fused_tables=True, mesh=mesh, loss_scale=scale)
            sync()
            if step == 0:
                step_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if saved is not None:
                dist.all_reduce, dist.all_gather = saved
        loss = all_reduce_sum(loss, mesh, 'data')
        got = {k: gather_global(v, mesh, layout[k])
               for k, v in model.unfuse_params(got).items()}
        ref, _, ref_loss = scan_engine.train_step(
            model, specs, active, model.fuse_params(whole), card_states, batch,
            fused_tables=True)
        ref = model.unfuse_params(ref)
        gap = {'loss': float((loss.to(ref_loss.device) - ref_loss).abs() / ref_loss.abs())}
        for key, value in ref.items():
            update = float((value.float() - whole[key].float()).abs().max())
            diff = (got[key].float() - value.float()).abs()
            gap['share'] = max(gap.get('share', 0.0), float(
                (diff > GENERIC_GRAD_SCALE * update).float().mean()))
            gap['max'] = max(gap.get('max', 0.0), float(diff.max()) / max(update, 1e-30))
        if gap['loss'] > GENERIC_SPARSE_RTOL or gap['share'] > MAX_FLIPPED_FRACTION:
            raise AssertionError(f'mesh step {step} apart from the single-card step: {gap}')
        held = {k: max(v, gap[k]) for k, v in held.items()}
    kinds = {}
    for op, axis, dtype, n in log_rows:
        calls, total = kinds.get(f'{op}/{axis}/{dtype}', (0, 0))
        kinds[f'{op}/{axis}/{dtype}'] = [calls + 1, total + n]
    return {**held, 'collectives': kinds, 'step_ms': step_ms}


def phase_mesh_training(ml10m, smi: str) -> dict:
    """Phase 14: the parallel tier's training half at the ML-10M-scale
    configuration on ``make_mesh(data=1, model=1)`` over NCCL (world size 1,
    a ``file://`` rendezvous in a temporary directory).  (a) the whole fit
    through the mesh against the single-card generic fit
    (``COLLIE_TPU_FUSED_EPOCH=0``, the same seed): epochs, learning-rate
    changes and best epoch equal, train losses within
    ``WHOLE_FIT_LOSS_RTOL``, params as phase 10 holds generic epochs
    (``MESH_TRAIN`` comment), examples/s both ways, one cycle-walk launch a
    training epoch and no epoch kernel; (b) a per-epoch mesh fit with a
    ``checkpoint_dir`` to epoch ``MESH_TRAIN_RESUME_FROM`` (``.shards``
    directories), resumed to ``MESH_TRAIN_EPOCHS`` on the mesh and on a
    single-device trainer, each held to (a)'s fit; (c) the model as (a)'s
    fit left it, holding its shards, serves ``MESH_TRAIN_REQUESTS``
    kernel-path ``recommend(mesh=)`` requests (one top-k launch each, ids
    equal to the single-card calls) and ``evaluate_in_batches(mesh=)``
    (within rtol 1e-5 of the single-card values); (d) the elements each
    collective of one mesh step moves (at world size 1 the calls' pattern,
    not the bytes).  Returns the launches of the top-k kernel, the
    cycle-walk and the bucketed sampler kernel on the paths driven here."""
    import torch.distributed as dist

    from collie_tpu_torch import CollieTrainer, auc, evaluate_in_batches, mapk, mrr
    from collie_tpu_torch.parallel import make_mesh
    from collie_tpu_torch.retrieval import recommend
    from collie_tpu_torch.training import scan_engine

    train, _, test = ml10m
    sub = ml10m_eval_users(test)
    build = lambda: ml10m_model(train)              # noqa: E731
    out = {'mf_topk_retrieve': 0, SHUFFLE_WRAPPER: 0, 'stable_topk': 0, SAMPLER_WRAPPER: 0}
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        dist.init_process_group('nccl', init_method=f'file://{directory}/rendezvous',
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(data=1, model=1)
            # a one-epoch mesh fit first sets up the NCCL communicators and
            # the allocator's pools, so (a) times the fit, not the setup
            warm = build()
            CollieTrainer(warm, max_epochs=1, verbosity=0, seed=7, mesh=mesh,
                          enable_model_summary=False).fit(warm)
            del warm
            # (a) the whole fit through the mesh, the counts zeroed just before
            reset_launch_counts()
            meshed = record_fit(build, True, 'mesh', smi, epochs=MESH_TRAIN_EPOCHS, seed=7,
                                mesh=mesh)
            launches = _kernel_counts()
            expected = dict.fromkeys(launches, 0)
            expected[SHUFFLE_WRAPPER] = expected[SAMPLER_WRAPPER] = meshed['epochs']
            if launches != expected:
                raise AssertionError(f'mesh fit launches {launches}, expected {expected}')
            out[SHUFFLE_WRAPPER] += launches[SHUFFLE_WRAPPER]
            out[SAMPLER_WRAPPER] += launches[SAMPLER_WRAPPER]
            os.environ['COLLIE_TPU_FUSED_EPOCH'] = '0'
            try:
                single = record_fit(build, True, 'single card, generic', smi,
                                    epochs=MESH_TRAIN_EPOCHS, seed=7)
            finally:
                del os.environ['COLLIE_TPU_FUSED_EPOCH']
            model = meshed['model']
            layout = model.param_layout()
            if layout is None or layout[0] is not mesh:
                raise AssertionError('the mesh fit left the model without its layout')
            ref = single['model'].params
            gap = _params_gap(model.params, ref)
            a, b = np.asarray(meshed['losses']), np.asarray(single['losses'])
            parted = float(np.max(np.abs(a - b) / np.abs(b)))
            equal = {'epochs': meshed['epochs'] == single['epochs'],
                     'lr changes': meshed['changes'] == single['changes'],
                     'best epoch': meshed['best_epoch'] == single['best_epoch']}
            log(f'mesh_training (a) ML-10M whole fit on make_mesh(1, 1) (nccl): '
                f'{meshed["epochs"]} epochs, lr changes {meshed["changes"]}, best epoch '
                f'{meshed["best_epoch"]}; train losses {[round(float(x), 6) for x in a]} within '
                f'{parted:.3g} of the single-card generic fit\'s (rtol {WHOLE_FIT_LOSS_RTOL}); '
                f'largest param difference {gap:.3g} of max|ref|; examples/s mesh '
                f'{meshed["examples_per_s"]:,.0f}, single card {single["examples_per_s"]:,.0f} '
                f'({smi}); epoch s mesh {[round(e["seconds"], 4) for e in meshed["epoch_log"]]}, '
                f'single card {[round(e["seconds"], 4) for e in single["epoch_log"]]}; '
                f'cycle-walk launches {launches[SHUFFLE_WRAPPER]}')
            if not all(equal.values()) or parted > WHOLE_FIT_LOSS_RTOL:
                raise AssertionError(f'mesh fit vs single card: {equal}, losses parted '
                                     f'{parted}')

            # (b) checkpoints of the mesh fit, resumed on the mesh and on one card
            ckpt_dir = os.path.join(directory, 'checkpoints')
            before = _kernel_counts()
            first = build()
            CollieTrainer(first, max_epochs=MESH_TRAIN_RESUME_FROM, verbosity=0, seed=7,
                          mesh=mesh, checkpoint_dir=ckpt_dir,
                          enable_model_summary=False).fit(first)
            shards = os.path.join(ckpt_dir, f'checkpoint_epoch_{MESH_TRAIN_RESUME_FROM}.shards')
            written = sorted(os.listdir(shards))
            gaps, resumed_losses = {}, {}
            for label, resume_mesh in (('mesh', mesh), ('one card', None)):
                resumed, losses = build(), _LossLog()
                trainer = CollieTrainer(resumed, max_epochs=MESH_TRAIN_EPOCHS, verbosity=0,
                                        seed=7, mesh=resume_mesh, enable_model_summary=False,
                                        logger=losses)
                if trainer.resume_from_checkpoint(shards) != MESH_TRAIN_RESUME_FROM:
                    raise AssertionError(f'{shards}: wrong epoch')
                os.environ['COLLIE_TPU_FUSED_EPOCH'] = '0'     # the one card's generic epoch
                try:
                    trainer.fit(resumed)
                finally:
                    del os.environ['COLLIE_TPU_FUSED_EPOCH']
                gaps[label] = _params_gap(resumed.whole_params(), ref)
                resumed_losses[label] = [float(x) for x in losses.losses]
            torch.cuda.synchronize()
            launches = _count_delta(before)
            expected = dict.fromkeys(launches, 0)
            expected[SHUFFLE_WRAPPER] = expected[SAMPLER_WRAPPER] = (
                MESH_TRAIN_RESUME_FROM + 2 * (MESH_TRAIN_EPOCHS - MESH_TRAIN_RESUME_FROM))
            if launches != expected:
                raise AssertionError(f'checkpointed fits launched {launches}, expected {expected}')
            tail = [float(x) for x in meshed['losses'][MESH_TRAIN_RESUME_FROM:]]
            resumed_gap = max(abs(r - t) / abs(t) for losses in resumed_losses.values()
                              for r, t in zip(losses, tail))
            log(f'mesh_training (b) per-epoch mesh fit to epoch {MESH_TRAIN_RESUME_FROM} '
                f'wrote {os.path.basename(shards)} ({written}); resumed to epoch '
                f'{MESH_TRAIN_EPOCHS} on the mesh and on one card: train losses '
                f'{resumed_losses} within {resumed_gap:.3g} of (a)\'s uninterrupted {tail} '
                f'(rtol {WHOLE_FIT_LOSS_RTOL}); largest param difference {gaps["mesh"]:.3g} / '
                f'{gaps["one card"]:.3g} of max|ref|')
            if any(len(losses) != len(tail) for losses in resumed_losses.values()) \
                    or resumed_gap > WHOLE_FIT_LOSS_RTOL:
                raise AssertionError(f'resumed fits apart from the uninterrupted: '
                                     f'{resumed_losses} vs {tail}')
            out[SHUFFLE_WRAPPER] += launches[SHUFFLE_WRAPPER]
            out[SAMPLER_WRAPPER] += launches[SAMPLER_WRAPPER]

            # (c) the model as the fit left it serves through the mesh
            rng = np.random.default_rng(MESH_SEED)
            requests = [rng.choice(train.num_users, REQUEST_USERS, replace=False)
                        for _ in range(MESH_TRAIN_REQUESTS)]
            reset_launch_counts()
            answers, mesh_ms = [], []
            for users in requests:
                t0 = time.perf_counter()
                answers.append(recommend(model, users, k=K, filter_seen=False, mesh=mesh))
                torch.cuda.synchronize()
                mesh_ms.append((time.perf_counter() - t0) * 1e3)
            launches = _kernel_counts()
            expected = dict.fromkeys(launches, 0)
            expected['mf_topk_retrieve'] = MESH_TRAIN_REQUESTS
            expected['stable_topk'] = MESH_TRAIN_REQUESTS * recommend_selections(
                model, REQUEST_USERS, False, shards=1)
            if launches != expected:
                raise AssertionError(f'mesh recommend launches {launches}, expected {expected}')
            out['mf_topk_retrieve'] += launches['mf_topk_retrieve']
            out['stable_topk'] += launches['stable_topk']
            mesh_metrics = evaluate_in_batches([mapk, mrr, auc], sub, model, k=K, mesh=mesh,
                                               verbose=False)
            if model.param_layout() is None:
                raise AssertionError('serving re-laid the model out')
            worst = 0.0
            for users, (ids, scores) in zip(requests, answers):
                ref_ids, ref_scores = recommend(model, users, k=K, filter_seen=False)
                if not np.array_equal(ids, ref_ids):
                    raise AssertionError(f'mesh recommend of the trained model: ids differ in '
                                         f'{int((ids != ref_ids).any(axis=1).sum())} rows')
                worst = max(worst, float(np.abs(scores - ref_scores).max()))
            single_metrics = evaluate_in_batches([mapk, mrr, auc], sub, model, k=K,
                                                 verbose=False)
            if not np.allclose(mesh_metrics, single_metrics, rtol=1e-5, atol=1e-7):
                raise AssertionError(f'mesh evaluate {mesh_metrics} vs {single_metrics}')
            log(f'mesh_training (c) the trained model, holding its shards: {MESH_TRAIN_REQUESTS} '
                f'recommend(mesh=) requests of {REQUEST_USERS} users, k={K}, ids equal the '
                f'single-card calls (max_abs_err={worst:.3g}), ms {[round(t, 3) for t in mesh_ms]}, '
                f'topk_tile launches {launches["mf_topk_retrieve"]}, selections '
                f'{launches["stable_topk"]}; evaluate_in_batches(mesh=) '
                f'MAP@{K}, MRR, AUC {mesh_metrics} (single card {single_metrics})')

            # (d) mesh steps held to single-card steps, the first one's
            # collectives recorded
            held = hold_mesh_steps(model, mesh, MESH_TRAIN_EPOCHS + 1)
            log(f'mesh_training (d) {MESH_TRAIN_HELD_STEPS} mesh steps of the trained model '
                f'held to the single-card steps from its state: losses within '
                f'{held["loss"]:.3g} (rtol {GENERIC_SPARSE_RTOL}), table elements beyond '
                f'{GENERIC_GRAD_SCALE} of the update {held["share"]:.3g} (at most '
                f'{MAX_FLIPPED_FRACTION}), largest difference {held["max"]:.3g} of the update')
            log(f'mesh_training (d) one mesh step (B={ML10M_BATCH}, fused tables): collectives '
                + '; '.join(f'{kind}: {calls} calls, {total:,} elements'
                            for kind, (calls, total) in sorted(held['collectives'].items())))
        finally:
            dist.destroy_process_group()
    log(f'mesh_training phase: {time.perf_counter() - start:.1f}s')
    torch.cuda.empty_cache()
    return out


def _movielens_frames():
    """The synthetic ML-100K stand-ins as the readers return them (1-based)."""
    from collie_tpu_torch.movielens import get_data

    return (get_data._synthetic_movielens_df(decrement_ids=False),
            get_data._synthetic_movielens_df_item(), get_data._synthetic_movielens_df_user())


def _check_read_back(frames) -> None:
    """The readers' frames equal the frames written (``zip`` as text:
    ``read_csv`` parses all-digit zips as integers)."""
    import pandas as pd

    from collie_tpu_torch.movielens import (read_movielens_df, read_movielens_df_item,
                                            read_movielens_df_user)

    df, df_item, df_user = frames
    pd.testing.assert_frame_equal(read_movielens_df(decrement_ids=False), df)
    pd.testing.assert_frame_equal(read_movielens_df_item(), df_item)
    users = read_movielens_df_user()
    pd.testing.assert_frame_equal(users.drop(columns='zip'), df_user.drop(columns='zip'))
    if users['zip'].astype(str).tolist() != df_user['zip'].tolist():
        raise AssertionError('u.user zip codes differ from the frame written')


def _check_trace(directory) -> dict:
    """The trace ``profiler.trace`` wrote: its CUDA kernels and whether it
    names the annotated region."""
    files = sorted(Path(directory).glob('trace_*.json'))
    if len(files) != 1:
        raise AssertionError(f'trace wrote {len(files)} files')
    events = json.loads(files[0].read_text())['traceEvents']
    kernels = {e['name'] for e in events if e.get('cat') == 'kernel'}
    if not kernels:
        raise AssertionError('the trace names no CUDA kernel')
    if not any(e.get('name') == MOVIELENS_REGION for e in events):
        raise AssertionError(f'the trace does not name {MOVIELENS_REGION!r}')
    return {'events': len(events), 'kernels': len(kernels)}


def phase_movielens(smi: str) -> dict:
    """Phase 12: ``run_movielens_example()`` at its defaults on the card,
    over ML-100K-format files of the synthetic stand-ins in a temporary
    ``DATA_PATH`` (the download replaced by one that raises), with an
    ``EpochTimer`` as the fit's logger; then the visualizations, a traced
    epoch and the memory statistics.  Returns the launch counts of the
    example's run."""
    import pandas as pd

    import collie_tpu_torch.movielens.get_data as get_data
    import collie_tpu_torch.movielens.run as run_module
    from collie_tpu_torch import MatrixFactorizationModel
    from collie_tpu_torch.movielens import get_recommendation_visualizations
    from collie_tpu_torch.training import profiler

    def offline():
        raise OSError('chip_smoke: no download')

    frames = _movielens_frames()
    timer = profiler.EpochTimer()
    fitted = {}

    class Trainer(run_module.CollieTrainer):
        """The example's trainer, with the timer as its logger."""

        def __init__(self, model, **kwargs):
            super().__init__(model=model, logger=timer, **kwargs)
            fitted['model'], fitted['trainer'] = model, self

    saved = (get_data.DATA_PATH, get_data._download_movielens_100k, run_module.DATA_PATH,
             run_module.CollieTrainer)
    with tempfile.TemporaryDirectory() as directory:
        data_path = Path(directory)
        get_data._write_movielens_100k(data_path, *frames)
        get_data.DATA_PATH = run_module.DATA_PATH = data_path
        get_data._download_movielens_100k = offline
        run_module.CollieTrainer = Trainer
        try:
            _check_read_back(frames)
            out = io.StringIO()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                run_module.run_movielens_example()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {w.__name__: w.launches for w in kernel_wrappers()}
            model = fitted['model']
            reloaded = MatrixFactorizationModel(
                load_model_path=data_path / 'fitted_model' / 'model.npz')
        finally:
            (get_data.DATA_PATH, get_data._download_movielens_100k, run_module.DATA_PATH,
             run_module.CollieTrainer) = saved
        printed = out.getvalue()
        metrics = {}
        for line in printed.splitlines():
            for name, key in (('AUC:', 'auc'), ('MRR:', 'mrr'), ('MAP@10:', 'mapk')):
                if line.startswith(name):
                    metrics[key] = float(line.split()[-1])
        losses = timer.epoch_losses
        if model.device.type != DEVICE or reloaded.device != model.device:
            raise AssertionError(f'the example trained on {model.device}')
        if not losses or not np.isfinite(losses).all() or losses[-1] >= losses[0]:
            raise AssertionError(f'the train loss did not fall: {losses}')
        if set(metrics) != {'auc', 'mrr', 'mapk'} or not metrics['auc'] > 0.5:
            raise AssertionError(f'example metrics {metrics}: test AUC must exceed 0.5')
        for name, value in model.params.items():
            if not torch.equal(value, reloaded.params[name]):
                raise AssertionError(f'the saved npz does not reload {name}')
        # every epoch the whole fit dispatched shuffles its training batches
        # and draws them and the validation batches through the sampler kernel
        if launches[SHUFFLE_WRAPPER] < 1 or launches[SAMPLER_WRAPPER] != 2 * launches[
                SHUFFLE_WRAPPER] or any(n for name, n in launches.items()
                                        if name not in (SHUFFLE_WRAPPER, SAMPLER_WRAPPER)):
            raise AssertionError(f'the example launched {launches}: the generic epoch must '
                                 'shuffle through the cycle-walk, draw its training and '
                                 'validation epochs through the sampler kernel and launch no '
                                 'other kernel')
        log(f'movielens (a) run_movielens_example() on {model.device}: '
            f'{len(losses)} epochs in {seconds:.2f}s, train loss {losses[0]:.5f} -> '
            f'{losses[-1]:.5f}, AUC {metrics["auc"]:.6f} MRR {metrics["mrr"]:.6f} '
            f'MAP@10 {metrics["mapk"]:.6f} (collie_tpu on the CPU, same files, '
            f'tools/movielens_jax_reference.py: {JAX_ML100K_CPU}); launches {launches}; '
            f'npz reloads; {smi}')
        log(f'movielens (b) EpochTimer summary {timer.summary()}')

        posters = pd.DataFrame({'item_id': np.arange(1, 1683),
                                'url': [f'http://example.com/{i}.jpg' for i in range(1, 1683)]})
        cpu_model = MatrixFactorizationModel(train=model.train_loader, val=model.val_loader,
                                             embedding_dim=10, map_location='cpu', seed=0)
        cpu_model.load_params({k: v.cpu() for k, v in model.params.items()})
        for user_id in MOVIELENS_VIS_USERS:
            kwargs = dict(user_id=user_id, df_user=frames[0], df_item=frames[1],
                          movielens_posters_df=posters, detailed=True, shuffle=False)
            html = get_recommendation_visualizations(model, **kwargs)
            if html != get_recommendation_visualizations(cpu_model, **kwargs):
                raise AssertionError(f'user {user_id}: the card\'s HTML differs from the CPU\'s')
        log(f'movielens (c) get_recommendation_visualizations for users {MOVIELENS_VIS_USERS}: '
            f'card HTML equals the CPU copy\'s ({len(html)} characters for the last)')

        trace_dir = data_path / 'trace'
        fresh = MatrixFactorizationModel(train=model.train_loader, val=model.val_loader,
                                         dropout_p=0.05, loss='adaptive', lr=5e-2,
                                         embedding_dim=10, weight_decay=1e-7, seed=0)
        trainer = run_module.CollieTrainer(model=fresh, max_epochs=1, verbosity=0)
        torch.cuda.reset_peak_memory_stats()
        with profiler.trace(str(trace_dir)):
            with profiler.annotate(MOVIELENS_REGION):
                trainer.fit(fresh)
        traced = _check_trace(trace_dir)
        stats = profiler.device_memory_stats()
        if not isinstance(stats, dict) or not stats.get('allocated_bytes.all.peak', 0) > 0:
            raise AssertionError('device_memory_stats() has no peak allocation')
        log(f'movielens (d) trace of one epoch: {traced["events"]} events, '
            f'{traced["kernels"]} distinct CUDA kernels, {MOVIELENS_REGION!r} named; '
            f'device_memory_stats peak allocated {stats["allocated_bytes.all.peak"]} bytes')
    torch.cuda.empty_cache()
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--epoch-times', action='store_true',
                        help='only build the kernels and time one epoch call of each fused '
                             'epoch kernel at the gate and ML-10M-scale configurations (runs '
                             'against the collie_tpu_torch beside this script, so a copy of '
                             'the script in another checkout times that checkout)')
    parser.add_argument('--kernel-times', action='store_true',
                        help='only build the kernels and time the top-k kernel (k = 1, 10, '
                             '128; launch alone and the whole call), the binned '
                             'gather/scatter and the selection at their main shapes (a copy '
                             'of the script in another checkout times that checkout)')
    parser.add_argument('--generic-times', action='store_true',
                        help='only build the kernels and run phase 10, the generic epoch at '
                             'the ML-10M and zoo scales (a copy of the script in another '
                             'checkout times that checkout)')
    args = parser.parse_args(argv)
    t0 = time.perf_counter()

    smi = phase_device()
    phase_build()
    if args.kernel_times:
        times = kernel_times()
        log(f'total_seconds={time.perf_counter() - t0:.1f}')
        print(json.dumps({'kernel_times': times}))
        print(smi)
        return
    if args.epoch_times:
        times = epoch_times(ml10m_data())
        log(f'total_seconds={time.perf_counter() - t0:.1f}')
        print(json.dumps({'epoch_times': times}))
        print(smi)
        return
    if args.generic_times:
        phase_generic_epoch(ml10m_data()['implicit'], zoo_data(), smi)
        log(f'total_seconds={time.perf_counter() - t0:.1f}')
        print(smi)
        return
    topk = phase_kernels()
    select = phase_select()
    gather_scatter = phase_gather_scatter()
    ml10m = ml10m_data()
    fused = phase_kernel_fused_epoch(ml10m['implicit'])
    explicit = phase_kernel_explicit_epoch(ml10m['explicit'])
    serving = phase_serving(args.seed, topk, select)
    phase_mesh(serving, topk, select)
    del serving
    ml10m_fit = phase_training(ml10m['implicit'], fused)
    phase_explicit_training(ml10m['explicit'], explicit)
    trainer = phase_trainer(ml10m['implicit'], smi, ml10m_fit)
    fused['launches'] += trainer['launches']['fused_mf_epoch']
    explicit['launches'] += trainer['launches']['fused_mf_explicit_epoch']
    sampler = trainer['samplers']['kernel']
    sampler['launches'] = ml10m_fit['sampler_launches'] + trainer['launches'][SAMPLER_WRAPPER]
    zoo = zoo_data()
    zoo_fits = phase_zoo(smi, zoo)
    select['launches'] += zoo_fits['selections']
    sampler['launches'] += zoo_fits['sampler_launches']
    multi_stage = phase_multi_stage(smi, zoo)
    select['launches'] += multi_stage['selections']
    sampler['launches'] += multi_stage['sampler_launches']
    fused['max_abs_err'] = max(fused['max_abs_err'], multi_stage['donor']['max_abs_err'])
    shuffle = phase_whole_fit(ml10m['implicit'], smi)
    sampler['launches'] += shuffle.pop('sampler_launches')
    shuffle['launches'] += fused['shuffle_launches'] + explicit['shuffle_launches']
    generic = phase_generic_epoch(ml10m['implicit'], zoo, smi)
    shuffle['launches'] += generic[SHUFFLE_WRAPPER]
    sampler['launches'] += generic[SAMPLER_WRAPPER]
    out_of_core = phase_out_of_core(smi)
    shuffle['launches'] += out_of_core['shuffle']
    fused['launches'] += out_of_core['fused']
    sampler['launches'] += out_of_core['sampled']
    movielens = phase_movielens(smi)
    shuffle['launches'] += movielens[SHUFFLE_WRAPPER]
    sampler['launches'] += movielens[SAMPLER_WRAPPER]
    mesh_training = phase_mesh_training(ml10m['implicit'], smi)
    topk['launches'] += mesh_training['mf_topk_retrieve']
    select['launches'] += mesh_training['stable_topk']
    shuffle['launches'] += mesh_training[SHUFFLE_WRAPPER]
    sampler['launches'] += mesh_training[SAMPLER_WRAPPER]

    log(f'total_seconds={time.perf_counter() - t0:.1f}')
    print(json.dumps({'kernels': [topk, fused, explicit, gather_scatter, shuffle, select,
                                  sampler]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
