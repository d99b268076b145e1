#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``synapseml_tpu_torch``) once on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which ends the run with a non-zero exit when it fails:

1. print the card's name and power limit, build every hand kernel from
   ``synapseml_tpu_torch/csrc`` with ``nvcc`` (all sources at once);
2. main path: ``LightGBMClassifier(num_iterations=10, num_leaves=31,
   max_bin=63)`` fit on 4,194,304 x 28 synthetic HIGGS-width rows, then
   transform on 1,048,576 held-out rows; the launch counts of the histogram
   and tree-scoring kernels must be > 0, the held-out AUC > 0.9, and a small
   fit on the card must grow the same trees as the plain CPU path; binning
   (kernel D) must launch in the fit, the split search (kernel E), the row
   partition (kernel P), kernel A's row-list entry and the step's epilogue
   (the sibling by subtraction) once a split step (300 launches; E also in
   2b, 300, and 2c, 2,100) and kernel A's full entry once a tree (the root
   histogram);
2b. ``gbdt_adult_cat``: rows at the UCI Adult Census schema (6 numeric and 8
   categorical columns with Adult's cardinalities, NaN where the files hold
   '?', codes unseen in training among the held-out rows), 4,194,304
   training and 1,048,576 held-out rows, ``categorical_slot_indexes``,
   255 bins, 31 leaves, 10 iterations; held-out AUC > ADULT_AUC_FLOOR, the
   trees must hold categorical splits, kernels D and E must launch, and a
   small fit must grow the same trees (``cat_set`` included) on the card
   and the CPU;
2c. ``gbdt_covertype_multiclass``: rows at the UCI Covertype schema (10
   numeric columns, Wilderness_Area and Soil_Type as two categorical
   columns), 581,012 rows split 80/20, 7 classes, 255 bins, 31 leaves, 10
   iterations (70 trees); held-out accuracy > COVTYPE_ACC_FLOOR, kernel B
   scores C=7 with categorical splits, and a small fit must grow the same
   trees on the card and the CPU;
2d. training controls through ``LightGBMClassifier`` at the main path's
   rows and parameters (``schema_data.SAMPLED_MODES``): (a) bagging (0.5,
   every iteration) with feature fraction 0.8, the held-out rows passed as
   validation rows (``validation_indicator_col``) and watched by AUC with
   early stopping after 3 rounds; (b) GOSS at its defaults; (c) DART with
   ``skip_drop=0, drop_rate=0.3``; (d) rf with bagging 0.7. Each fit must
   launch kernels A, D and E (E once a split step; D also on (a)'s eval
   rows) and each transform kernel B, the held-out AUC must pass 0.9, and
   (a)'s eval AUC of every iteration must equal the numpy AUC of the model
   cut there within 1e-4. Then the plain torch work the controls add is
   timed (a threefry draw and a GOSS cut over the training rows, a device
   AUC and an eval routing pass over the held-out rows, a DART replay over
   the training rows), the draw must be bit-equal on the card and the CPU,
   and a small fit of each mode must give identical trees, tree scales and
   bags on the card and the CPU;
2e. ``LightGBMRanker`` at MSLR-WEB30K Fold1's shape (``schema_data.mslr_rows``:
   136 features, 18,919 training queries and 2,270,296 documents, the
   6,306 validation queries' 747,218 documents as validation rows watched
   by NDCG@10 with early stopping) at LightGBM's lambdarank example settings
   (``FITS["mslr"]``), then transform of the validation rows: kernel F once
   an iteration, A, D, E and B launched, held-out NDCG@10 at least 0.1 over
   a random order's on the same queries, every iteration's eval NDCG equal
   to the NDCG of the model cut there (margins summed as the eval path
   sums them, from kernel B's leaf ids), and a ranker fit at ~16,384
   rows giving the same trees, leaves and NDCG series on the card and the
   CPU; then the model surface: ``features_shap_col`` on 65,536 held-out
   rows of phase 2's HIGGS and phase 2b's Adult models (each row's
   contributions add up to kernel B's margin within SHAP_TOL), a model
   written by ``save_native_model`` and read by ``load_native_model``
   scoring bit-equal on the card and the CPU (and within SHAP_TOL of the
   model it came from), and the hand-written LightGBM texts
   (zero_as_missing, default_left, ...) scoring on the card as on the CPU;
2f. growth over the row partition against the full pass it replaced
   (``kernel_cases.grow_full_pass``): ``train`` at phase 2's rows and
   parameters both ways: identical trees and bit-equal held-out margins,
   kernel P (the row partition), kernel A's row-list entry and the epilogue
   once a split step (A's full entry once a tree, the root), and each path's
   kernel A launches, device ms a fit of A, P and the epilogue, launches a
   split step and device busy ms (traced fits in turns full pass, shipped,
   shipped, full pass) and rows histogrammed a fit; then a continued-training
   fit (``init_booster``, with an eval set) and ``num_batches=2`` fits of the
   classifier and the regressor at 16,384 rows, each giving the same trees on
   the card and the CPU;
2g. ``gbdt_hashed_text``: sparse (CSR) input, hashed text at Amazon Review
   Polarity's schema (``schema_data.hashed_text_rows``: reviews of about 80
   Zipf tokens hashed into VW's 2^18 slots, counts as values, a lexicon
   label), ``LightGBMClassifier`` (``FITS["hashed_text"]``: 10 iterations, 31
   leaves, max_bin 255) fit on 1,048,576 reviews given as a column of
   ``(indices, values)`` pairs, then transform of 262,144 held out: kernel G
   once at each tree's root and once a split step, E's full entry as often
   (hard checks), B in the transform, held-out AUC > HASHED_AUC_FLOOR; CSR
   ``raw_predict`` bit-equal to the dense predict over the densified
   used-feature columns (kernel D binning them); each row's contributions
   on HASHED_SHAP_ROWS (32,768) held-out rows within SHAP_TOL of its
   margin; the full-pass
   oracle's fit at the same rows (``kernel_cases.grow_sparse_full_pass``:
   both children summed every step) giving the same trees as the shipped
   half pass; a 16,384-row fit at 2^14 slots giving the same trees on the
   card and the CPU; then, after phase 4 (whole-fit traces are the
   script's largest, so they come last), a traced fit of each path: G's
   and E's device ms a fit and a call, G's device kernels a call (each of
   its 4 once, a hard check) and each one's ms a fit, and the launches a
   split step;
2h. ``GBDTDataset`` and the pipeline-stage library: (i) a device-resident
   dataset built from phase 2's 4,194,304 training rows as a card tensor
   (kernel D exactly once in the construction; D's ms there), then two
   ``train`` calls over it (phase 2's parameters, then ``num_leaves=15,
   learning_rate=0.05``): D 0 times in each, E, P and A's row-list entry
   once a split step, and the first fit's trees identical to
   ``train(params, x, y)`` from the raw matrix; (ii) a continued fit
   (``init_booster=`` the first fit, 5 more iterations) over the dataset
   (D 0 times), identical to the continuation from the raw matrix; (iii) a
   CSR dataset at phase 2g's small case (16,384 reviews at 2^14 slots):
   two fits build its ``SparseBinned`` once, and each fit's trees are
   identical on the card, on the CPU and to ``train(params, csr)``; (iv)
   ``TrainClassifier(model=LightGBMClassifier(num_iterations=10,
   num_leaves=31))`` on 1,048,576 Adult-schema rows with the 8 categorical
   columns as strings (``schema_data.adult_columns``), transform of 262,144
   held out and ``ComputeModelStatistics``: AUC > ADULT_AUC_FLOOR and equal
   to the script's numpy AUC within 1e-6, D and E in the fit, D and B in
   the transform, Featurize's host time beside the fit's and the
   transform's, and a 16,384-row ``TrainClassifier`` fit giving identical
   trees on the card and the CPU;
2i. the mesh (``train(..., mesh=)``, ``runtime/layout.py``): (a)
   ``LightGBMClassifier(mesh=SpecLayout.build(data=1))`` in a one-rank NCCL
   group (a ``HashStore``) at phase 2's rows and parameters: phase 2's trees,
   kernel P's mesh entry and its pick once a split step (the one-launch
   step never), one all-reduce of the counts and one of the child a step,
   its fit time beside phase 2's; (b) two processes on ``cuda:0`` in one
   gloo world (NCCL puts no two ranks on one card; gloo's all-reduce takes
   the CUDA tensors), the run that drives the global smaller-side choice:
   1,048,576 HIGGS-width rows at data=2 and at a (1, 2) feature-parallel
   layout, 65,536 hashed reviews at 2^14 slots (kernel G's mesh use once a
   split step), a 12,288-document MSLR-schema ranker at data=2, each with
   the trees of the single-device fit of the same rows, and voting at
   HIGGS width (top_k 5, the AUC floor only); every rank's trees equal to
   rank 0's; (c) P's mesh entry and pick at phase 4's P splits and G's mesh
   use at phase 2g's half splits, bit-equal to their plain twins and timed
   (their rows of the kernels line);
2j. the VW learner (``vw/``, kernel V): (a) ``VowpalWabbitClassifier(
   num_bits=18, batch_size=256, num_passes=2)`` fit on phase 2g's
   1,048,576 training reviews as a sparse (indices, values) column, then
   transform of its 262,144 held-out reviews: kernel V once a pass (2
   launches, each a persistent kernel over the pass's 4,096 batches) and no
   other kernel, none in the transform (it scores on the host), held-out
   AUC > VW_AUC_FLOOR; the fit's and transform's wall seconds and
   ``pad_examples``' share of the fit; a 16,384-review fit (logistic;
   squared with l2) with identical states on the card and the CPU; (b)
   kernel V against its plain version over the first 64 batches, each loss,
   the sparse regime and l1 + l2, the pass launched whole (one launch, as
   the fit launches it) and batch by batch (one launch a batch): both
   bit-equal to the plain steps, each timed (a pass, the plain steps of a
   pass) beside its bound (the batches' idx/val/y/weight, and once the
   union over the batches of the 32-byte sectors of w, s and g2 read and
   written; in a dense regime w and g2 whole), a trace of four passes
   giving the device time a batch and the host's clock the time to submit
   a pass; (c) at 65,536 reviews a one-rank NCCL
   ``SpecLayout.build(data=1)`` fit equal to the single-device fit, and two
   gloo ranks on ``cuda:0``: at data=2 rank 1's state equal to rank 0's, at
   (data=1, fsdp=2) the replicated (data=1, model=2) state bit for bit, with
   the collectives counted (one sum and one max a pass, one all-gather over
   fsdp a pass) and at most half the vectors at rest;
2k. the ONNX executor (``onnx/``, kernels Q and R), each run through the
   user's entry point after a first call that builds its plan, with the
   launch counts set to 0 just before it and read after: (a) the zoo's
   ResNet-50 through ``ONNXModel(batch_size=128)`` over 1,024 seeded
   224 x 224 images under the f32 and the bf16 policy (no Q or R launch;
   features (1024, 2048)); (b) BERT-base (12 layers, hidden 768) in bf16
   over 512 sequences of 128 tokens at batch 64; (c) ``quantize_dynamic_graph``
   of BERT-base over the same sequences (Q's matmul entry once for each of
   the 74 rewritten MatMuls a batch) and of ResNet-50 over 256 images (Q's
   conv entry and its channels-last copy 53 times a batch), each with a
   trace of one batch that names Q's wgmma kernels; (d) LSTM (peepholes)
   and GRU (linear_before_reset=0) graphs and the configurations cuDNN
   computes (LSTM without peepholes, GRU with linear_before_reset=1) at
   GNMT's width (S=128, B=64, I=H=1,024) in f32 and bf16, kernel R's
   persistent entry once a call, and an LSTM at RNN_STEPWISE (H=2,048) on
   its one-launch-a-step entry; each
   with its wall seconds and rows a second, and its first rows held to the
   port's CPU run (f32 within 1e-4 of each output's max-abs; bf16 and the
   quantized graphs within 2e-2 of each row's norm; a quantized graph's
   rows as one batch on both devices, since DynamicQuantizeLinear's range
   spans its batch);
2l. sequence-parallel attention, tensor-parallel ONNX serving and the
   topology module: (a) kernel C's log-sum-exp entries (``return_lse``) at
   the headline shape in bf16 and at B=1, S=8192, H=8, D=128 in f32, the
   lse within LSE_TOL of the plain version's and the output bit-equal to
   the entry without lse, timed beside it and beside the library's
   attention that also returns a log-sum-exp; (b) ``sequence_sharded_attention``
   at data=1 in a one-rank NCCL group, bf16 at the headline shape and f32 at
   the lse shape (ring: one lse launch each, the output bit-equal to
   ``flash_attention``'s; the lse entries' launch counts set to 0 just
   before and read after), then ring and Ulysses (``local="flash"``) over
   two gloo ranks on ``cuda:0`` (NCCL puts no two ranks on one card), each
   holding half the sequence, at the headline shape causal and not and at
   the grouped-query serving shape causal: every rank's block within 5e-2
   and FLASH_ROW_TOL (row norms) of ``flash_attention`` over the whole
   sequence, kernel C's lse entry launched n times a rank (causal: rank r,
   r + 1 times), the transport and the merge's time printed (two ranks
   share one card: no speed claim); (c) the zoo's BERT-base f32 over 8 x
   128 tokens on two gloo ranks on ``cuda:0`` under ``SpecLayout.build(
   data=1, model=2)`` and ``(data=1, fsdp=2)``: outputs within
   ONNX_F32_TOL of the one-device run on the card, each rank's at-rest
   weight bytes exactly the replicated tensors plus half the planned ones,
   the collectives counted by kind; (d) ``cluster_info()`` and
   ``require_backend("gpu")`` on the card, and a 3-D ``ConvInteger`` (a C3D
   block) through kernel Q, one 2-D launch a depth tap, bit-equal to
   ``qconv_plain``;
2m. images, DL featurization, the explainers and the isolation forest:
   (b) first, kernel L (the lasso's coordinate descent,
   ``csrc/lasso_cd.cu``) against its plain version on the card at LIME's
   shapes (1,000 samples, k = 32, k = 200 and one k past the limit of its
   Gram matrix in shared memory (``lasso_smem_k() + 1``), 256 instances x
   2 targets, alpha 0.01, 100 sweeps: within LASSO_TOL of max(1,
   max|beta|), the same zero coefficients but at a tie of |rho| with lam,
   bit-equal to its order model ``lasso_cd_order``), L, the plain version
   and the least-squares SVD path timed; then, with every launch count set
   to 0 just before and read just after, the main path: (a) 256 seeded
   uint8 BGR images of ragged sizes (240-480 px a side) through
   ``ImageTransformer`` (shorter side 256, center crop 224, Gaussian blur
   5, flip), then ``ImageFeaturizer`` over
   the zoo's ResNet-50 fetched by ``ModelDownloader(ZooRepository)`` into a
   temporary directory, headless, f32 and bf16 at batch 64, images/s, the
   first 8 images' features held to the port's CPU run within phase 2k's
   tolerances; (c) a ``LightGBMClassifier`` (20 iterations, 31 leaves, the
   8 categorical columns) fitted on 65,536 Adult-schema rows behind a
   ``PipelineModel`` (codes cast, ``FastVectorAssembler``), explained by
   ``TabularLIME`` (regularization 0.01: kernel L) and ``TabularSHAP``
   (8 background rows) on 256 rows at 1,000 samples each: finite, 16 rows
   held to the port's CPU run within EXPLAIN_TOL, SHAP's intercept plus
   attributions within SHAP_ADD_TOL of the model's probability; (d)
   ``ImageLIME`` over the featurizer's logits on 2 images at 1,000 samples
   (cell size 16): finite coefficients and r2, one image at 64 samples held
   to the port's CPU run within LIME_IMAGE_TOL; (e) ``IsolationForest``
   (100 trees, max_samples 256, contamination 0.02) fitted on 1,048,576
   HIGGS-schema rows, every row scored by ONE launch of kernel B's forest
   entry (``iforest_tree_score``), the scores within FOREST_TOL of the heap
   descent's on the card and the predictions identical; L and B's forest
   entry must launch on that path;
2n. nearest neighbours, SAR and AccessAnomaly, ranked by kernel K (the
   top-k in ``lax.top_k``'s order, ``csrc/topk_select.cu``): with every
   launch count set to 0 just before and read just after, (b) ``KNN`` over
   1,048,576 keys x 128 f32 answering 16,384 queries (k = 10) and
   ``ConditionalKNN`` over 262,144 keys x 2,048 (ResNet-50's pooled width),
   6 labels, 4,096 queries with conditioner sets of 1-3 labels (k = 5),
   queries/s, 64 queries of each held to the port's CPU run (the same
   neighbours but swaps within TOPK_TIE_TOL); (c) ``SAR`` (jaccard, support
   4, decay 30 days) fitted on MovieLens-10M's shape less 1,000,000
   held-out ratings, ``recommend_for_all_users(10, remove_seen=True)``, the
   held-out pairs transformed; the co-occurrence counts of 64 items equal a
   host count and their similarity rows the host's jaccard bit for bit, 256
   users' lists held to the port's CPU run; (d) ``AccessAnomaly``
   (implicit, rank 10, 25 iterations) on four tenants of 10,000 users x
   2,000 resources (250,000 rows each) and a fifth of 1,000 x 400, fit s
   (ALS s apart), 1,000,000 rows transformed (known, unknown and
   cross-component), the fifth tenant's scores within ANOMALY_TOL (z units)
   of the port's CPU fit of it; K must launch in (b) and (c); then (a) K
   bit-equal to its plain version on every ``kernel_cases.TOPK_CASES`` case
   and on 256 rows of each phase shape's scores, timed beside the plain
   version, ``torch.topk`` and its bound;
3. flash attention's entry point, all causal: in bf16 (the wgmma kernel) at
   the headline shape (B=1, S=32768, H=8, D=64), the grouped-query serving
   shape (B=8, S=8192, H=8, H_kv=2, D=64), the headline length at D=128, and
   the serving shape's B=2 at D=32 and D=16; in f32 (the 3xTF32 kernel) at
   the serving shape and at B=1, S=8192, H=8, D=128; the launch counts of
   both flash kernels must be > 0;
4. every kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: histogram bit-equal (at three weightings: half
   the rows, every row, about 1/16 of the rows; and with a NaN g and an inf
   h on rows of zero weight, NaN in exactly the plain version's cells); both
   entries of kernel B (scores and leaf ids) bit-equal at (i) the fitted
   model on the held-out rows, (ii) ``higgs500`` (random trees of LightGBM's
   Higgs experiment: 500 trees of 255 leaves on the held-out rows at 255
   bins, int16; checked on the first 16,384 rows), (iii) ``higgs500-cat``
   (the same with 4 categorical features) and (iv) the fitted model's shape
   at C=3 and C=9, each with its visits (one decision per node on each row's
   path) and its bound against them at the INT32 rate of the card's maximum
   SM clock; (v) a ``LightGBMClassificationModel`` around (ii)'s trees
   transforms the held-out rows without and with ``leaf_prediction_col``
   (wall s, rows/s; both kernel-B entries must launch, and the output must
   equal (ii)'s); kernel D bit-equal at the HIGGS and Adult fits' rows and
   on edge cases (values on every rounded edge, +-inf, NaN, -0.0, unseen
   codes, f64 edges whose f32 rounding goes up, and ragged tails at d = 1,
   13 and 300) at each output type;
   kernel F bit-equal to its plain version over phase 2e's training rows at
   iteration 0 (every score tied), at the fitted ranker's scores, and there
   with the truncation at the largest query (the kernel's second loop), each
   with its counted pairs, cells visited and the first design's visits;
   kernel E's full-table entry bit-equal on histograms on the pre-rounded
   grid (numeric, mixed categorical, max_cat_threshold binding, empty bins,
   exact ties across features and bins, NaN gains, masks with l1/l2, B at
   64, 256 and kernel A's largest, Covertype's layout) and, off the grid,
   the same split wherever the runner-up is more than one ulp below the
   best; kernel P at four splits (the fitted tree's root split, its
   deepest split with the ids the fit left scattered, leaves of 1,024 and
   40 random rows: the same segments as sets, read from the buffer the
   state names, counts, buffers, smaller child and node as its plain
   version) and A's row-list entry over each split's smaller child
   (bit-equal), each timed beside its bound and library call; the step's
   epilogue bit-equal to its plain version (NaN, +-inf and -0.0, either
   side smaller, an inert step); E's step entry bit-equal to the plain
   step over every step of whole trees on E's cases and on an inert step, a
   depth cap and B = 100, timed beside the full table at the HIGGS, Adult
   and Covertype shapes;
   kernel G bit-equal to its plain version and to the row walk's plain twin
   on ``kernel_cases.SPARSE_HIST_CASES`` in every mode, on the path the CPU
   model predicts (the cases drive both), and at phase 2g's shape at six
   splits (the first tree's root split both sides and its smaller child
   with the sibling from the kept root; its deepest split replayed, both
   sides and the smaller side with the kept leaf; 1,024 and 40 member rows
   of a random leaf twice their size; the half passes equal to the
   both-sides pass, both paths taken), each with the path the card chose
   and its bound, timed beside the gather of the summed side's entries and
   ``torch.segment_reduce`` over them;
   flash within 5e-2 (bf16) and 2e-5
   (f32, at the two f32 shapes and two short ragged ones) of the f32 plain
   version, and in bf16 also within FLASH_ROW_TOL of it as an error
   relative to each output row's norm (a limit the script first shows to
   lie well below what one skipped key tile of the kernel would give); then
   kernel Q bit-equal to its plain version (int32 on the host's CPU) at
   BERT-base's FFN-in projection and ResNet-50's stage-0 3x3 at batch 128,
   each timed with every other projection and ResNet-50 conv shape, with
   torch._int_mm on int8 x int8 beside the matmul entry, and its
   channels-last copy bit-equal to its plain version; kernel R within 1e-5
   (f32) / 2e-2 (bf16, row norms) of its plain version on the card at
   GNMT's width (persistent entry) and at RNN_STEPWISE (the other entry:
   the LSTM, and the GRU with linear_before_reset=0 beside torch.nn.GRU),
   cuDNN's LSTM / GRU layer beside the configurations it computes; then
   each kernel, its
   plain version and the one PyTorch call that computes the same function
   (where there is one) timed with CUDA events; every flash shape's line
   also gives its ex2 floor, the least time of one SFU exponential per
   unmasked score (a floor of that way of computing the softmax, not a
   bound of the function).

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``. There is no CPU path: with no CUDA device
the script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_TC_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
# f32 flash runs on the tensor cores in 3xTF32 (three TF32 products per f32
# product), so its least time is at the TF32 rate over three; at the FMA
# rate a tensor-core kernel could read above 100 % of its bound
F32_3XTF32_FLOPS = 495e12 / 3
# SFU (MUFU.EX2) exponentials: 132 SMs x 16 a clock x 1.83 GHz boost; the
# ex2 floor it gives holds the softmax as the kernel computes it, not the function
EX2_PER_S = 132 * 16 * 1.83e9

N_TRAIN = 4_194_304
N_TEST = 1_048_576
N_FEATURES = 28               # HIGGS width
# Adult (BASELINE.json config #2; 32,561 rows) scaled up as HIGGS is, and
# Covertype at its full 581,012 rows, split 80/20
N_ADULT_TRAIN, N_ADULT_TEST = 4_194_304, 1_048_576
N_COVTYPE = 581_012
N_COVTYPE_TRAIN = 464_810
# phase 2h's TrainClassifier rows: Featurize runs on the host, so a quarter
# of phase 2b's
N_TC_TRAIN, N_TC_TEST = 1_048_576, 262_144
# Floors that say wrong, not slow, far above chance (AUC 0.5; the majority
# class 0.42) and below what the reference's pre-rounding allows at these
# row counts: its grid (_preround, the next power of two over the rows)
# makes binary gradients multiples of 0.5 at 4,194,304 rows. On seed 0's
# held-out rows the label's own probabilities give AUC 0.867 and the fit
# 0.848 (0.866 on a 2^16 grid); the label's logits give accuracy 0.785 and
# the 464,810-row fit 0.687 (0.758 on a 2^14 grid): tools/preround_probe.py
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
ADULT_AUC_FLOOR = 0.80
COVTYPE_ACC_FLOOR = 0.60
# phase 2g: far above chance (0.5), below what the lexicon label allows (on
# the CPU, 10 iterations at 2^14 slots over 16,384 reviews reach 0.911, at
# 2^18 slots over 65,536 reviews 0.927)
HASHED_AUC_FLOOR = 0.75
HASHED_SMALL_BITS = 14
SMALL_FIT_ROWS = 16_384
# listed rows of the small leaves at which phase 4 times kernels P and A's
# row list, and G's member rows (beside the root split and the fitted
# tree's deepest split)
SMALL_LEAVES = (1024, 40)
# contributions (f64 TreeSHAP) against kernel B's f32 margin over 10 trees:
# the margin's own rounding, a few f32 ulps of values of order 1 to 10
SHAP_TOL = 1e-5
SHAP_ROWS = 65_536
# phase 2g's rows of host TreeSHAP over the sparse model: cut from SHAP_ROWS
# to keep the script near 950 s of its 1,200 once phase 2l came in (its
# 65,536 rows took 234 s of a 1,003 s run on an NVIDIA H100 80GB HBM3 at
# 700 W)
HASHED_SHAP_ROWS = 32_768
# kernel G's device kernels: all four run every call (the path's two work,
# the other two return at once)
G_KERNEL_NAMES = (("sparse_rows",), ("sparse_entries",), ("sparse_walk",), ("sparse_epilogue",))
G_KERNELS_A_CALL = len(G_KERNEL_NAMES)
# kernel V's device kernel: one a launch (a launch runs a range of batches)
V_KERNEL_NAMES = (("vw_pass_kernel",),)
# kernel F against its plain version, in f32 ulps: both take exp_f32 and sum
# over j in j order, so the two agree bit for bit
F_ULPS = 0
# trees, classes, leaves of LightGBM's Higgs experiment (docs/Experiments.rst:
# 500 trees, num_leaves=255, max_bin=255)
HIGGS500 = (500, 1, 255)
TREE_CHECK_ROWS = 16_384      # rows the plain replay checks at S=254
# phase 2i (b): HIGGS-width rows of the two-rank fits (and held-out rows for
# the voting fit's AUC), the voting fit's top_k (10 candidates of 28
# features), hashed reviews at 2^14 slots, an MSLR-schema ranker's queries
# and documents, and how long a rank may take. The ranker has 12,288
# documents, not phase 2e's small fit's 16,384: whole queries a rank pad
# each rank's block to the largest, and the pre-rounding grid is the next
# power of two over the padded rows of every rank (the reference's rule);
# at 16,384 documents that is 32,768 and the grid is not the single fit's
# (16,384), at 12,288 the padded rows stay under 16,384
N_MESH, N_MESH_TEST = 1_048_576, 262_144
MESH_TOP_K = 5
# phase 2j: VowpalWabbitClassifier at the reference's defaults but passes,
# on phase 2g's reviews; kernel V's step checks over the first 64 batches in
# the sparse regime and a dense one (l1 and l2 set); the squared fit's l2 of
# the card-against-CPU check; the mesh fits' reviews
VW_PARAMS = dict(num_bits=18, batch_size=256, num_passes=2)
# far above chance (0.5), below what the lexicon label allows: on the CPU
# the same fit over 16,384 reviews reaches a held-out AUC of 0.845, over
# 65,536 reviews 0.877 (2^18 slots, 16,384 held-out reviews)
VW_AUC_FLOOR = 0.80
VW_STEP_BATCHES = 64
VW_TRACED_PASSES = 4
VW_STEP_REGIMES = ("sparse", "l1_l2")
VW_L2 = 1e-4
VW_MESH_ROWS = 65_536
MESH_HASHED_ROWS = 65_536
MESH_RANK_QUERIES, MESH_RANK_DOCS = 102, 12_288
MESH_TIMEOUT_S = 300
# phase 2k: the ONNX executor at bench.py's shapes (ResNet-50 at batch 128,
# BERT-base at 64 sequences of 128 tokens), the quantized graphs
# (quantize_dynamic_graph), and LSTM / GRU at GNMT's layer width (Wu et al.
# 2016: 1,024 units); each held to the port's CPU run over its first rows:
# f32 within ONNX_F32_TOL of each output's max-abs, bf16 within ONNX_ROW_TOL
# of each row's norm (tests/torch_onnx.py's), the quantized graphs within
# ONNX_QUANT_TOL of each row's norm and the same argmax: kernel Q is
# bit-equal to its plain version, but the f32 ops between (LayerNorm's
# mean and variance, Softmax) sum in another order on the card, a
# DynamicQuantizeLinear then rounds a few activations to the next step,
# and at BERT-base's 12 layers that compounds to 2.4-3.4 % of a row's norm
# (0.3 % for ResNet-50; the quantized model is itself 5.4-5.6 % from the
# float one, ResNet-50's 2.3-2.4 %: phase 2k on an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md)
N_ONNX_IMAGES, ONNX_IMAGE_BATCH, ONNX_CPU_IMAGES = 1024, 128, 8
N_ONNX_SEQS, ONNX_SEQ_BATCH, ONNX_SEQ_LEN, ONNX_CPU_SEQS = 512, 64, 128, 4
N_QUANT_IMAGES, QUANT_CPU_IMAGES, QUANT_CPU_SEQS = 256, 4, 2
BERT_VOCAB = 30522
RNN_GNMT = (128, 64, 1024)    # S, B, I = H
# a width whose R the persistent entry cannot hold (J = 16 units a block, 64
# rows of R: more than a product's 32), so kernel R's one-launch-a-step
# entry serves it; a short sequence keeps its CPU check brief
RNN_STEPWISE = (8, 64, 2048)  # S, B, I = H
# the first design of kernels Q and R in phase 2k (PERF.md: NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside this run's as a record
FIRST_DESIGN_QUANT_ROWS_PER_S = {"bert_base": 830, "resnet50": 1052}
FIRST_DESIGN_RNN_GRAPH_MS = {"lstm": [17.6, 24.3], "gru": [15.0, 29.7]}
ONNX_F32_TOL, ONNX_ROW_TOL, ONNX_QUANT_TOL = 1e-4, 2e-2, 5e-2
INT8_TC_OPS = 1979e12         # H100 SXM dense int8 tensor-core rate
# kernel P's pick reads ok, the counts, the leaf, the child's seg and side,
# and writes small and smaller_right
PICK_BYTES = 1 + 8 + 8 + 8 + 4 + 12 + 1
# B, S, H, H_kv, D of the flash shapes, all causal; bf16, then f32
FLASH_SHAPES = {
    "headline": (1, 32768, 8, 8, 64),   # bench.py flash headline
    "gqa": (8, 8192, 8, 2, 64),         # bench.py GQA serving shape
    "d128": (1, 32768, 8, 8, 128),      # the headline length at the widest head dim
    "d32": (2, 8192, 8, 2, 32),         # the small head dims (32- and 64-byte swizzles)
    "d16": (2, 8192, 8, 2, 16),
}
F32_SHAPES = {
    "f32-gqa": (8, 8192, 8, 2, 64),     # the serving shape in f32
    "f32-d128": (1, 8192, 8, 8, 128),
}
# phase 2l: kernel C's lse entries (B, S, H, H_kv, D and dtype), the
# sequence-parallel shapes (the flash headline and the GQA serving shape),
# the lse limit (|kernel - plain| over max(1, |plain|): f32 sums of the same
# products, taken in another order), the two-rank ONNX run
LSE_SHAPES = {"headline": ((1, 32768, 8, 8, 64), torch.bfloat16),
              "f32-d128": ((1, 8192, 8, 8, 128), torch.float32)}
SP_SHAPES = {"headline": (1, 32768, 8, 8, 64), "gqa": (8, 8192, 8, 2, 64)}
SP_CASES = (("headline", False), ("headline", True), ("gqa", True))
SP_RANKS = 2
LSE_TOL = 1e-4
TP_SEQS, TP_SEQ_LEN = 8, 128
SP_TIMEOUT_S = 240
# Limit on max over rows of |kernel - plain f32|_2 / |plain f32|_2 in bf16:
# the kernel's own roundings, of P and of its output to bf16, give about 2e-3
# on average and at most 7.5e-3 over the 131,072 rows of d16, the narrowest
# rows, on eight inputs (PERF.md); one key tile dropped from a row of 32768
# keys moves it by about sqrt(tile / 32768) >= 4e-2.
FLASH_ROW_TOL = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(result, device ms) of one call of ``fn``, timed with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _device_events(fn) -> list:
    """The device kernels' events in a ``torch.profiler`` trace of ``fn()``. A
    trace that comes back without device events (the tracer drops one now
    and then) is taken again, up to three times."""
    from synapseml_tpu_torch.tools.profile_fit import _device_us

    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
        if evts:
            return evts
        log(f"profiler: trace {attempt} of 3 held no device time")
    fail("the profiler saw no device time in 3 traces")


def profiled(fn, reps: int):
    """(device ms, kernel launches) of one call of ``fn``: the kernels' own
    time in a trace of ``reps`` calls after one warm-up, so the host's
    launch cost (which sets the wall time of a call this small) is left out."""
    from synapseml_tpu_torch.tools.profile_fit import _device_us

    fn()
    evts = _device_events(lambda: [fn() for _ in range(reps)])
    return (sum(_device_us(e) for e in evts) / 1e3 / reps,
            sum(e.count for e in evts) / reps)


def device_ms(fn, reps: int) -> float:
    return profiled(fn, reps)[0]


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(least time in ms, what bounds it): bytes at the memory rate against
    operations at the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve, ties at their mean rank."""
    _, inv, counts = np.unique(score, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    ranks = (cum - (counts - 1) / 2.0)[inv]
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|out - ref|_2 / |ref|_2 over the head dim, for every (b, s, h) row."""
    out, ref = out.float(), ref.float()
    return (out - ref).norm(dim=-1) / ref.norm(dim=-1)


def tail_attention(q, k, v, n_rows: int, drop=None) -> torch.Tensor:
    """f32 end-aligned causal attention of the last ``n_rows`` queries of every
    (batch, head), with the keys in the slice ``drop`` masked out if given."""
    _, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    kk = k.float().repeat_interleave(h // h_kv, dim=2)
    vv = v.float().repeat_interleave(h // h_kv, dim=2)
    sc = torch.einsum("brhd,bkhd->bhrk", q[:, -n_rows:].float(), kk) / d ** 0.5
    qpos = torch.arange(s_q - n_rows, s_q, device=q.device) + (s_k - s_q)
    keep = qpos[:, None] >= torch.arange(s_k, device=q.device)[None, :]
    if drop is not None:
        keep[:, drop] = False
    p = torch.softmax(torch.where(keep, sc, -1e30), dim=-1)
    return torch.einsum("bhrk,bkhd->brhd", p, vv)


def causal_pairs(s_q: int, s_k: int) -> int:
    """(query, key) pairs the end-aligned causal mask keeps."""
    diag = s_k - s_q
    return s_q * (s_q + 1) // 2 + diag * s_q


def reset(kernels) -> None:
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0


def counts(kernels) -> dict:
    torch.cuda.synchronize()
    return {name: k.launches for name, k in kernels.items()}


def fit_and_transform(kernels, estimator, train_table, test_table):
    """Fit, then transform, each with the launch counts set to 0 just before
    it and read just after. Returns (model, output, fit s, transform s, fit
    launches, transform launches)."""
    reset(kernels)
    t0 = time.perf_counter()
    model = estimator.fit(train_table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = counts(kernels)
    reset(kernels)
    t0 = time.perf_counter()
    out = model.transform(test_table)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    return model, out, fit_s, transform_s, fit_counts, counts(kernels)


def small_fit_same_trees(cls, params, x, y, probe_x, col="rawPrediction",
                         validation=None, extra_cols=None, fields=()) -> float:
    """The same fit on a small slice on the card and through the plain CPU
    path: identical trees (``cat_set`` included), tree scales, sampled row
    counts, the ``fields`` named, ``best_iteration`` and, with
    ``validation`` (a bool column of validation rows), eval series within
    1e-5 (f32 metric sums in another order), else the run fails. Returns
    the largest difference of the two models' outputs on ``probe_x``."""
    from synapseml_tpu_torch.core import Table

    cols = {"features": x, "label": y, **(extra_cols or {})}
    if validation is not None:
        cols["validation"] = validation
    small = Table(cols)
    gpu_m = cls(**params).fit(small)
    cpu_m = cls(device="cpu", **params).fit(small)
    gb, cb = gpu_m.booster, cpu_m.booster
    for field in ("parent", "feature", "bin", "cat_set", "tree_scale", "sampled_rows",
                  *fields):
        a, b = getattr(gb, field), getattr(cb, field)
        if not ((a is None and b is None) or np.array_equal(a, b)):
            fail(f"small fit: {field} differs between the card and the CPU path")
    if gb.best_iteration != cb.best_iteration:
        fail(f"small fit: best_iteration {gb.best_iteration} on the card, "
             f"{cb.best_iteration} on the CPU")
    if validation is not None:
        series = [np.array([[v for k, v in r.items() if k != "iteration"]
                            for r in b.evals_result]) for b in (gb, cb)]
        if series[0].shape != series[1].shape or not len(series[0]) or \
                not np.abs(series[0] - series[1]).max() <= 1e-5:
            fail(f"small fit: eval series differ between the card and the CPU: {series}")
    probe = Table({"features": probe_x})
    return float(np.abs(np.asarray(gpu_m.transform(probe)[col])
                        - np.asarray(cpu_m.transform(probe)[col])).max())


def sampled_fits(kernels, gbdt_params, x_tr, y_tr, x_te, y_te, split_steps, dev) -> dict:
    """Phase 2d: ``LightGBMClassifier`` at HIGGS width under each training
    control of ``schema_data.SAMPLED_MODES`` (bagging with feature fraction
    and an eval set with early stopping, GOSS, DART, rf), each fit and
    transform with the launch counts set to 0 just before and read just
    after; then the plain torch work the controls add, timed on the card,
    and a small fit of each mode on the card and the CPU."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
    from synapseml_tpu_torch.gbdt.grow import predict_binned
    from synapseml_tpu_torch.gbdt.metrics import METRICS, device_metric
    from synapseml_tpu_torch.gbdt.sampling import goss_cut, prng_key, uniform
    from synapseml_tpu_torch.tools.schema_data import SAMPLED_MODES

    n_train, n_test = len(y_tr), len(y_te)
    auc_np = METRICS["auc"][0]
    results, boosters = {}, {}
    for mode, extra in SAMPLED_MODES.items():
        params = dict(gbdt_params, **extra)
        if mode == "bagged_eval":  # the held-out rows as validation rows
            params["validation_indicator_col"] = "validation"
            table = Table({"features": np.concatenate([x_tr, x_te]),
                           "label": np.concatenate([y_tr, y_te]),
                           "validation": np.arange(n_train + n_test) >= n_train})
        else:
            table = Table({"features": x_tr, "label": y_tr})
        est = LightGBMClassifier(**params)
        model, out, fit_s, transform_s, fit_l, trans_l = fit_and_transform(
            kernels, est, table, Table({"features": x_te}))
        del table
        b = model.booster
        boosters[mode] = b
        prob = np.asarray(out["probability"])
        if prob.shape != (n_test, 2) or not np.isfinite(prob).all():
            fail(f"{mode}: transform probability {prob.shape}, finite {np.isfinite(prob).all()}")
        heldout = auc(y_te, prob[:, 1])
        rec = {"phase": "gbdt_sampled", "mode": mode, **extra, "rows_train": n_train,
               "rows_test": n_test, "fit_s": fit_s, "transform_s": transform_s,
               "transform_rows_per_s": n_test / transform_s, "heldout_auc": heldout,
               "trees": b.num_trees, "fit_launches": fit_l, "transform_launches": trans_l}
        if b.sampled_rows is not None:
            share = b.sampled_rows / n_train
            rec.update(histogram_root_live_share=share.tolist(),
                       histogram_root_live_share_mean=float(share.mean()))
        if mode == "dart":
            rec["tree_scale"] = b.tree_scale.tolist()
            rec["trees_rescaled"] = int((b.tree_scale < est.learning_rate - 1e-12).sum())
        del out, prob
        if mode == "bagged_eval":
            series = [r["eval0_auc"] for r in b.evals_result]
            check = [auc_np(y_te, b.raw_predict(x_te, num_iteration=i + 1), np.ones(n_test))
                     for i in range(len(series))]
            err = float(np.abs(np.array(series) - np.array(check)).max())
            rec.update(eval_auc=series, best_iteration=b.best_iteration,
                       eval_vs_model_auc_max_diff=err)
            if not err <= 1e-4:
                fail(f"{mode}: eval AUC series differs from the model's AUC by {err} (> 1e-4)")
            if b.best_iteration is None or len(series) != b.num_trees:
                fail(f"{mode}: best_iteration {b.best_iteration}, {len(series)} eval records "
                     f"for {b.num_trees} trees")
            if fit_l["gbdt_bin_features"] < 2:
                fail(f"{mode}: kernel D did not bin the eval rows")
        log(json.dumps(rec))
        results[mode] = rec
        if not heldout > 0.9:
            fail(f"{mode}: held-out AUC {heldout:.4f} <= 0.9")
        for name in ("gbdt_histogram", "gbdt_split_search", "gbdt_bin_features"):
            if fit_l[name] < 1:
                fail(f"the {mode} fit never launched {name}")
        # every iteration trains 30 split steps (early stopping trains the
        # whole 10-iteration chunk before it stops)
        if fit_l["gbdt_split_search"] != split_steps(gbdt_params):
            fail(f"kernel E launched {fit_l['gbdt_split_search']} times in the {mode} fit, "
                 f"not once a split step ({split_steps(gbdt_params)})")
        if trans_l["gbdt_tree_score"] < 1 or trans_l["gbdt_bin_features"] < 1:
            fail(f"the {mode} transform launched {trans_l}")

    # the plain torch work the controls add, on the card: one draw over the
    # training rows, one GOSS cut over them, one device AUC over the
    # held-out rows, and one routing pass of a tree (DART's replay over the
    # training rows, the eval margins' over the held-out rows)
    binned_tr = boosters["dart"].mapper.transform_torch(torch.from_numpy(x_tr).to(dev))
    binned_te = boosters["dart"].mapper.transform_torch(torch.from_numpy(x_te).to(dev))
    key = prng_key(3)
    g_abs = (torch.rand(n_train, device=dev) * 4).round() / 4
    score = torch.from_numpy(boosters["bagged_eval"].raw_predict(x_te).astype(np.float32)).to(dev)
    y_d, w_d = torch.from_numpy(y_te).to(dev, torch.float32), torch.ones(n_test, device=dev)
    tree = _grown_tree(boosters["dart"], 0, dev)
    work = {
        "uniform_train_rows": lambda: uniform(key, n_train, dev),
        "goss_cut_train_rows": lambda: goss_cut(g_abs, 0.8),
        "device_auc_heldout_rows": lambda: device_metric("auc")(y_d, score, w_d),
        "dart_replay_train_rows": lambda: tree.leaf_value[predict_binned(tree, binned_tr).long()],
        "eval_routing_heldout_rows": lambda: tree.leaf_value[predict_binned(tree, binned_te)
                                                            .long()],
    }
    timings = {}
    for name, fn in work.items():
        ms, launches = profiled(fn, 3)
        timings[name] = {"ms": time_ms(fn, 10), "device_ms": ms, "launches": launches}
    on_cpu = uniform(key, n_train + 3, "cpu")
    if not torch.equal(uniform(key, n_train + 3, dev).cpu(), on_cpu):
        fail("uniform draws differ between the card and the CPU")
    log(json.dumps({"phase": "gbdt_sampled_ops", "card_equals_cpu_uniform_rows": n_train + 3,
                    **timings}))
    del binned_tr, binned_te, g_abs, score
    return {"fits": results, "ops": timings}


def ranker_phase(kernels, seed: int, split_steps) -> dict:
    """Phase 2e: ``LightGBMRanker`` at MSLR-WEB30K Fold1's shape, fit with
    the validation queries watched by NDCG@10 and early stopping, then
    transform of the validation rows, each with the launch counts set to 0
    just before and read just after; then a ranker fit at ~16,384 rows on
    the card and the CPU. Returns the phase's record and what phase 4 holds
    kernel F to (the training rows' labels, query sizes and fitted margins)."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.estimators import LightGBMRanker
    from synapseml_tpu_torch.gbdt.metrics import metric_ndcg
    from synapseml_tpu_torch.tools.schema_data import FITS, MSLR_TRAIN, MSLR_VALID, mslr_rows

    t0 = time.perf_counter()
    x_tr, y_tr, s_tr = mslr_rows(seed, *MSLR_TRAIN)
    x_va, y_va, s_va = mslr_rows(seed, *MSLR_VALID, part=1)
    n_tr, n_va = len(y_tr), len(y_va)
    data_s = time.perf_counter() - t0
    fit_params = FITS["mslr"][2]
    params = dict(fit_params, validation_indicator_col="validation", early_stopping_round=3)
    table = Table({"features": np.concatenate([x_tr, x_va]),
                   "label": np.concatenate([y_tr, y_va]),
                   "group": np.repeat(np.arange(len(s_tr) + len(s_va)),
                                      np.concatenate([s_tr, s_va])),
                   "validation": np.arange(n_tr + n_va) >= n_tr})
    model, out, fit_s, transform_s, fit_l, trans_l = fit_and_transform(
        kernels, LightGBMRanker(**params), table, Table({"features": x_va}))
    del table
    b = model.booster
    pred = np.asarray(out["prediction"])
    if pred.shape != (n_va,) or not np.isfinite(pred).all():
        fail(f"ranker transform: prediction {pred.shape}, finite {np.isfinite(pred).all()}")
    ndcg = metric_ndcg(10)
    heldout = ndcg(y_va, pred, None, s_va)
    random_order = ndcg(y_va, np.random.default_rng(seed + 9).random(n_va), None, s_va)
    series = [r["eval0_ndcg@10"] for r in b.evals_result]
    trained = len(series)
    # the model cut at each iteration, its margins as the eval path sums them:
    # each tree's f32 scale-times-leaf (leaf ids from kernel B), added in f64
    leaves = b.predict_leaf(x_va, num_iteration=b.num_trees)
    terms = np.stack([b.leaf_value[t, 0][leaves[:, t]] * np.float32(b.tree_scale[t])
                      for t in range(b.num_trees)], 1).astype(np.float64)
    margins = np.cumsum(terms, axis=1)
    cut = [ndcg(y_va, margins[:, i], None, s_va) for i in range(trained)]
    cut_err = float(np.abs(np.array(series) - np.array(cut)).max())
    # kernel B's f32 sums order near-ties otherwise: reported, not held
    score_err = max(abs(series[i] - ndcg(y_va, b.raw_predict(x_va, num_iteration=i + 1),
                                         None, s_va)) for i in range(trained))
    del leaves, terms, margins
    fitted = b.raw_predict(x_tr).astype(np.float32)  # the margins of the last iteration kept
    # the same fit at ~16,384 rows on the card and the CPU
    k = int(np.searchsorted(np.cumsum(s_tr), SMALL_FIT_ROWS, side="right"))
    kv = int(np.searchsorted(np.cumsum(s_va), SMALL_FIT_ROWS // 4, side="right"))
    n_small, nv_small = int(s_tr[:k].sum()), int(s_va[:kv].sum())
    xv_small = x_va[:nv_small].copy()
    del x_va, out
    small_err = small_fit_same_trees(
        LightGBMRanker, params, np.concatenate([x_tr[:n_small], xv_small]),
        np.concatenate([y_tr[:n_small], y_va[:nv_small]]), xv_small, col="prediction",
        validation=np.arange(n_small + nv_small) >= n_small,
        extra_cols={"group": np.repeat(np.arange(k + kv), np.concatenate([s_tr[:k],
                                                                            s_va[:kv]]))},
        fields=("leaf_value", "leaf_hess"))
    del x_tr, xv_small
    rec = {"phase": "gbdt_mslr_ranker", "rows_train": n_tr, "queries_train": len(s_tr),
           "rows_valid": n_va, "queries_valid": len(s_va), "features": 136,
           "largest_query": int(max(s_tr.max(), s_va.max())), **fit_params,
           "early_stopping_round": 3, "data_s": data_s, "fit_s": fit_s,
           "transform_s": transform_s, "transform_rows_per_s": n_va / transform_s,
           "heldout_ndcg10": heldout, "random_order_ndcg10": random_order,
           "eval_ndcg10": series, "best_iteration": b.best_iteration, "trees": b.num_trees,
           "eval_vs_model_ndcg_max_diff": cut_err,
           "eval_vs_kernel_b_margin_ndcg_max_diff": score_err, "fit_launches": fit_l,
           "transform_launches": trans_l, "small_fit_rows": n_small + nv_small,
           "small_fit_prediction_max_diff": small_err}
    log(json.dumps(rec))
    if not heldout >= random_order + 0.1:
        fail(f"ranker: held-out NDCG@10 {heldout:.4f} is not 0.1 over a random order's "
             f"{random_order:.4f}")
    if cut_err != 0.0:
        fail(f"ranker: eval NDCG series differs from the models cut there by {cut_err}")
    if fit_l["gbdt_lambdarank"] != trained:
        fail(f"kernel F launched {fit_l['gbdt_lambdarank']} times in {trained} iterations")
    if fit_l["gbdt_split_search"] != split_steps(dict(fit_params, num_iterations=trained)):
        fail(f"kernel E launched {fit_l['gbdt_split_search']} times in the ranker fit")
    if fit_l["gbdt_histogram"] < 1 or fit_l["gbdt_bin_features"] < 2:
        fail(f"the ranker fit launched {fit_l}")
    if trans_l["gbdt_tree_score"] < 1 or trans_l["gbdt_bin_features"] < 1:
        fail(f"the ranker transform launched {trans_l}")
    if not small_err <= 1e-6:
        fail(f"ranker small fit: predictions differ by {small_err} card vs CPU")
    return {"record": rec, "y": y_tr, "sizes": s_tr, "fitted": fitted,
            "truncation": int(fit_params["lambdarank_truncation_level"])}


def model_surface(kernels, higgs_model, adult_model, x_te, xa_te) -> dict:
    """Phase 2e's model surface on the card: ``features_shap_col`` of the
    HIGGS and Adult models on SHAP_ROWS held-out rows (contributions add up
    to kernel B's margin within SHAP_TOL), the HIGGS model through
    ``save_native_model`` / ``load_native_model`` (bit-equal on the card
    and the CPU, within SHAP_TOL of the model it came from), and the
    hand-written LightGBM texts scoring on the card as on the CPU."""
    import os
    import tempfile

    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.boost import GBDTBooster
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassificationModel
    from synapseml_tpu_torch.tools.kernel_cases import native_texts

    rec = {"phase": "gbdt_model_surface", "rows": SHAP_ROWS, "tolerance": SHAP_TOL}
    for key, m, xs in (("higgs", higgs_model, x_te[:SHAP_ROWS]),
                       ("adult", adult_model, xa_te[:SHAP_ROWS])):
        stage = LightGBMClassificationModel(booster=m.booster, features_shap_col="shap")
        reset(kernels)
        t0 = time.perf_counter()
        out = stage.transform(Table({"features": xs}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        shap = np.asarray(out["shap"])
        raw = np.asarray(out["rawPrediction"])[:, 1]
        err = float(np.abs(shap.sum(axis=1) - raw).max())
        rec[key] = {"transform_s": wall, "rows_per_s": len(xs) / wall,
                    "additivity_max_err": err, "launches": launches}
        if shap.shape != (len(xs), xs.shape[1] + 1) or not np.isfinite(shap).all():
            fail(f"{key} contributions: shape {shap.shape}, finite {np.isfinite(shap).all()}")
        if not err <= SHAP_TOL:
            fail(f"{key} contributions add up to kernel B's margin within {err} > {SHAP_TOL}")
        if launches["gbdt_bin_features"] < 2 or launches["gbdt_tree_score"] < 1:
            fail(f"{key} transform with contributions launched {launches}")
    xs = x_te[:SHAP_ROWS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "higgs.txt")
        LightGBMClassificationModel(booster=higgs_model.booster).save_native_model(path)
        back = LightGBMClassificationModel.load_native_model(path).booster
        rec["native_text_bytes"] = os.path.getsize(path)
    reset(kernels)
    raw_card = back.raw_predict(xs)
    launches = counts(kernels)
    raw_cpu = back.raw_predict(xs, device="cpu")
    drift = float(np.abs(raw_card - higgs_model.booster.raw_predict(xs)).max())
    rec["native_round_trip"] = {"launches": launches, "vs_original_max_diff": drift,
                                "card_equals_cpu": bool(np.array_equal(raw_card, raw_cpu))}
    if not np.array_equal(raw_card, raw_cpu):
        fail("a model read back by load_native_model scores differently on the card and the CPU")
    if not drift <= SHAP_TOL or launches["gbdt_bin_features"] < 1 or \
            launches["gbdt_tree_score"] < 1:
        fail(f"native round trip: {rec['native_round_trip']}")
    probes = np.array([-2.0, -1.0, 0.0, 5e-36, -5e-36, 1e-35, 2e-35, 0.25, 1.5, 3.0, np.nan],
                      np.float32)
    for name, text in native_texts().items():
        booster = GBDTBooster.from_native_model(text)
        d = booster.mapper.n_features
        grid = np.stack(np.meshgrid(*([probes] * d), indexing="ij"), -1).reshape(-1, d)
        if not np.array_equal(booster.raw_predict(grid), booster.raw_predict(grid, device="cpu")):
            fail(f"the hand-written LightGBM text {name!r} scores differently on the card")
    rec["handwritten_texts_card_equals_cpu"] = sorted(native_texts())
    log(json.dumps(rec))
    return rec


def kernel_times(fn, keys) -> dict:
    """{key: (device ms, launches)} of the kernels whose traced name holds
    every part of each key (a tuple of substrings; the empty key: every
    kernel), in a trace of one call of ``fn``."""
    from synapseml_tpu_torch.tools.profile_fit import _device_us

    evts = _device_events(fn)
    hit = lambda key, e: all(part in e.key for part in key)
    return {key: (sum(_device_us(e) for e in evts if hit(key, e)) / 1e3,
                  sum(e.count for e in evts if hit(key, e))) for key in keys}


def gathered_bytes(rows: torch.Tensor, row_bytes: int, first: int, width: int) -> int:
    """Bytes of the distinct 32-byte sectors that reading ``width`` bytes at
    offset ``first`` of each listed row (rows ``row_bytes`` apart) touches:
    what a gather of those rows must move, however scattered or sequential
    the rows are."""
    start = rows.to(torch.int64) * row_bytes + first
    s0, s1 = start // 32, (start + width - 1) // 32
    if rows.numel() == 0:
        return 0
    sectors = s0[:, None] + torch.arange(int((s1 - s0).max()) + 1, device=rows.device)
    return 32 * int(torch.unique(sectors[sectors <= s1[:, None]]).numel())


def leaf_local_phase(kernels, gbdt, x_tr, y_tr, x_te, split_steps) -> dict:
    """Phase 2f: ``train`` at the main path's rows and parameters, growing
    over the row partition (as shipped) and through the full pass it
    replaced (``kernel_cases.grow_full_pass``), each fit with the launch
    counts set to 0 just before and read just after: identical trees and
    bit-equal held-out margins, kernel P, A's row-list entry and the
    epilogue once a split step as shipped (A's full entry once a tree, for the root), and each
    path's kernel A launches, device ms a fit of A, P and the epilogue,
    launches a split step and device busy ms (a traced fit of each path, in
    turns full pass, shipped, shipped, full pass) and rows histogrammed a
    fit (from the trees: ``kernel_cases.rows_histogrammed``). Then a
    continued-training fit and a ``num_batches=2`` fit at 16,384 rows on the
    card and the CPU."""
    from synapseml_tpu_torch.gbdt.boost import train
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier, LightGBMRegressor
    from synapseml_tpu_torch.gbdt.histogram import HIST_ROWS_TRACE, HIST_TRACE, SIBLING_TRACE
    from synapseml_tpu_torch.gbdt.partition import PARTITION_TRACE
    from synapseml_tpu_torch.tools.kernel_cases import full_pass, rows_histogrammed

    params = {k: v for k, v in gbdt.items()}
    params["objective"] = "binary"
    T, steps, n = params["num_iterations"], split_steps(params), len(y_tr)
    growth = {"full_pass": full_pass, "shipped": contextlib.nullcontext}
    paths = {}
    for path, ctx in growth.items():
        reset(kernels)
        t0 = time.perf_counter()
        with ctx():
            booster = train(params, x_tr, y_tr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        paths[path] = {"booster": booster, "fit_s": fit_s, "launches": counts(kernels)}
    full, local = paths["full_pass"]["booster"], paths["shipped"]["booster"]
    for field in ("parent", "feature", "bin", "gain", "leaf_value", "leaf_hess", "tree_scale"):
        if not np.array_equal(getattr(full, field), getattr(local, field)):
            fail(f"partitioned growth: {field} differs from the full pass's")
    margins = {path: paths[path]["booster"].raw_predict(x_te) for path in paths}
    if not np.array_equal(margins["full_pass"], margins["shipped"]):
        fail("partitioned growth: held-out margins differ from the full pass's")
    want = {"full_pass": {"gbdt_histogram": T + steps, "gbdt_histogram_rows": 0,
                          "gbdt_partition": 0, "gbdt_sibling": 0},
            "shipped": {"gbdt_histogram": T, "gbdt_histogram_rows": steps,
                        "gbdt_partition": steps, "gbdt_sibling": steps}}
    for path, w in want.items():
        got = {k: paths[path]["launches"][k] for k in w}
        if got != w or paths[path]["launches"]["gbdt_split_search"] != steps:
            fail(f"{path} fit launched {paths[path]['launches']}, expected {w} and E {steps}")
    leaves = local.predict_leaf(x_tr)
    routed = right = small = 0
    for t in range(T):
        sums = rows_histogrammed(local.parent[t, 0],
                                 np.bincount(leaves[:, t], minlength=params["num_leaves"]))
        routed, right, small = routed + sums[0], right + sums[1], small + sums[2]
    del leaves
    traced = {path: [] for path in paths}
    for path in ("full_pass", "shipped", "shipped", "full_pass"):
        with growth[path]():
            traced[path].append(kernel_times(lambda: train(params, x_tr, y_tr),
                                             (HIST_TRACE, HIST_ROWS_TRACE, PARTITION_TRACE,
                                              SIBLING_TRACE, ())))
    rows = {"full_pass": {"rows_binned": T * n + right, "ghw_rows_read": (T + steps) * n},
            "shipped": {"rows_binned": T * n + small, "ghw_rows_read": T * n + small,
                        "rows_partitioned": routed}}
    rec = {"phase": "gbdt_leaf_local", "rows_train": n, **params, "split_steps": steps}
    for path in paths:
        runs = traced[path]
        rec[path] = {"fit_s": paths[path]["fit_s"],
                     "kernel_a_launches": (paths[path]["launches"]["gbdt_histogram"]
                                           + paths[path]["launches"]["gbdt_histogram_rows"]),
                     "kernel_a_device_ms": [r[HIST_TRACE][0] + r[HIST_ROWS_TRACE][0]
                                            for r in runs],
                     "kernel_a_full_entry_device_ms": [r[HIST_TRACE][0] for r in runs],
                     "kernel_a_row_list_device_ms": [r[HIST_ROWS_TRACE][0] for r in runs],
                     "kernel_p_device_ms": [r[PARTITION_TRACE][0] for r in runs],
                     "kernel_p_launches": paths[path]["launches"]["gbdt_partition"],
                     "epilogue_device_ms": [r[SIBLING_TRACE][0] for r in runs],
                     "launches_per_split_step": [r[()][1] / steps for r in runs],
                     "device_busy_ms": [r[()][0] for r in runs],
                     **rows[path]}
    rec["identical_trees_and_margins"] = True
    log(json.dumps(rec))

    # continued training (with an eval set) and num_batches=2 at 16,384
    # rows: the same trees on the card and the CPU
    n_small = SMALL_FIT_ROWS
    xs, ys, xe = x_tr[:n_small], y_tr[:n_small], x_te[:4096]
    small = dict(params, num_iterations=3)
    fits = {}
    for dev_name in ("cuda", "cpu"):
        first = train(small, xs, ys, device=dev_name)
        fits[dev_name] = train(small, xs, ys, device=dev_name, init_booster=first,
                               eval_set=[(xe, (xe[:, 0] > 0).astype(np.float64))])
    a, b = fits["cuda"], fits["cpu"]
    for field in ("parent", "feature", "bin", "leaf_value", "leaf_hess", "tree_scale"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            fail(f"continued training: {field} differs between the card and the CPU")
    ea = np.array([r["eval0_binary_logloss"] for r in a.evals_result])
    eb = np.array([r["eval0_binary_logloss"] for r in b.evals_result])
    if a.num_trees != 6 or not np.abs(ea - eb).max() <= 1e-5:
        fail(f"continued training: {a.num_trees} trees, eval series {ea} against {eb}")
    cont_err = float(np.abs(a.raw_predict(xe) - b.raw_predict(xe, device="cpu")).max())
    batch_err = {}
    for cls in (LightGBMClassifier, LightGBMRegressor):
        yb = ys if cls is LightGBMClassifier else xs[:, 0] + 0.5 * xs[:, 5]
        batch_err[cls.__name__] = small_fit_same_trees(
            cls, dict(gbdt, num_iterations=5, num_batches=2), xs, yb, xe,
            col="rawPrediction" if cls is LightGBMClassifier else "prediction")
    small_rec = {"phase": "gbdt_continued_and_batches", "rows": n_small,
                 "continued_raw_max_diff": cont_err, "num_batches_raw_max_diff": batch_err}
    log(json.dumps(small_rec))
    if not (cont_err <= 1e-5 and max(batch_err.values()) <= 1e-5):
        fail(f"continued or batch fits differ between the card and the CPU: {small_rec}")
    return {"record": rec, "booster": local}


def dense_used_features(booster, csr):
    """(a booster over the trees' used features only, the (n, |F|) f32 dense
    values of those features): its dense predict is what CSR scoring must
    equal."""
    from synapseml_tpu_torch.gbdt.boost import GBDTBooster

    F = np.unique(booster.feature)
    state = booster.state_dict()
    m = booster.mapper.to_dict()
    m["upper_edges"] = [m["upper_edges"][j] for j in F]
    m["cat_values"] = {str(int(np.searchsorted(F, int(k)))): v
                       for k, v in m["cat_values"].items() if int(k) in F}
    m["categorical_features"] = sorted(int(np.searchsorted(F, j))
                                       for j in m["categorical_features"] if j in F)
    state.update(feature=np.searchsorted(F, booster.feature).astype(np.int32), mapper=m)
    lut = np.full(csr.shape[1], -1)
    lut[F] = np.arange(len(F))
    k = lut[csr.indices]
    dense = np.zeros((csr.shape[0], len(F)), np.float32)
    dense[csr.row_ids()[k >= 0], k[k >= 0]] = csr.values[k >= 0]
    return GBDTBooster.from_state_dict(state), dense


def hashed_text_phase(kernels, seed, split_steps) -> dict:
    """Phase 2g (see the module's doc). Returns the phase's record and what
    phase 4 times G on: the fitted booster and the training rows."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.boost import train
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
    from synapseml_tpu_torch.tools.kernel_cases import full_pass, pairs_column
    from synapseml_tpu_torch.tools.schema_data import FITS, hashed_text_rows

    n_train, n_made, params = FITS["hashed_text"]
    t0 = time.perf_counter()
    X, y = hashed_text_rows(seed, n_made)
    x_tr, x_te, y_tr, y_te = X[:n_train], X[n_train:], y[:n_train], y[n_train:]
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    col = pairs_column(X)
    pairs_s = time.perf_counter() - t0
    meta = {"features": {"type": "vw_sparse"}}
    train_table = Table({"features": col[:n_train], "label": y_tr}, meta=meta)
    test_table = Table({"features": col[n_train:]}, meta=meta)
    del col
    log(f"phase 2g data: {n_train}+{n_made - n_train} reviews, {X.nnz} stored entries "
        f"({X.nnz / n_made:.1f} a review) in {data_s:.1f} s, pair column {pairs_s:.1f} s")
    model, out, fit_s, transform_s, fit_l, trans_l = fit_and_transform(
        kernels, LightGBMClassifier(**params), train_table, test_table)
    booster = model.booster
    T, L = params["num_iterations"], params["num_leaves"]
    calls = T * L  # G and E's full entry: once at each tree's root, once a split step
    for name in ("gbdt_sparse_hist", "gbdt_split_search"):
        if fit_l[name] != calls:
            fail(f"the hashed-text fit launched {name} {fit_l[name]} times, not {calls} "
                 f"(once at each of {T} roots and once a split step)")
    idle = [k for k in ("gbdt_histogram", "gbdt_histogram_rows", "gbdt_partition",
                        "gbdt_sibling", "gbdt_bin_features") if fit_l[k]]
    if idle:
        fail(f"the sparse fit launched the dense path's kernels {idle}")
    if trans_l["gbdt_tree_score"] < 1:
        fail("the hashed-text transform never launched kernel B")
    prob = np.asarray(out["probability"])[:, 1]
    if prob.shape != (len(y_te),) or not np.isfinite(prob).all():
        fail(f"hashed-text probabilities: shape {prob.shape}")
    heldout_auc = auc(y_te, prob)
    if not heldout_auc > HASHED_AUC_FLOOR:
        fail(f"hashed-text held-out AUC {heldout_auc:.4f} <= {HASHED_AUC_FLOOR}")
    # CSR scoring against the dense path over the used features
    raw_csr = booster.raw_predict(x_te)
    sub_booster, dense = dense_used_features(booster, x_te)
    reset(kernels)
    raw_dense = sub_booster.raw_predict(dense)
    dense_l = counts(kernels)
    if not np.array_equal(raw_csr, raw_dense) or dense_l["gbdt_bin_features"] < 1:
        fail(f"CSR raw_predict differs from the densified used-feature predict by "
             f"{float(np.abs(raw_csr - raw_dense).max())} (launches {dense_l})")
    del dense
    # contributions on HASHED_SHAP_ROWS held-out rows
    xs = x_te[:HASHED_SHAP_ROWS]
    t0 = time.perf_counter()
    contrib = booster.predict_contrib(xs)
    shap_s = time.perf_counter() - t0
    sums = np.add.reduceat(contrib.values, contrib.indptr[:-1])
    shap_err = float(np.abs(sums - booster.raw_predict(xs)).max())
    if contrib.shape != (HASHED_SHAP_ROWS, X.shape[1] + 1) or not shap_err <= SHAP_TOL:
        fail(f"hashed-text contributions: shape {contrib.shape}, additivity {shap_err}")
    # the full-pass oracle at the same rows: the shipped half pass's trees
    fit_params = dict(objective="binary", num_iterations=T, num_leaves=L)
    reset(kernels)
    t0 = time.perf_counter()
    with full_pass():
        full = train(fit_params, x_tr, y_tr)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_l = counts(kernels)
    for field in ("parent", "feature", "bin", "leaf_value", "leaf_hess"):
        if not np.array_equal(getattr(full, field), getattr(booster, field)):
            fail(f"the full-pass hashed-text fit's {field} differs from the half pass's")
    if full_l["gbdt_sparse_hist"] != calls or full_l["gbdt_split_search"] != calls:
        fail(f"the full-pass fit launched {full_l}")
    # the same fit at 16,384 reviews and 2^14 slots on the card and the CPU
    xs_small, ys_small = hashed_text_rows(seed + 1, 2 * SMALL_FIT_ROWS, HASHED_SMALL_BITS)
    small_cols = pairs_column(xs_small)
    small_err = small_fit_same_trees(
        LightGBMClassifier, dict(params, num_iterations=3, sparse_num_bits=HASHED_SMALL_BITS),
        small_cols[:SMALL_FIT_ROWS], ys_small[:SMALL_FIT_ROWS], small_cols[SMALL_FIT_ROWS:])
    if not small_err <= 1e-4:
        fail(f"hashed-text small fit: raw scores differ by {small_err} card vs CPU")
    steps = split_steps(params)
    rec = {"phase": "gbdt_hashed_text", "rows_train": n_train, "rows_test": len(y_te),
           "slots": X.shape[1], "stored_entries": X.nnz, "realized_bins":
           booster.mapper.realized_n_bins, **params, "data_s": data_s, "pairs_s": pairs_s,
           "fit_s": fit_s, "transform_s": transform_s, "fit_rows_per_s": n_train / fit_s,
           "transform_rows_per_s": len(y_te) / transform_s, "heldout_auc": heldout_auc,
           "fit_launches": fit_l, "transform_launches": trans_l,
           "csr_equals_dense_used_features": True, "contrib_rows": HASHED_SHAP_ROWS,
           "contrib_s": shap_s, "contrib_additivity_max_err": shap_err,
           "full_pass_fit_s": full_s, "full_pass_identical_trees": True,
           "full_pass_fit_launches": full_l["gbdt_sparse_hist"],
           "small_fit_rows": SMALL_FIT_ROWS, "small_fit_bits": HASHED_SMALL_BITS,
           "small_fit_raw_max_diff": small_err, "split_steps": steps, "g_calls": calls}
    log(json.dumps(rec))
    return {"record": rec, "booster": booster, "x_tr": x_tr, "y_tr": y_tr,
            "x_te": x_te, "y_te": y_te, "fit_params": fit_params}


def same_booster(a, b) -> str:
    """The first field in which two boosters' trees differ, or ''."""
    for field in ("parent", "feature", "bin", "cat_set", "leaf_value", "leaf_hess",
                  "tree_scale", "base_score"):
        x, y = getattr(a, field), getattr(b, field)
        if not ((x is None and y is None) or np.array_equal(x, y)):
            return field
    return ""


def stable_rank_auc(y: np.ndarray, score: np.ndarray) -> float:
    """AUC as the Mann-Whitney statistic over the ranks of a stable sort of
    the scores (ties in row order): the definition of the metric that
    ``ComputeModelStatistics`` reports."""
    order = np.argsort(score, kind="stable")
    pos = (y[order] > 0)
    ranks = np.arange(1, len(y) + 1, dtype=np.float64)
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def dataset_phase(kernels, seed, gbdt, x_tr, y_tr, main_fit_s, split_steps, dev) -> dict:
    """Phase 2h (i)-(iii) (see the module's doc): a ``GBDTDataset`` built once
    from phase 2's rows on the card, reused by two fits and a continued fit;
    a CSR dataset reused by two fits."""
    import synapseml_tpu_torch.gbdt.boost as boost_mod
    import synapseml_tpu_torch.gbdt.dataset as dataset_mod
    from synapseml_tpu_torch.gbdt import GBDTDataset
    from synapseml_tpu_torch.gbdt.boost import train
    from synapseml_tpu_torch.tools.schema_data import FITS, hashed_text_rows

    params = dict(gbdt, objective="binary")
    second = dict(params, num_leaves=15, learning_rate=0.05)
    x_d = torch.from_numpy(x_tr).to(dev)
    y_d = torch.from_numpy(y_tr).to(dev)
    torch.cuda.synchronize()
    # (i) the dataset: kernel D once in the construction, then fits that bin nothing
    reset(kernels)
    t0 = time.perf_counter()
    ds = GBDTDataset(x_d, label=y_d, max_bin=params["max_bin"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_l = counts(kernels)
    if build_l["gbdt_bin_features"] != 1:
        fail(f"the device-resident GBDTDataset launched kernel D "
             f"{build_l['gbdt_bin_features']} times in its construction, not once")
    d_ms = time_ms(lambda: ds.mapper.transform_torch(ds.x), 5)
    fits = {}
    for name, p in (("phase2_params", params), ("leaves15_lr005", second)):
        reset(kernels)
        t0 = time.perf_counter()
        booster = train(p, ds)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fl = counts(kernels)
        steps = split_steps(p)
        if fl["gbdt_bin_features"] != 0:
            fail(f"the {name} fit over the GBDTDataset launched kernel D "
                 f"{fl['gbdt_bin_features']} times")
        for k in ("gbdt_split_search", "gbdt_partition", "gbdt_histogram_rows"):
            if fl[k] != steps:
                fail(f"the {name} fit over the GBDTDataset launched {k} {fl[k]} times, "
                     f"not once a split step ({steps})")
        fits[name] = {"booster": booster, "fit_s": fit_s, "launches": fl}
    b1 = fits["phase2_params"]["booster"]
    reset(kernels)
    t0 = time.perf_counter()
    b_raw = train(params, x_tr, y_tr)
    torch.cuda.synchronize()
    raw_fit_s = time.perf_counter() - t0
    diff = same_booster(b1, b_raw)
    if diff:
        fail(f"the GBDTDataset fit's {diff} differs from the raw-matrix fit's")
    # (ii) continued training from the dataset, scored over its cached bins
    more = dict(params, num_iterations=5)
    reset(kernels)
    t0 = time.perf_counter()
    b_cont = train(more, ds, init_booster=b1)
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    cont_l = counts(kernels)
    diff = same_booster(b_cont, train(more, x_tr, y_tr, init_booster=b_raw))
    if diff or b_cont.num_trees != params["num_iterations"] + 5:
        fail(f"the continuation from the GBDTDataset differs from the raw-matrix "
             f"continuation in {diff or 'its tree count'}")
    if cont_l["gbdt_bin_features"] != 0:
        fail(f"the continuation over the GBDTDataset launched kernel D "
             f"{cont_l['gbdt_bin_features']} times")
    del ds, x_d, y_d
    # (iii) a CSR dataset: its SparseBinned built once across two fits
    xs, ys = hashed_text_rows(seed + 1, 2 * SMALL_FIT_ROWS, HASHED_SMALL_BITS)
    xs, ys = xs[:SMALL_FIT_ROWS], ys[:SMALL_FIT_ROWS]
    builds = {"dataset": 0, "train": 0}
    made = {key: mod.build_sparse_binned for key, mod in
            (("dataset", dataset_mod), ("train", boost_mod))}

    def counted(key):
        def build(*a, **k):
            builds[key] += 1
            return made[key](*a, **k)
        return build

    csr_params = dict(FITS["hashed_text"][2], objective="binary", num_iterations=3)
    ds_csr = GBDTDataset(xs, label=ys)
    ds_cpu = GBDTDataset(xs, label=ys, device="cpu")
    dataset_mod.build_sparse_binned = counted("dataset")
    boost_mod.build_sparse_binned = counted("train")
    try:
        csr_fits = [train(p, ds_csr) for p in
                    (csr_params, dict(csr_params, num_leaves=15, learning_rate=0.05))]
        torch.cuda.synchronize()
        sb_builds = dict(builds)
    finally:
        dataset_mod.build_sparse_binned = made["dataset"]
        boost_mod.build_sparse_binned = made["train"]
    if sb_builds != {"dataset": 1, "train": 0}:
        fail(f"two fits over one CSR GBDTDataset built its SparseBinned {sb_builds}, "
             "not once, by the dataset")
    for p, b in zip((csr_params, dict(csr_params, num_leaves=15, learning_rate=0.05)),
                    csr_fits):
        for other, what in ((train(p, ds_cpu), "the CPU dataset fit"),
                            (train(p, xs, ys), "train(params, csr)")):
            diff = same_booster(b, other)
            if diff:
                fail(f"the CSR GBDTDataset fit's {diff} differs from {what}'s")
    rec = {"phase": "gbdt_dataset", "rows": len(y_tr), "features": x_tr.shape[1],
           **{k: v for k, v in params.items()}, "build_s": build_s,
           "build_launches": build_l, "d_ms_in_build": d_ms,
           "reused_fit_s": {k: v["fit_s"] for k, v in fits.items()},
           "reused_fit_launches": {k: v["launches"] for k, v in fits.items()},
           "phase2_estimator_fit_s": main_fit_s, "raw_matrix_train_s": raw_fit_s,
           "identical_to_raw_matrix_fit": True, "continued_fit_s": cont_s,
           "continued_fit_launches": cont_l, "continuation_identical": True,
           "csr_rows": SMALL_FIT_ROWS, "csr_bits": HASHED_SMALL_BITS, "csr_nnz": xs.nnz,
           "csr_sparse_binned_builds": sb_builds, "csr_identical_card_cpu_raw": True}
    log(json.dumps(rec))
    return rec


def train_classifier_phase(kernels, seed, split_steps) -> dict:
    """Phase 2h (iv) (see the module's doc): ``TrainClassifier`` ->
    transform -> ``ComputeModelStatistics`` at the Adult Census schema with
    string columns, the user path of SynapseML's Adult Census notebook."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.featurize import Featurize
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
    from synapseml_tpu_torch.tools.schema_data import ADULT_INCOME, adult_columns, adult_rows
    from synapseml_tpu_torch.train import ComputeModelStatistics, TrainClassifier

    learner = dict(num_iterations=10, num_leaves=31)
    n_tr, n_te = N_TC_TRAIN, N_TC_TEST
    t0 = time.perf_counter()
    x, y, _ = adult_rows(seed, n_tr + n_te)
    cols = adult_columns(x, y)
    del x, y
    train_t = Table({k: v[:n_tr] for k, v in cols.items()})
    test_t = Table({k: v[n_tr:] for k, v in cols.items()})
    y_te = (cols["income"][n_tr:] == ADULT_INCOME[1]).astype(np.float64)
    data_s = time.perf_counter() - t0
    tc = TrainClassifier(model=LightGBMClassifier(**learner), label_col="income")
    reset(kernels)
    t0 = time.perf_counter()
    model = tc.fit(train_t)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_l = counts(kernels)
    reset(kernels)
    t0 = time.perf_counter()
    out = model.transform(test_t)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    trans_l = counts(kernels)
    steps = split_steps(learner)
    if fit_l["gbdt_bin_features"] < 1 or fit_l["gbdt_split_search"] != steps:
        fail(f"TrainClassifier's fit launched D {fit_l['gbdt_bin_features']} and E "
             f"{fit_l['gbdt_split_search']} times (E once a split step: {steps})")
    for k in ("gbdt_bin_features", "gbdt_tree_score"):
        if trans_l[k] < 1:
            fail(f"TrainClassifier's transform never launched {k}")
    # Featurize's host share: its fit and transform again, on their own
    feat_cols = [c for c in cols if c != "income"]
    t0 = time.perf_counter()
    Featurize(input_cols=feat_cols, output_col="features",
              num_features=tc.number_of_features).fit(train_t)
    feat_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    width = model.featurizer.transform(train_t)["features"].shape[1]
    feat_train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.featurizer.transform(test_t)
    feat_test_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = ComputeModelStatistics(label_col="income",
                                   evaluation_metric="classification").transform(out)
    stats_s = time.perf_counter() - t0
    prob = np.asarray(out["probability"])
    if prob.shape != (n_te, 2) or not np.isfinite(prob).all():
        fail(f"TrainClassifier's probabilities: shape {prob.shape}")
    stats_auc = float(stats["AUC"][0])
    np_auc = stable_rank_auc(y_te, prob[:, 1])
    if not stats_auc > ADULT_AUC_FLOOR:
        fail(f"TrainClassifier's held-out AUC {stats_auc:.4f} <= {ADULT_AUC_FLOOR}")
    if not abs(stats_auc - np_auc) <= 1e-6:
        fail(f"ComputeModelStatistics' AUC {stats_auc} differs from the numpy AUC {np_auc}")
    # a 16,384-row TrainClassifier fit on the card and the CPU
    small = Table({k: v[:SMALL_FIT_ROWS] for k, v in cols.items()})
    small_learner = dict(learner, num_iterations=3)
    card = TrainClassifier(model=LightGBMClassifier(**small_learner),
                           label_col="income").fit(small)
    cpu = TrainClassifier(model=LightGBMClassifier(device="cpu", **small_learner),
                          label_col="income").fit(small)
    diff = same_booster(card.inner_model.booster, cpu.inner_model.booster)
    if diff:
        fail(f"the small TrainClassifier fit's {diff} differs between the card and the CPU")
    rec = {"phase": "train_classifier_adult", "rows_train": n_tr, "rows_test": n_te,
           "columns": len(feat_cols), "string_columns": sum(
               1 for c in feat_cols if cols[c].dtype == object),
           "featurized_width": int(width), **learner, "data_s": data_s, "fit_s": fit_s,
           "transform_s": transform_s, "featurize_fit_s": feat_fit_s,
           "featurize_transform_train_s": feat_train_s,
           "featurize_transform_test_s": feat_test_s,
           "featurize_share_of_fit": (feat_fit_s + feat_train_s) / fit_s,
           "featurize_share_of_transform": feat_test_s / transform_s,
           "statistics_s": stats_s, "fit_launches": fit_l, "transform_launches": trans_l,
           "stats": {c: float(stats[c][0]) for c in stats.column_names},
           "numpy_auc": np_auc, "tie_mean_rank_auc": auc(y_te, prob[:, 1]),
           "auc_floor": ADULT_AUC_FLOOR, "small_fit_rows": SMALL_FIT_ROWS,
           "small_fit_identical_card_cpu": True}
    log(json.dumps(rec))
    return rec


def trace_hashed_fits(hashed) -> dict:
    """G's and E's device ms, G's device kernels a call (and each kernel's
    ms) and the launches a split step in a traced ``train`` of phase 2g's
    rows, the shipped half pass and the full-pass oracle. Fails unless
    each of G's G_KERNELS_A_CALL device kernels ran once a call. Run last of the
    script's traces: a trace of a whole fit is the largest the script
    takes."""
    from synapseml_tpu_torch.gbdt.boost import train
    from synapseml_tpu_torch.gbdt.sparse import SPARSE_HIST_TRACE
    from synapseml_tpu_torch.tools.kernel_cases import full_pass

    rec, params = hashed["record"], hashed["fit_params"]
    calls, steps = rec["g_calls"], rec["split_steps"]
    out = {"phase": "gbdt_hashed_text_traced", "rows_train": rec["rows_train"]}
    for path, ctx in (("half_pass", contextlib.nullcontext), ("full_pass", full_pass)):
        with ctx():
            k = kernel_times(lambda: train(params, hashed["x_tr"], hashed["y_tr"]),
                             (SPARSE_HIST_TRACE, ("split_kernel",), (), *G_KERNEL_NAMES))
        per_call = k[SPARSE_HIST_TRACE][1] / calls
        each = {key[0]: k[key][1] for key in G_KERNEL_NAMES}
        if per_call != G_KERNELS_A_CALL or any(c != calls for c in each.values()):
            fail(f"the traced {path} fit ran {k[SPARSE_HIST_TRACE][1]} of G's device "
                 f"kernels over {calls} calls ({each}), not each of its "
                 f"{G_KERNELS_A_CALL} once a call")
        out[path] = {"g_device_ms_a_fit": k[SPARSE_HIST_TRACE][0],
                     "g_device_ms_a_call": k[SPARSE_HIST_TRACE][0] / calls,
                     "g_device_kernels": k[SPARSE_HIST_TRACE][1],
                     "g_device_kernels_a_call": per_call,
                     "g_kernel_ms_a_fit": {key[0]: k[key][0] for key in G_KERNEL_NAMES},
                     "g_kernel_launches_a_fit": each,
                     "e_device_ms_a_fit": k[("split_kernel",)][0],
                     "device_busy_ms": k[()][0],
                     "launches_per_split_step": k[()][1] / steps}
    log(json.dumps(out))
    return out


def g_bytes(sb, side, ctrl_v) -> tuple:
    """(the bytes a G call must move, whatever path it takes; the bytes the
    cell-sorted stream moves, 8 B for every entry in place of the summed
    side's): see ``sparse_hist_checks``."""
    from synapseml_tpu_torch.gbdt.sparse import g_summed_entries, g_summed_sides

    half = ctrl_v[0]
    members = torch.nonzero((side == 0) | (side == 1))[:, 0]
    out_cells = sb.d * sb.n_bins * 12
    common = (4 * sb.n + gathered_bytes(members, 16, 0, 12) + 4 * sb.d + 2 * out_cells + 24
              + (out_cells if half else 0))
    sides = g_summed_sides(side, ctrl_v)
    summed = torch.nonzero((side == sides[0]) | (side == sides[-1]))[:, 0]
    return (common + 4 * g_summed_entries(sb, side, ctrl_v) + gathered_bytes(summed, 8, 0, 16),
            common + 8 * sb.nnz)


def sparse_hist_checks(hashed, dev, gen) -> dict:
    """Phase 4's kernel G: first on the shared edge cases in every mode
    (bit-equal to the plain version and to the row walk's plain twin, on
    the path the CPU model ``g_path`` predicts; the cases must drive both
    paths), then at phase 2g's shape on the gradients of the fitted model's
    margins (pre-rounded), at each of ``gbdt_step_bench.sparse_splits``: bit-equal to both plain
    versions (the half passes' siblings equal to the both-sides pass where
    the kept histogram is the split leaf's), with the path the card chose,
    its wrapper's launches a call (1), ms a call (CUDA events) and the
    bound (G's device kernels a call are counted in the traced fits,
    ``trace_hashed_fits``). Bound: bytes, every row's side (4 B), the members'
    panel sectors (16 B a row, both sides: the totals), zero_bin, the (2,
    d, B, 3) output written (both slots) and, in half mode, the kept slot
    read, and the summed side's entries (4 B a cell, from the row-major
    view) and its rows' ``row_ptr`` sectors, whichever path the card takes
    (the function's floor; the stream's own traffic, 8 B for every entry,
    is ``stream_bytes``). The library call: ``torch.segment_reduce`` over
    the summed side's entries gathered in cell order (3 channels a side), the one PyTorch
    call for the same segment sums (no residual, empty cells not written);
    the gather's time is beside it. Returns G's kernel row."""
    from synapseml_tpu_torch.gbdt.boost import _preround
    from synapseml_tpu_torch.gbdt.sparse import (G_PATH_STREAM, G_PATH_WALK, SPARSE_HIST_KERNEL,
                                                 g_path, g_summed_entries,
                                                 g_summed_sides,
                                                 sparse_hist, sparse_hist_plain,
                                                 sparse_hist_rows_plain)
    from synapseml_tpu_torch.tools.gbdt_step_bench import sparse_splits
    from synapseml_tpu_torch.tools.kernel_cases import SPARSE_HIST_CASES, sparse_hist_case

    same = lambda a, b: bool(torch.equal(a.isnan(), b.isnan())
                             and torch.equal(a.nan_to_num(), b.nan_to_num()))
    path_name = {G_PATH_STREAM: "stream", G_PATH_WALK: "walk"}
    g_modes = {"both_sides": (0, 0, -1), "half_kept_slot1": (1, 1, -1),
               "forced_right": (1, 1, 1)}
    case_paths = {}
    for case in SPARSE_HIST_CASES:
        sb_c, panel_c, side_c, kept_c = sparse_hist_case(case, dev)
        kept_c.copy_(_preround(torch.randn(kept_c.numel(), 1, generator=gen, device=dev),
                               1 << 20).view_as(kept_c))
        for mode, ctrl_v in g_modes.items():
            ctrl_c = torch.tensor(ctrl_v, dtype=torch.int32, device=dev)
            par = kept_c if ctrl_v[0] and ctrl_v[2] < 0 else None
            runs = []
            for fn in (sparse_hist, sparse_hist_plain, sparse_hist_rows_plain):
                runs.append([torch.full((2, sb_c.d, sb_c.n_bins, 3), float("nan"), device=dev),
                             torch.full((2, 3), float("nan"), device=dev)])
                fn(sb_c, panel_c, side_c, *runs[-1], ctrl_c, par)
                if fn is sparse_hist:
                    path = int(sb_c.plan.state[1])
            if not all(same(a, b) for run in (runs[0], runs[2]) for a, b in zip(run, runs[1])):
                fail(f"sparse histogram kernel ({case}, {mode}) differs from the plain version")
            if path != g_path(g_summed_entries(sb_c, side_c, ctrl_v), sb_c.nnz):
                fail(f"kernel G took the {path_name[path]} path on ({case}, {mode}), not the "
                     f"CPU model's")
            case_paths[f"{case}/{mode}"] = path_name[path]
        del sb_c, panel_c, side_c, kept_c
    if set(case_paths.values()) != set(path_name.values()):
        fail(f"kernel G's edge cases took only {set(case_paths.values())}")
    hb = hashed["booster"]
    sb, panel_h = hashed_panel(hashed, dev)
    n_h, nnz_h = sb.n, sb.nnz
    shape_h = (2, sb.d, sb.n_bins, 3)
    both_ctrl = torch.tensor([0, 0, -1], dtype=torch.int32, device=dev)
    rows_l = sb.rows.long()
    shapes = {}
    both = {}
    for name, (side_h, ctrl_v, kept_leaf) in sparse_splits(sb, hb, 7, SMALL_LEAVES).items():
        ctrl_h = torch.tensor(ctrl_v, dtype=torch.int32, device=dev)
        par = None
        if kept_leaf is not None:  # slot 0: the split leaf's histogram
            par, tot_k = torch.empty(shape_h, device=dev), torch.empty(2, 3, device=dev)
            sparse_hist(sb, panel_h, torch.where(kept_leaf, 0, 2).to(torch.int32), par, tot_k,
                        both_ctrl)
        out_k, out_p, out_r = (torch.empty(shape_h, device=dev) for _ in range(3))
        tk, tp, tr = (torch.empty(2, 3, device=dev) for _ in range(3))
        before = SPARSE_HIST_KERNEL.launches
        sparse_hist(sb, panel_h, side_h, out_k, tk, ctrl_h, par)
        launches = SPARSE_HIST_KERNEL.launches - before
        if launches != 1:
            fail(f"kernel G's wrapper launched {launches} times for one call at {name}")
        path = int(sb.plan.state[1])
        _, plain_ms = timed_once(lambda: sparse_hist_plain(sb, panel_h, side_h, out_p, tp,
                                                           ctrl_h, par))
        _, rows_plain_ms = timed_once(lambda: sparse_hist_rows_plain(sb, panel_h, side_h, out_r,
                                                                     tr, ctrl_h, par))
        if not (same(out_k, out_p) and same(tk, tp) and same(out_r, out_p) and same(tr, tp)):
            fail(f"sparse histogram kernel ({name}) differs from the plain versions at the "
                 f"hashed-text shape")
        split = name.split("_")[0]
        if ctrl_v[0] == 0:
            both[split] = out_k.clone()
        elif split in both and not same(out_k, both[split]):
            fail(f"the half pass with the kept leaf ({name}) differs from the both-sides pass")
        del out_p, out_r
        ms = time_ms(lambda: sparse_hist(sb, panel_h, side_h, out_k, tk, ctrl_h, par), 20)
        n_bytes, stream_bytes = g_bytes(sb, side_h, ctrl_v)
        b = bound(n_bytes, 0, F32_FLOPS)
        # the library call: the summed side's entries in cell order, 3 channels a side
        summed_sides = g_summed_sides(side_h, ctrl_v)
        side_e = side_h[rows_l]

        def gather():
            sel = (side_e == summed_sides[0]) if len(summed_sides) == 1 else side_e <= 1
            cells_m, rows_m, s_m = sb.cells[sel], rows_l[sel], side_e[sel]
            p_m = panel_h[rows_m, :3]
            if len(summed_sides) == 2:
                p_m = torch.cat([p_m * (s_m == 0)[:, None], p_m * (s_m == 1)[:, None]], 1)
            return p_m, torch.unique_consecutive(cells_m, return_counts=True)[1]

        gather_ms = time_ms(gather, 3)
        p_m, lengths = gather()
        lib_ms = (time_ms(lambda: torch.segment_reduce(p_m, "sum", lengths=lengths, axis=0), 5)
                  if lengths.numel() else None)
        members = int(((side_h == 0) | (side_h == 1)).sum())
        shapes[name] = {"path": path_name[path], "launches_a_call": launches, "ms": ms,
                        "plain_ms": plain_ms,
                        "rows_plain_ms": rows_plain_ms, "bound_ms": b[0], "bound_by": b[1],
                        "bytes": n_bytes, "stream_bytes": stream_bytes, "library_ms": lib_ms,
                        "gather_ms": gather_ms,
                        "members": members, "summed_entries": g_summed_entries(sb, side_h, ctrl_v),
                        "ctrl": list(ctrl_v), "max_abs_err": 0.0}
        log(json.dumps({"sparse_hist": name, **shapes[name]}))
        del out_k, p_m, lengths, side_e
    if {r["path"] for r in shapes.values()} != set(path_name.values()):
        fail(f"kernel G took only the {[r['path'] for r in shapes.values()]} paths at the "
             f"hashed-text shape")
    main = shapes["root_both"]
    rec = {"ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound": (main["bound_ms"], main["bound_by"]), "library_ms": main["library_ms"],
           "shape": f"n={n_h} nnz={nnz_h} d={sb.d} B={sb.n_bins}, the first tree's root split, "
                    f"both sides",
           "shapes": shapes,
           "library_call": "torch.segment_reduce over the summed side's entries gathered in "
                           "cell order",
           "cases_bit_equal": list(SPARSE_HIST_CASES), "case_paths": case_paths,
           "launches_full_pass_fit": hashed["record"]["full_pass_fit_launches"]}
    log(json.dumps({"sparse_hist": rec}))
    return rec


def snapshot(part, node) -> list:
    """A copy of kernel P's whole state and the rows' leaves."""
    return [t.clone() for t in (part.ids, part._state, part.smaller_right, node)]


def restore(part, node, snap) -> None:
    for t, v in zip((part.ids, part._state, part.smaller_right, node), snap):
        t.copy_(v)


def same_split(pk, nk, pp, npl, leaves) -> bool:
    """Kernel P's state after a split against its plain version's: the same
    seg, side, small, smaller_right and node, and each of ``leaves`` the
    same rows as a set, read from the buffer each state names."""
    torch.cuda.synchronize()
    same = (torch.equal(pk._state[:pk.seg.numel() + pk.side.numel() + 3],
                        pp._state[:pp.seg.numel() + pp.side.numel() + 3])
            and torch.equal(pk.smaller_right, pp.smaller_right) and torch.equal(nk, npl))
    for leaf in leaves:
        same = same and torch.equal(torch.sort(pk.rows(leaf)).values,
                                    torch.sort(pp.rows(leaf)).values)
    return same


def leaf_splits(binned, n_bins, parent, feature, bin_, seed) -> dict:
    """Phase 4's splits for kernel P and A's row list: {name: (RowPartition,
    node, step s, choice, ok, in_set)}, the partition and the rows' leaves
    in the state just before the split. ``root``: the fitted tree's first
    split; ``deep``: its deepest split (the last among the deepest), after
    its earlier steps replayed through kernel P, so the leaf's ids lie
    scattered as the fit left them; ``rows_1024`` and ``rows_40``: a leaf of
    that many rows drawn at random, split on the root's feature and
    threshold (numeric splits: the HIGGS fit has no categorical feature)."""
    from synapseml_tpu_torch.gbdt.partition import RowPartition

    dev, n, L = binned.device, binned.shape[0], len(parent) + 1

    def step_args(s, leaf=None):
        ok = int(parent[s]) >= 0
        leaf = max(int(parent[s]), 0) if leaf is None else leaf
        return (torch.tensor([leaf, int(feature[s])], device=dev),
                torch.tensor([ok], device=dev),
                (torch.arange(n_bins, device=dev) <= int(bin_[s])) & ok)

    def fresh():
        part = RowPartition(n, L, dev)
        part.begin_tree()
        return part, torch.zeros(n, dtype=torch.int32, device=dev)

    depth, depths = [0] * L, []
    for s, p in enumerate(parent):
        p = int(p)
        depths.append(depth[p] if p >= 0 else -1)
        if p >= 0:
            depth[p] = depth[s + 1] = depth[p] + 1
    deep = max(range(len(parent)), key=lambda s: (depths[s], s))
    out = {"root": (*fresh(), 0, *step_args(0))}
    part, node = fresh()
    for s in range(deep):
        part.split(s, binned, node, *step_args(s))
    out["deep"] = (part, node, deep, *step_args(deep))
    gen = torch.Generator(device=dev).manual_seed(seed)
    for k in SMALL_LEAVES:  # leaf 0 the other n - k rows, leaf 1 the k listed
        part, node = fresh()
        part.ids[0] = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        part.seg[0, 1], part.seg[1, 0], part.seg[1, 1] = n - k, n - k, k
        node[part.ids[0, n - k:].long()] = 1
        out[f"rows_{k}"] = (part, node, 1, *step_args(0, leaf=1))
    return out


def special_cells(rng, shape, dev) -> torch.Tensor:
    """f32 values on a 1/8 grid with NaN, +-inf and -0.0 in some cells."""
    x = (rng.integers(-64, 64, size=shape) / 8).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.permutation(flat.size)[:12]
    flat[pick] = [np.nan] * 3 + [np.inf] * 3 + [-np.inf] * 3 + [-0.0] * 3
    return torch.from_numpy(x).to(dev)


def _grown_tree(booster, t: int, dev):
    """Tree ``t`` (class 0) of a booster as a ``GrownTree`` on ``dev``."""
    from synapseml_tpu_torch.gbdt.grow import GrownTree

    arr = lambda a: torch.from_numpy(np.ascontiguousarray(a[t, 0])).to(dev)
    return GrownTree(arr(booster.parent), arr(booster.feature), arr(booster.bin),
                     arr(booster.gain), arr(booster.leaf_value), arr(booster.leaf_hess), None)


# -- phase 2i: the mesh -------------------------------------------------------------

def _mesh_record(booster) -> dict:
    """The trees of a booster, as a rank sends them back."""
    return {f: getattr(booster, f) for f in ("parent", "feature", "bin", "cat_set",
                                             "leaf_value", "leaf_hess", "tree_scale",
                                             "base_score")}


def nccl_one_rank_phase(kernels, gbdt, train_table, main_booster, main_fit_s,
                        split_steps) -> dict:
    """Phase 2i (a): ``LightGBMClassifier(mesh=SpecLayout.build(data=1))``
    in a one-rank NCCL group at phase 2's rows and parameters: the trees of
    phase 2's booster; per split step kernel P's mesh entry and its pick
    once (the one-launch step never), and two all-reduces (the counts, the
    child); the launch and collective counts set to 0 just before the fit
    and read just after."""
    import torch.distributed as dist

    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.runtime.layout import SpecLayout

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        layout = SpecLayout.build(data=1)
        reset(kernels)
        collectives.reset_counts()
        t0 = time.perf_counter()
        model = LightGBMClassifier(mesh=layout, **gbdt).fit(train_table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches, coll = counts(kernels), collectives.counts()
    finally:
        dist.destroy_process_group()
    steps, T = split_steps(gbdt), gbdt["num_iterations"]
    differs = same_booster(model.booster, main_booster)
    rec = {"phase": "gbdt_mesh_nccl_one_rank", "layout": layout.describe(), **gbdt,
           "fit_s": fit_s, "main_path_fit_s": main_fit_s, "fit_launches": launches,
           "collectives": coll, "split_steps": steps, "same_trees_as_phase_2": not differs}
    log(json.dumps(rec))
    if differs:
        fail(f"the one-rank NCCL mesh fit's {differs} differs from phase 2's booster")
    want = {"gbdt_partition_mesh": steps, "gbdt_partition_pick": steps, "gbdt_partition": 0,
            "gbdt_split_search": steps, "gbdt_histogram_rows": steps, "gbdt_sibling": steps,
            "gbdt_histogram": T}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"the one-rank mesh fit launched {got}, not {want}")
    if coll != {"sum:data": T + 2 * steps, "max:data": 2 * T}:
        fail(f"the one-rank mesh fit made the collectives {coll}, not one root, the counts "
             f"and the child a split step and two pre-rounding maxes an iteration")
    return rec


def _two_rank_main(rank: int, store: str, seed: int, outbox) -> None:
    """A rank of phase 2i (b): ``cuda:0`` in a two-rank gloo world."""
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        # both ranks run on this host: gloo's pairs connect over the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        try:
            outbox.put((rank, True, _two_rank_fits(rank, seed)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the traceback goes back to the parent
        outbox.put((rank, False, traceback.format_exc()))


def _two_rank_fits(rank: int, seed: int) -> dict:
    """Phase 2i (b)'s fits on one rank (module docstring); rank 0 also fits
    the same rows without a mesh and scores the voting fit's held-out
    rows."""
    from synapseml_tpu_torch.gbdt.boost import train
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.runtime.layout import SpecLayout
    from synapseml_tpu_torch.tools.schema_data import (FITS, hashed_text_rows,
                                                       higgs_width_rows, mslr_rows)

    kernels = all_kernels()
    data_parallel = SpecLayout.build(data=2)
    feature_parallel = SpecLayout.build(data=1, model=2)
    x, y = higgs_width_rows(seed, N_MESH + N_MESH_TEST)
    x_te, y_te, x, y = x[N_MESH:], y[N_MESH:], x[:N_MESH], y[:N_MESH]
    higgs = dict(objective="binary", **FITS["higgs"][2])
    xh, yh = hashed_text_rows(seed + 2, MESH_HASHED_ROWS, HASHED_SMALL_BITS)
    hashed = dict(objective="binary", **FITS["hashed_text"][2])
    xr, yr, sizes = mslr_rows(seed, MESH_RANK_QUERIES, MESH_RANK_DOCS)
    ranker = dict(objective="lambdarank", **FITS["mslr"][2])
    fits = {"higgs_data2": (higgs, x, y, data_parallel, {}),
            "higgs_feature2": (higgs, x, y, feature_parallel, {}),
            "hashed_text_data2": (hashed, xh, yh, data_parallel, {}),
            "mslr_data2": (ranker, xr, yr, data_parallel, {"group": sizes}),
            "higgs_voting2": (dict(higgs, parallelism="voting_parallel", top_k=MESH_TOP_K),
                              x, y, data_parallel, {})}
    out = {}
    for name, (params, xs, ys, layout, kw) in fits.items():
        reset(kernels)
        collectives.reset_counts()
        t0 = time.perf_counter()
        b = train(params, xs, ys, mesh=layout, **kw)
        torch.cuda.synchronize()
        out[name] = {"trees": _mesh_record(b), "fit_s": time.perf_counter() - t0,
                     "launches": counts(kernels), "collectives": collectives.counts(),
                     "layout": layout.describe(), "rows": int(xs.shape[0]),
                     "split_steps": params["num_iterations"] * (params["num_leaves"] - 1),
                     "iterations": params["num_iterations"]}
        if rank == 0 and name != "higgs_voting2":
            t0 = time.perf_counter()
            single = train(params, xs, ys, **kw)
            torch.cuda.synchronize()
            out[name].update(single=_mesh_record(single),
                             single_fit_s=time.perf_counter() - t0)
        if rank == 0 and name == "higgs_voting2":
            out[name]["heldout_auc"] = auc(y_te, b.predict(x_te))
    return out


def two_ranks_one_card_phase(seed: int) -> dict:
    """Phase 2i (b): two processes on ``cuda:0`` in one gloo world (NCCL
    puts no two ranks on one card); gloo's all-reduce takes the CUDA
    tensors (a build that refuses them stops the phase with its error). The
    one run that drives the global smaller-side choice on the card."""
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="smt_mesh_")
    store = os.path.join(store_dir, "store")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_two_rank_main, args=(r, store, seed, outbox))
             for r in range(2)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            try:
                rank, ok, res = outbox.get(timeout=MESH_TIMEOUT_S)
            except Exception:
                fail(f"phase 2i: a rank gave no result in {MESH_TIMEOUT_S} s")
            (got.__setitem__(rank, res) if ok else errors.append(f"rank {rank}:\n{res}"))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        fail("phase 2i (b): a rank failed\n" + "\n".join(errors))
    wall_s = time.perf_counter() - t0
    fits = {}
    for name, r0 in got[0].items():
        trees = r0["trees"]
        for rank in (1,):
            differs = same_booster(_Trees(got[rank][name]["trees"]), _Trees(trees))
            if differs:
                fail(f"phase 2i {name}: rank {rank}'s {differs} differs from rank 0's")
        steps, T = r0["split_steps"], r0["iterations"]
        launches, coll = r0["launches"], r0["collectives"]
        rec = {"layout": r0["layout"], "rows": r0["rows"], "fit_s": r0["fit_s"],
               "fit_s_rank1": got[1][name]["fit_s"], "launches": launches,
               "launches_rank1": got[1][name]["launches"], "collectives": coll}
        if "single" in r0:
            differs = same_booster(_Trees(trees), _Trees(r0["single"]))
            if differs:
                fail(f"phase 2i {name}: the mesh fit's {differs} differs from the "
                     f"single-device fit of the same rows")
            rec.update(single_fit_s=r0["single_fit_s"], same_trees_as_single_device=True)
        if name.startswith("hashed"):
            want = {"gbdt_sparse_hist_mesh": steps, "gbdt_sparse_hist": T}
            want_coll = {"sum:data": T + 2 * steps, "max:data": 2 * T}
        elif name == "higgs_voting2":
            want = {"gbdt_partition": steps, "gbdt_partition_mesh": 0}
            want_coll = None
            rec["heldout_auc"] = r0["heldout_auc"]
            if not r0["heldout_auc"] > 0.9:
                fail(f"phase 2i voting: held-out AUC {r0['heldout_auc']:.4f} <= 0.9")
        else:
            want = {"gbdt_partition_mesh": steps, "gbdt_partition_pick": steps,
                    "gbdt_partition": 0}
            want_coll = ({"sum:data+model": T + steps, "sum:data": steps, "max:data": 2 * T}
                         if name == "higgs_feature2" else
                         {"sum:data": T + 2 * steps, "max:data": 2 * T})
        for rank in (0, 1):
            lr = got[rank][name]["launches"]
            if {k: lr[k] for k in want} != want:
                fail(f"phase 2i {name}: rank {rank} launched "
                     f"{ {k: lr[k] for k in want} }, not {want}")
        if want_coll is not None and coll != want_coll:
            fail(f"phase 2i {name}: collectives {coll}, not {want_coll}")
        fits[name] = rec
    rec = {"phase": "gbdt_mesh_two_ranks_one_card", "backend": "gloo", "wall_s": wall_s,
           "fits": fits}
    log(json.dumps(rec, default=float))
    return rec


class _Trees:
    """A rank's tree record with a booster's attribute names."""

    def __init__(self, d):
        self.__dict__.update(d)


def hashed_panel(hashed, dev):
    """(SparseBinned, (n, 4) panel) of phase 2g's training rows on ``dev``:
    the gradients of the fitted model's margins, pre-rounded, weight 1."""
    from synapseml_tpu_torch.gbdt.boost import _preround, _sigmoid
    from synapseml_tpu_torch.gbdt.sparse import build_sparse_binned

    hb, x_h, y_h = hashed["booster"], hashed["x_tr"], hashed["y_tr"]
    sb = build_sparse_binned(x_h, hb.mapper, dev)
    p_h = _sigmoid(hb._raw_of_csr(x_h, dev)[:, 0].float())
    y_hd = torch.from_numpy(y_h).to(dev, torch.float32)
    nb_h = 1 << (sb.n - 1).bit_length()
    g_h = _preround((p_h - y_hd)[:, None], nb_h)[:, 0]
    h_h = _preround((p_h * (1 - p_h))[:, None], nb_h)[:, 0]
    return sb, torch.stack([g_h, h_h, torch.ones_like(g_h), torch.zeros_like(g_h)],
                           1).contiguous()


def mesh_entry_rows(binned_tr, n_bins, lb, hashed, seed, dev) -> dict:
    """Phase 2i's kernel rows of the mesh's entries, on one card.

    P's mesh entry (routing and local counts) and its pick at phase 4's P
    splits (``leaf_splits``): bit-equal to their plain twins, and on one
    rank (the local counts are the global ones) equal to the one-launch
    step; device times from a trace of 20 launches (the state restored
    before each). Bounds: the mesh entry's are P's bytes (the ids read and
    written, the split feature's bins gathered, node written for the right
    rows, in sectors), the pick's the 56 bytes it reads and writes.
    Library: P's (a stable argsort of the side key); none for the pick.

    G's mesh use at phase 2g's shape on the fitted model's gradients, at
    the half splits of ``gbdt_step_bench.sparse_splits``: the side forced
    to the smaller one, no parent, bit-equal to the plain version (the
    summed slot and the totals), CUDA-event ms over 20 calls. Bound: G's
    bytes (``g_bytes``) less the kept slot it does not read and the slot it
    does not write. Library: ``torch.segment_reduce`` over the summed side's
    entries in cell order, as G's row."""
    from synapseml_tpu_torch.gbdt.partition import (PARTITION_PICK_TRACE, PARTITION_TRACE,
                                                    RowPartition, partition_plain, pick_plain)
    from synapseml_tpu_torch.gbdt.sparse import (SPARSE_HIST_MESH_KERNEL, g_summed_entries,
                                                 g_summed_sides, sparse_hist_mesh,
                                                 sparse_hist_plain)
    from synapseml_tpu_torch.tools.gbdt_step_bench import sparse_splits

    splits = leaf_splits(binned_tr, n_bins, lb.parent[0, 0], lb.feature[0, 0], lb.bin[0, 0],
                         seed)
    e_bin, n, d = binned_tr.element_size(), binned_tr.shape[0], binned_tr.shape[1]
    p_runs, pick_runs = {}, {}
    for key, (pk, nk, s, choice, ok_t, in_set) in splits.items():
        leaf, f = (int(v) for v in choice.tolist())
        snap = snapshot(pk, nk)
        leaf_ids = pk.rows(leaf).clone()
        pk.split(s, binned_tr, nk, choice, ok_t, in_set)  # the one-launch step: the oracle
        po, no = RowPartition(n, pk.num_leaves, dev), torch.empty_like(nk)
        restore(po, no, snapshot(pk, nk))
        restore(pk, nk, snap)
        pk.split(s, binned_tr, nk, choice, ok_t, in_set, mesh=True)
        local = pk.counts.clone()
        pk.pick(s, choice, ok_t)
        pp, npl = RowPartition(n, pk.num_leaves, dev), torch.empty_like(nk)
        restore(pp, npl, snap)
        partition_plain(pp, s, binned_tr, npl, choice, ok_t, in_set, mesh=True)
        plain_counts = pp.counts.clone()
        pick_plain(pp, s, choice, ok_t)
        if not (same_split(pk, nk, pp, npl, (leaf, s + 1)) and torch.equal(local, plain_counts)):
            fail(f"kernel P's mesh entry differs from its plain twin at the {key} split")
        if not same_split(pk, nk, po, no, (leaf, s + 1)):
            fail(f"kernel P's mesh entry and pick on one rank differ from the one-launch "
                 f"step at the {key} split")
        count = leaf_ids.numel()

        def mesh_step():
            restore(pk, nk, snap)
            pk.split(s, binned_tr, nk, choice, ok_t, in_set, mesh=True)

        mesh_ms = kernel_times(lambda: [mesh_step() for _ in range(20)],
                               (PARTITION_TRACE,))[PARTITION_TRACE][0] / 20
        pick_ms = kernel_times(lambda: [pk.pick(s, choice, ok_t) for _ in range(20)],
                               (PARTITION_PICK_TRACE,))[PARTITION_PICK_TRACE][0] / 20
        plain_ms = time_ms(lambda: (restore(pp, npl, snap), partition_plain(
            pp, s, binned_tr, npl, choice, ok_t, in_set, True)), 3)
        pick_plain_ms = time_ms(lambda: pick_plain(pp, s, choice, ok_t), 3)
        key_lr = (~in_set[binned_tr[leaf_ids.long(), f].to(torch.int64)]).to(torch.uint8)
        lib_ms = time_ms(lambda: torch.argsort(key_lr, stable=True), 5)
        p_bytes = (8 * count + gathered_bytes(leaf_ids, d * e_bin, f * e_bin, e_bin)
                   + gathered_bytes(pp.rows(s + 1), 4, 0, 4))
        p_runs[key] = {"rows_routed": count, "step": s, "left": int(local[0]),
                       "right": int(local[1]), "ms": mesh_ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bytes_moved": p_bytes,
                       **dict(zip(("bound_ms", "bound_by"), bound(p_bytes, 0, F32_FLOPS)))}
        pick_runs[key] = {"ms": pick_ms, "plain_ms": pick_plain_ms, "bytes_moved": PICK_BYTES,
                          **dict(zip(("bound_ms", "bound_by"), bound(PICK_BYTES, 0,
                                                                     F32_FLOPS)))}
        log(json.dumps({"partition_mesh": key, **p_runs[key], "pick": pick_runs[key]}))
        del po, no, pp, npl, leaf_ids, key_lr
    del splits

    sb, panel = hashed_panel(hashed, dev)
    same = lambda a, b: bool(torch.equal(a.isnan(), b.isnan())
                             and torch.equal(a.nan_to_num(), b.nan_to_num()))
    shape = (2, sb.d, sb.n_bins, 3)
    out_cells = sb.d * sb.n_bins * 12
    rows_l = sb.rows.long()
    g_runs = {}
    for name, (side, ctrl_v, _) in sparse_splits(sb, hashed["booster"], 7,
                                                 SMALL_LEAVES).items():
        if not ctrl_v[0]:
            continue
        forced = g_summed_sides(side, ctrl_v)[0]
        ctrl_m = (1, ctrl_v[1], forced)
        ctrl = torch.tensor(ctrl_m, dtype=torch.int32, device=dev)
        out, tot = torch.full(shape, float("nan"), device=dev), torch.empty(2, 3, device=dev)
        out_p, tot_p = torch.full(shape, float("nan"), device=dev), torch.empty(2, 3, device=dev)
        before = SPARSE_HIST_MESH_KERNEL.launches
        sparse_hist_mesh(sb, panel, side, out, tot, ctrl)
        torch.cuda.synchronize()
        if SPARSE_HIST_MESH_KERNEL.launches - before != 1:
            fail(f"kernel G's mesh use launched {SPARSE_HIST_MESH_KERNEL.launches - before} "
                 f"times for one call at {name}")
        _, plain_ms = timed_once(lambda: sparse_hist_plain(sb, panel, side, out_p, tot_p, ctrl))
        if not (same(out[forced], out_p[forced]) and same(tot, tot_p)
                and bool(out[1 - forced].isnan().all())):
            fail(f"kernel G's mesh use ({name}) differs from the plain version")
        ms = time_ms(lambda: sparse_hist_mesh(sb, panel, side, out, tot, ctrl), 20)
        n_bytes = g_bytes(sb, side, ctrl_m)[0] - 2 * out_cells
        side_e = side[rows_l]
        sel = side_e == forced
        p_m = panel[rows_l[sel], :3]
        lengths = torch.unique_consecutive(sb.cells[sel], return_counts=True)[1]
        lib_ms = (time_ms(lambda: torch.segment_reduce(p_m, "sum", lengths=lengths, axis=0), 5)
                  if lengths.numel() else None)
        g_runs[name] = {"forced_side": forced, "path": int(sb.plan.state[1]), "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": n_bytes,
                        "summed_entries": g_summed_entries(sb, side, ctrl_m),
                        **dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 0, F32_FLOPS)))}
        log(json.dumps({"sparse_hist_mesh": name, **g_runs[name]}))
        del out, out_p, side_e, p_m, lengths
    del sb, panel
    return {"partition": p_runs, "pick": pick_runs, "sparse": g_runs}


# -- phase 2j: the VW learner ---------------------------------------------------------

def vw_phase(kernels, hashed):
    """Phase 2j (a): ``VowpalWabbitClassifier`` fit on phase 2g's 1,048,576
    training reviews as a sparse column, transform of its 262,144 held-out
    reviews; kernel V once a batch a pass and nowhere else, the held-out
    AUC over VW_AUC_FLOOR; a 16,384-review fit on the card and the CPU with
    identical states (logistic, and squared with l2). Returns the record
    and the training reviews' (indices, values) column."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.tools.kernel_cases import pairs_column, vw_state_differs
    from synapseml_tpu_torch.vw.estimators import VowpalWabbitClassifier, VowpalWabbitRegressor

    x_tr, y_tr, x_te, y_te = hashed["x_tr"], hashed["y_tr"], hashed["x_te"], hashed["y_te"]
    t0 = time.perf_counter()
    col_tr, col_te = pairs_column(x_tr), pairs_column(x_te)
    pairs_s = time.perf_counter() - t0
    meta = {"features": {"type": "vw_sparse"}}
    train_table = Table({"features": col_tr, "label": y_tr}, meta=meta)
    test_table = Table({"features": col_te}, meta=meta)
    model, out, fit_s, transform_s, fit_l, trans_l = fit_and_transform(
        kernels, VowpalWabbitClassifier(**VW_PARAMS), train_table, test_table)
    batches = -(-len(y_tr) // VW_PARAMS["batch_size"])
    want = VW_PARAMS["num_passes"]
    others = {k: n for k, n in {**fit_l, **trans_l}.items() if n and k != "vw_step"}
    if fit_l["vw_step"] != want or trans_l["vw_step"] or others:
        fail(f"the VW fit launched kernel V {fit_l['vw_step']} times, not once a pass "
             f"({want}); the transform {trans_l['vw_step']} (scores on the host); other "
             f"kernels {others}")
    prob = np.asarray(out["probability"])[:, 1]
    if prob.shape != (len(y_te),) or not np.isfinite(prob).all():
        fail(f"VW probabilities: shape {prob.shape}, finite {np.isfinite(prob).all()}")
    heldout_auc = auc(y_te, prob)
    stats = model.performance_statistics
    rec = {"phase": "vw_hashed_text", **VW_PARAMS, "rows_train": len(y_tr),
           "rows_test": len(y_te), "pairs_s": pairs_s, "fit_s": fit_s,
           "transform_s": transform_s, "fit_rows_per_s": len(y_tr) / fit_s,
           "pad_examples_s": stats["pad_examples_s"],
           "pad_examples_share_of_fit": stats["pad_examples_s"] / fit_s,
           "learn_s": stats["learn_time_s"], "learn_seconds": stats["learn_seconds"],
           "heldout_auc": heldout_auc,
           "auc_floor": VW_AUC_FLOOR, "fit_launches": fit_l["vw_step"],
           "batches_a_pass": batches}
    if not heldout_auc > VW_AUC_FLOOR:
        log(json.dumps(rec))
        fail(f"VW held-out AUC {heldout_auc:.4f} <= {VW_AUC_FLOOR}")
    small = {}
    small_table = Table({"features": col_tr[:SMALL_FIT_ROWS], "label": y_tr[:SMALL_FIT_ROWS]},
                        meta=meta)
    for name, cls, extra in (("logistic", VowpalWabbitClassifier, {}),
                             ("squared_l2", VowpalWabbitRegressor, {"l2": VW_L2})):
        states, secs = {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            states[device] = cls(device=device, **VW_PARAMS, **extra).fit(small_table).state
            secs[device] = time.perf_counter() - t0
        differs = vw_state_differs(states["cuda"], states["cpu"])
        if differs:
            fail(f"VW {name} fit at {SMALL_FIT_ROWS} reviews: the card's {differs} differs "
                 f"from the CPU's")
        small[name] = {"card_s": secs["cuda"], "cpu_s": secs["cpu"], "identical_state": True}
    rec["small_fits"] = {"rows": SMALL_FIT_ROWS, **small}
    log(json.dumps(rec))
    return rec, col_tr


def vw_step_checks(col, labels, dev) -> dict:
    """Phase 2j (b): kernel V against its plain version over the first
    VW_STEP_BATCHES batches of phase 2j's training column ``col`` (labels
    0/1), each loss, the sparse and a dense regime, the pass launched whole
    (one launch, as the fit launches it) and batch by batch (one launch a
    batch): both bit-equal to the plain steps, each timed with CUDA events
    (a pass; the plain steps of a pass) beside its bound; a trace of each
    gives the device time a batch, and the host's clock the time to submit
    a pass."""
    from synapseml_tpu_torch.tools.kernel_cases import VW_REGIMES, vw_state_differs
    from synapseml_tpu_torch.vw.learner import (LOSSES, StepHyper, StepPlan, StepState,
                                                _Scratch, batch_step, batch_step_plain,
                                                pad_examples, step_batches)

    B, nb = VW_PARAMS["batch_size"], VW_STEP_BATCHES
    dim = 1 << VW_PARAMS["num_bits"]
    idx, val = pad_examples(col[:nb * B], VW_PARAMS["num_bits"])
    K = idx.shape[1]
    y01 = np.asarray(labels[:nb * B], np.float32)
    ys = {"pm1": torch.from_numpy(np.where(y01 > 0, 1.0, -1.0).astype(np.float32)),
          "raw": torch.from_numpy(y01)}
    bi = torch.from_numpy(idx).to(dev).view(nb, B, K)
    bv = torch.from_numpy(val).to(dev).view(nb, B, K)
    bw = torch.ones(nb, B, device=dev)
    plan = StepPlan(bi, bv, dim)
    sectors = [plan.sectors(j) for j in range(nb)]
    # the state's sectors a launch of the nb batches reads and writes once
    launch_sectors = plan.sectors(0, nb)
    longs = [u1 - plan.long_from[j] for j, (_, u1) in enumerate(plan.ranges)]
    fresh = lambda: StepState(np.zeros(dim, np.float32), np.full(dim, 1e-6, np.float32),
                              0.0, 1e-6, np.zeros(dim, np.float32), device=dev)
    rows = {}
    for loss in LOSSES:
        by = ys["pm1" if loss in ("logistic", "hinge") else "raw"].to(dev).view(nb, B)
        for regime in VW_STEP_REGIMES:
            l1, l2 = VW_REGIMES[regime]
            hp = StepHyper.make(loss, 0.5, l1, l2, 0.5)
            scratch = _Scratch(B, dim, dev)

            def whole(st):
                step_batches(st, bi, bv, by, bw, hp, plan, 0, nb, scratch)

            def by_batch(st):
                for j in range(nb):
                    batch_step(st, bi[j], bv[j], by[j], bw[j], hp, plan, j, scratch)

            def plain_pass(st):
                for j in range(nb):
                    batch_step_plain(st, bi[j], bv[j], by[j], bw[j], hp)

            plain = fresh()
            _, p_ms = timed_once(lambda: plain_pass(plain))
            row = {}
            for how, fn in (("whole", whole), ("by_batch", by_batch)):
                card = fresh()
                _, first_ms = timed_once(lambda: fn(card))
                differs = vw_state_differs(card.numpy(), plain.numpy())
                if differs:
                    fail(f"kernel V ({loss}, {regime}, launched {how}): the state's {differs} "
                         f"differs from the plain version's after {nb} batches")
                timed = fresh()
                ms = time_ms(lambda: fn(timed), 5)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(timed)
                host_us = (time.perf_counter() - t0) * 1e6
                # the tracer can miss a trace's first launches (it starts
                # behind the host), which is all of a short trace of whole
                # passes: the trace pauses on the host first and holds
                # VW_TRACED_PASSES passes, and a batch's device time is the
                # mean over the launches it holds
                for attempt in range(3):   # a trace that holds none of V's launches is retaken
                    traced_ms, events = kernel_times(
                        lambda: [time.sleep(0.05)] + [fn(timed) for _ in range(VW_TRACED_PASSES)],
                        V_KERNEL_NAMES)[V_KERNEL_NAMES[0]]
                    if events:
                        break
                    log(f"profiler: trace {attempt + 1} of 3 held no launch of vw_pass_kernel")
                per_launch = nb if how == "whole" else 1
                most = VW_TRACED_PASSES * nb // per_launch
                if not 0 < events <= most:
                    fail(f"kernel V ({loss}, {regime}, launched {how}): a trace of "
                         f"{VW_TRACED_PASSES} passes saw {events} launches of vw_pass_kernel "
                         f"(want 1 to {most})")
                row[how] = {"ms": ms, "first_pass_ms": first_ms, "us_a_batch": ms * 1e3 / nb,
                            "device_us_a_batch": traced_ms * 1e3 / events / per_launch,
                            "traced_launches": events, "host_us_to_submit_a_pass": host_us}
            # each batch's idx/val/y/weight read once; the union of the
            # batches' sectors of w, s and g2 read and written once (in a
            # dense regime w and g2 whole, and s's sectors)
            state = (2 * 32 * launch_sectors + 16 * dim if hp.dense
                     else 2 * 3 * 32 * launch_sectors)
            n_bytes = float(nb * (8 * B * K + 8 * B) + state)
            b = bound(n_bytes, 0, F32_FLOPS)
            rows[f"{loss}-{regime}"] = {"ms": row["whole"]["ms"], "plain_ms": p_ms,
                                        "bound_ms": b[0], "bound_by": b[1], "bytes": n_bytes,
                                        **row}
    rec = {"phase": "vw_step_checks", "batches": nb, "batch": B, "K": K, "slots": dim,
           "plan_entries": plan.entries, "mean_sectors": float(np.mean(sectors)),
           "launch_sectors": launch_sectors,
           "long_list": plan.long_list, "mean_long_lists": float(np.mean(longs)),
           "bit_equal": True, "steps": rows}
    log(json.dumps(rec))
    return rec


def vw_mesh_rows(col, labels):
    """(idx, val, y +-1) of phase 2j (c): the first VW_MESH_ROWS reviews of
    the training column ``col`` (labels 0/1)."""
    from synapseml_tpu_torch.vw.learner import pad_examples

    idx, val = pad_examples(col[:VW_MESH_ROWS], VW_PARAMS["num_bits"])
    y = np.where(np.asarray(labels[:VW_MESH_ROWS]) > 0, 1.0, -1.0).astype(np.float32)
    return idx, val, y


def vw_nccl_one_rank(kernels, idx, val, y) -> dict:
    """Phase 2j (c) first part: ``train_linear(mesh=SpecLayout.build(data=1))``
    in a one-rank NCCL group equals the single-device fit of the same rows
    on the card, with one sum and one max all-reduce a pass."""
    import torch.distributed as dist

    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.runtime.layout import SpecLayout
    from synapseml_tpu_torch.tools.kernel_cases import vw_state_differs
    from synapseml_tpu_torch.vw.learner import train_linear

    kw = dict(loss="logistic", **VW_PARAMS)
    single = train_linear(idx, val, y, **kw)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        layout = SpecLayout.build(data=1)
        reset(kernels)
        collectives.reset_counts()
        t0 = time.perf_counter()
        st = train_linear(idx, val, y, mesh=layout, **kw)
        fit_s = time.perf_counter() - t0
        launches, coll = counts(kernels)["vw_step"], collectives.counts()
    finally:
        dist.destroy_process_group()
    P = VW_PARAMS["num_passes"]
    want = P  # once a pass
    differs = vw_state_differs(st, single)
    rec = {"phase": "vw_mesh_nccl_one_rank", "rows": len(y), "fit_s": fit_s,
           "launches": launches, "collectives": coll, "same_state_as_single_device": not differs}
    log(json.dumps(rec))
    if differs:
        fail(f"the one-rank NCCL VW fit's {differs} differs from the single-device fit")
    if launches != want or coll != {"sum:data": P, "max:data": P}:
        fail(f"the one-rank NCCL VW fit launched kernel V {launches} times (want {want}) and "
             f"made the collectives {coll}")
    return rec


def _vw_rank_main(rank: int, store: str, rows, outbox) -> None:
    """A rank of phase 2j (c): ``cuda:0`` in a two-rank gloo world."""
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        try:
            outbox.put((rank, True, _vw_rank_fits(*rows)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the traceback goes back to the parent
        outbox.put((rank, False, traceback.format_exc()))


def _vw_rank_fits(idx, val, y) -> dict:
    """Phase 2j (c)'s fits on one rank: data=2; (data=1, fsdp=2) and its
    replicated twin (data=1, model=2)."""
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.runtime.layout import SpecLayout
    from synapseml_tpu_torch.vw.learner import train_linear

    kernels = all_kernels()
    layouts = {"data2": SpecLayout.build(data=2), "fsdp2": SpecLayout.build(data=1, fsdp=2),
               "replicated2": SpecLayout.build(data=1, model=2)}
    out = {}
    for name, layout in layouts.items():
        reset(kernels)
        collectives.reset_counts()
        rec: dict = {}
        t0 = time.perf_counter()
        st = train_linear(idx, val, y, loss="logistic", mesh=layout, stats=rec, **VW_PARAMS)
        out[name] = {"state": st, "fit_s": time.perf_counter() - t0,
                     "launches": counts(kernels)["vw_step"],
                     "collectives": collectives.counts(), "at_rest_bytes": rec["at_rest_bytes"],
                     "layout": layout.describe()}
    return out


def vw_two_ranks_phase(rows) -> dict:
    """Phase 2j (c) second part: two processes on ``cuda:0`` in one gloo
    world. At data=2 every rank's state equals rank 0's, with one sum and
    one max all-reduce a pass; at (data=1, fsdp=2) the state is the
    replicated (data=1, model=2) fit's bit for bit, with one all-gather over
    fsdp a pass and at most half the vectors at rest."""
    import tempfile

    import torch.multiprocessing as mp

    from synapseml_tpu_torch.tools.kernel_cases import vw_state_differs

    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="smt_vw_mesh_")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_vw_rank_main,
                         args=(r, os.path.join(store_dir, "store"), rows, outbox))
             for r in range(2)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            try:
                rank, ok, res = outbox.get(timeout=MESH_TIMEOUT_S)
            except Exception:
                fail(f"phase 2j: a rank gave no result in {MESH_TIMEOUT_S} s")
            (got.__setitem__(rank, res) if ok else errors.append(f"rank {rank}:\n{res}"))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        fail("phase 2j (c): a rank failed\n" + "\n".join(errors))
    P = VW_PARAMS["num_passes"]
    n = len(rows[2])
    per_rank = -(-n // 2)
    batches = {"data2": -(-per_rank // VW_PARAMS["batch_size"]),
               "fsdp2": -(-n // VW_PARAMS["batch_size"])}
    batches["replicated2"] = batches["fsdp2"]
    fits = {}
    for name, r0 in got[0].items():
        for rank in (1,):
            differs = vw_state_differs(got[rank][name]["state"], r0["state"])
            if differs:
                fail(f"phase 2j {name}: rank {rank}'s {differs} differs from rank 0's")
        want_coll = {"sum:data": P, "max:data": P}
        if name == "fsdp2":
            want_coll["gather:fsdp"] = P
        for rank in (0, 1):
            g = got[rank][name]
            if g["launches"] != P or g["collectives"] != want_coll:
                fail(f"phase 2j {name}: rank {rank} launched kernel V {g['launches']} times "
                     f"(want {P}: once a pass), collectives {g['collectives']} (want "
                     f"{want_coll})")
        fits[name] = {k: r0[k] for k in ("fit_s", "launches", "collectives", "at_rest_bytes",
                                         "layout")}
    differs = vw_state_differs(got[0]["fsdp2"]["state"], got[0]["replicated2"]["state"])
    if differs:
        fail(f"phase 2j: the (data=1, fsdp=2) fit's {differs} differs from the replicated fit")
    full = 3 * (1 << VW_PARAMS["num_bits"]) * 4
    if not all(b <= full // 2 + 8 for b in fits["fsdp2"]["at_rest_bytes"]):
        fail(f"phase 2j: fsdp at-rest bytes {fits['fsdp2']['at_rest_bytes']} over half of "
             f"{full}")
    rec = {"phase": "vw_mesh_two_ranks_one_card", "backend": "gloo", "rows": n,
           "wall_s": time.perf_counter() - t0, "fsdp_equals_replicated": True, "fits": fits}
    log(json.dumps(rec))
    return rec


# -- phase 2k: the ONNX executor -----------------------------------------------------------

ONNX_KERNELS = ("onnx_qmatmul", "onnx_qconv", "onnx_qconv_channels_last", "onnx_rnn_steps",
                "onnx_rnn_stepwise")


def _onnx_err(card: torch.Tensor, cpu: torch.Tensor, rows: bool) -> float:
    """max|card - cpu| over max|cpu| (f32), or the largest error relative to a
    row's norm (a row: the last axis; bf16 and quantized graphs)."""
    g, w = card.detach().cpu().double(), cpu.detach().cpu().double()
    if g.shape != w.shape:
        fail(f"onnx: card output {tuple(g.shape)} against CPU {tuple(w.shape)}")
    if not rows:
        return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)).max())


def _onnx_launches(kernels) -> dict:
    return {name: kernels[name].launches for name in ONNX_KERNELS}


def onnx_stage_run(kernels, name, model_bytes, feed, data, fetch, batch, policy, cpu_rows,
                   want_launches, float_bytes=None) -> dict:
    """One ``ONNXModel.transform`` over ``data`` on the card at ``batch`` rows a
    call, after a first call (one batch: it builds the plan and uploads the
    weights) and with the launch counts set to 0 just before the timed
    transform and read just after (they must be ``want_launches``); then
    the first ``cpu_rows`` rows against the port's CPU run. A float graph's
    rows do not depend on their batch, so they are read from the timed
    output; a quantized graph's DynamicQuantizeLinear takes its range over
    the whole batch, so the card and the CPU each run those rows as one
    batch, and the float graph it came from (``float_bytes``) gives the
    quantization's own error on them, for scale."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.onnx import ONNXModel, OnnxFunction

    stage = ONNXModel(model_bytes=model_bytes, feed_dict={feed: "x"},
                      fetch_dict={k: k for k in fetch}, batch_size=batch, dtype_policy=policy)
    t0 = time.perf_counter()
    stage.transform(Table({"x": data[:batch]}))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset(kernels)
    t0 = time.perf_counter()
    out = stage.transform(Table({"x": data}))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _onnx_launches(kernels)
    if launches != want_launches:
        fail(f"phase 2k {name}: launches {launches}, want {want_launches}")
    cpu = OnnxFunction(model_bytes, dtype_policy=policy, device="cpu")({feed: data[:cpu_rows]})
    quantized = float_bytes is not None
    if quantized:
        card = stage.fn({feed: data[:cpu_rows]})
        card = {k: card[k] for k in fetch}
    else:
        card = {k: torch.from_numpy(np.asarray(out[k][:cpu_rows])) for k in fetch}
    rows = policy == "bfloat16" or quantized
    errs = {k: _onnx_err(card[k], cpu[k], rows) for k in fetch}
    tol = ONNX_QUANT_TOL if quantized else ONNX_ROW_TOL if rows else ONNX_F32_TOL
    if quantized and not torch.equal(card["logits"].cpu().argmax(-1), cpu["logits"].argmax(-1)):
        fail(f"phase 2k {name}: the card's and the CPU's argmax differ")
    for k, e in errs.items():
        if not (e <= tol):
            fail(f"phase 2k {name}: {k} differs from the CPU run by {e} > {tol}")
        if not np.isfinite(np.asarray(out[k], np.float64)).all():
            fail(f"phase 2k {name}: {k} is not finite")
    rec = {"phase": "onnx", "model": name, "dtype_policy": policy, "rows": len(data),
           "batch": batch, "first_batch_s": first_s, "wall_s": wall_s,
           "rows_per_s": len(data) / wall_s, "launches": launches,
           "cpu_rows_checked": cpu_rows, "err_vs_cpu": errs,
           "tolerance": {"kind": "row norm" if rows else "max-abs", "value": tol},
           "shapes": {k: list(np.asarray(out[k]).shape) for k in fetch}}
    if quantized:
        # kernel Q's device kernels in a trace of one batch: the wgmma / TMA
        # design (qgemm_kernel<..>), by name, with their launches and ms
        x_b = torch.from_numpy(np.asarray(data[:batch])).to(stage.fn.device)
        evts = _device_events(lambda: stage.fn({feed: x_b}))
        from synapseml_tpu_torch.tools.profile_fit import _device_us

        q_evts = {e.key: {"launches": e.count, "device_ms": _device_us(e) / 1e3}
                  for e in evts if "qgemm_kernel" in e.key}
        if not q_evts:
            fail(f"phase 2k {name}: no qgemm_kernel in the trace of a batch")
        rec["traced_q_kernels"] = q_evts
        ref = OnnxFunction(float_bytes, device="cpu")({feed: data[:cpu_rows]})
        rec["quantized_vs_float_on_cpu"] = {k: _onnx_err(cpu[k], ref[k], True) for k in fetch}
    log(json.dumps(rec))
    return rec


def onnx_rnn_run(kernels, name, model_bytes, x, policy, entry="onnx_rnn_steps") -> dict:
    """An LSTM / GRU graph through ``OnnxFunction`` on the card (kernel R, one
    launch a call of ``entry``: the persistent one, or the one-launch-a-step
    one at a width whose R it cannot hold), timed after a first call,
    against the port's CPU run."""
    from synapseml_tpu_torch.onnx import OnnxFunction

    fn = OnnxFunction(model_bytes, dtype_policy=policy)
    fn({"x": x})
    reset(kernels)
    t0 = time.perf_counter()
    card = fn({"x": x})
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _onnx_launches(kernels)
    if launches != {**{k: 0 for k in ONNX_KERNELS}, entry: 1}:
        fail(f"phase 2k {name} ({policy}): launches {launches}, want {entry} once")
    cpu = OnnxFunction(model_bytes, dtype_policy=policy, device="cpu")({"x": x})
    rows = policy == "bfloat16"
    errs = {k: _onnx_err(card[k], cpu[k], rows) for k in cpu}
    tol = ONNX_ROW_TOL if rows else ONNX_F32_TOL
    if not all(e <= tol for e in errs.values()):
        fail(f"phase 2k {name} ({policy}): outputs differ from the CPU run: {errs} > {tol}")
    rec = {"phase": "onnx_rnn", "graph": name, "dtype_policy": policy,
           "S_B_I_H": list(x.shape) + [x.shape[-1]], "wall_s": wall_s,
           "launches": launches, "err_vs_cpu": errs}
    log(json.dumps(rec))
    return rec


def onnx_phase(kernels, seed: int) -> dict:
    """Phase 2k (see the module's doc). Returns the runs' records and the
    launch counts phase 4 reports."""
    from synapseml_tpu_torch.models.zoo import bert_encoder, resnet
    from synapseml_tpu_torch.onnx.wire import serialize_model
    from synapseml_tpu_torch.tools.onnx_graphs import (quantize_dynamic_graph,
                                                       quantized_node_counts, recurrent_graph)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((N_ONNX_IMAGES, 3, 224, 224), dtype=np.float32)
    ids = rng.integers(0, BERT_VOCAB, size=(N_ONNX_SEQS, ONNX_SEQ_LEN))
    none = {k: 0 for k in ONNX_KERNELS}
    runs = {}
    r50 = resnet(50, seed=seed)
    r50_bytes = serialize_model(r50)
    for policy in ("float32", "bfloat16"):
        runs[f"resnet50_{policy}"] = onnx_stage_run(
            kernels, "ResNet-50", r50_bytes, "data", images, ("logits", "features"),
            ONNX_IMAGE_BATCH, policy, ONNX_CPU_IMAGES, none)
    if runs["resnet50_float32"]["shapes"]["features"] != [N_ONNX_IMAGES, 2048]:
        fail(f"phase 2k: ResNet-50 features {runs['resnet50_float32']['shapes']['features']}")
    bert = bert_encoder(seed=seed)
    bert_bytes = serialize_model(bert)
    runs["bert_base_bfloat16"] = onnx_stage_run(
        kernels, "BERT-base", bert_bytes, "input_ids", ids, ("logits", "pooled"),
        ONNX_SEQ_BATCH, "bfloat16", ONNX_CPU_SEQS, none)
    # the quantized graphs: kernel Q's entries launch once a rewritten node a batch
    qbert = quantize_dynamic_graph(bert)
    del bert
    n_mm = quantized_node_counts(qbert)["MatMulInteger"]
    runs["bert_base_quantized"] = onnx_stage_run(
        kernels, "BERT-base quantize_dynamic", serialize_model(qbert), "input_ids", ids,
        ("logits", "pooled"), ONNX_SEQ_BATCH, "float32", QUANT_CPU_SEQS,
        {**none, "onnx_qmatmul": n_mm * (N_ONNX_SEQS // ONNX_SEQ_BATCH)}, float_bytes=bert_bytes)
    del qbert, bert_bytes
    qr50 = quantize_dynamic_graph(r50)
    n_conv = quantized_node_counts(qr50)["ConvInteger"]
    if n_conv != 53:
        fail(f"phase 2k: quantized ResNet-50 has {n_conv} ConvInteger nodes, not 53")
    runs["resnet50_quantized"] = onnx_stage_run(
        kernels, "ResNet-50 quantize_dynamic", serialize_model(qr50), "data",
        images[:N_QUANT_IMAGES], ("logits", "features"), ONNX_IMAGE_BATCH, "float32",
        QUANT_CPU_IMAGES, {**none, "onnx_qconv": n_conv * (N_QUANT_IMAGES // ONNX_IMAGE_BATCH),
                           "onnx_qconv_channels_last":
                               n_conv * (N_QUANT_IMAGES // ONNX_IMAGE_BATCH)},
        float_bytes=r50_bytes)
    del qr50, images
    # LSTM (peepholes) and GRU (linear_before_reset=0), and the configurations
    # cuDNN computes (phase 4's library time)
    S, B, H = RNN_GNMT
    x = rng.standard_normal((S, B, H), dtype=np.float32)
    graphs = {"lstm_peepholes": recurrent_graph("LSTM", S, B, H, H, seed=seed, peepholes=True),
              "gru_lbr0": recurrent_graph("GRU", S, B, H, H, seed=seed, linear_before_reset=0),
              "lstm_cudnn_config": recurrent_graph("LSTM", S, B, H, H, seed=seed),
              "gru_lbr1": recurrent_graph("GRU", S, B, H, H, seed=seed, linear_before_reset=1)}
    for gname, g in graphs.items():
        mb = serialize_model(g)
        for policy in ("float32", "bfloat16"):
            runs[f"{gname}_{policy}"] = onnx_rnn_run(kernels, gname, mb, x, policy)
    # a width past the persistent entry's reach: the one-launch-a-step entry
    Sw, Bw, Hw = RNN_STEPWISE
    xw = rng.standard_normal((Sw, Bw, Hw), dtype=np.float32)
    runs["lstm_wide_stepwise_float32"] = onnx_rnn_run(
        kernels, "lstm_wide_stepwise", serialize_model(recurrent_graph("LSTM", Sw, Bw, Hw, Hw,
                                                                       seed=seed)),
        xw, "float32", entry="onnx_rnn_stepwise")
    rnn_launches = {k: sum(r["launches"][k] for n, r in runs.items()
                           if n.startswith(("lstm", "gru")))
                    for k in ("onnx_rnn_steps", "onnx_rnn_stepwise")}
    rec = {"phase": "onnx_summary", "phase_s": time.perf_counter() - t_phase,
           "images_per_s": {p: runs[f"resnet50_{p}"]["rows_per_s"]
                            for p in ("float32", "bfloat16")},
           "bert_base_bf16_sequences_per_s": runs["bert_base_bfloat16"]["rows_per_s"],
           "quantized_rows_per_s": {"bert_base": runs["bert_base_quantized"]["rows_per_s"],
                                    "resnet50": runs["resnet50_quantized"]["rows_per_s"]},
           "first_design_quantized_rows_per_s": FIRST_DESIGN_QUANT_ROWS_PER_S,
           "rnn_graph_ms": {n: r["wall_s"] * 1e3 for n, r in runs.items()
                            if n.startswith(("lstm", "gru"))},
           "first_design_rnn_graph_ms_range": FIRST_DESIGN_RNN_GRAPH_MS}
    log(json.dumps(rec))
    return {"runs": runs, "launches": {
        "onnx_qmatmul": runs["bert_base_quantized"]["launches"]["onnx_qmatmul"],
        "onnx_qconv": runs["resnet50_quantized"]["launches"]["onnx_qconv"],
        "onnx_qconv_channels_last":
            runs["resnet50_quantized"]["launches"]["onnx_qconv_channels_last"],
        **rnn_launches}, "summary": rec}


# ResNet-50's convolutions a batch (the zoo's graph): the stem, per stage
# one of each first-block conv and (blocks - 1) of each later one
RESNET50_BLOCKS = (3, 4, 6, 3)


def _resnet50_conv_count(name: str) -> int:
    if name.startswith("stem"):
        return 1
    reps = RESNET50_BLOCKS[int(name[1])]
    if "_later_" in name:
        return reps - 1
    return reps if "_expand_" in name else 1


def onnx_kernel_rows(seed: int, dev) -> dict:
    """Phase 4's rows of kernels Q and R: each against its plain version at a
    main-path shape and timed with CUDA events beside its bound and, where
    one torch call computes the same function, that call's time.

    - Q's matmul entry at BERT-base's FFN-in projection (8,192 x 768 x
      3,072; uint8 activations with a zero point, int8 weights packed once,
      as the executor packs a weight), and the other two projections; also
      with the weight packed a call (a B computed in the graph: one more
      pass over B, counted in that bound); the plain version (int32 matmul)
      runs on the host's CPU (CUDA has no int32 matmul), timed by the
      host's clock; the library time is torch._int_mm's on int8 x int8
      without zero points (the only form it takes), beside the kernel's own
      time there;
    - Q's conv entry at ResNet-50's 3x3 of stage 0 at batch 128, and every
      ResNet-50 conv shape at batch 128 (the sum over a batch's 53 convs);
      the kernel's time includes the wrapper's channels-last copy of x,
      whose bytes are counted apart (``bytes_moved``); plain on the host's
      CPU; no torch call convolves integers on CUDA;
    - R at GNMT's width, the configuration cuDNN computes (an LSTM without
      peepholes, f32): the plain version (the step in torch ops) on the
      card, and cuDNN's LSTM layer (torch.nn.LSTM, input projection
      included) as the library time, beside R with the projection; the
      peephole LSTM, both GRU modes (GRU with linear_before_reset=1 beside
      torch.nn.GRU) and bf16 as further shapes, each on the persistent
      entry (one launch a call);
    - R's one-launch-a-step entry at RNN_STEPWISE (an LSTM whose R the
      persistent entry cannot hold), beside torch.nn.LSTM at that width."""
    from synapseml_tpu_torch.onnx import rnn as onnx_rnn
    from synapseml_tpu_torch.onnx.qgemm import (channels_last, channels_last_plain,
                                                pack_conv_w, pack_matmul_b, qconv, qconv_plain,
                                                qmatmul, qmatmul_plain)
    from synapseml_tpu_torch.onnx.rnn import (gru_steps, gru_steps_plain, lstm_steps,
                                              lstm_steps_plain)
    from synapseml_tpu_torch.tools.kernel_cases import (BERT_BASE_PROJECTIONS, RESNET50_CONVS,
                                                        rnn_step_case)

    gen = torch.Generator(device=dev).manual_seed(seed)
    u8 = lambda *shape: torch.randint(0, 256, shape, generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.uint8)
    s8 = lambda *shape: torch.randint(-127, 128, shape, generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.int8)
    rows = {}

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    # -- Q, matmul entry
    za = torch.tensor(117, dtype=torch.uint8, device=dev)
    shapes = {}
    for name, (M, K, N) in BERT_BASE_PROJECTIONS.items():
        a, b = u8(64, M // 64, K), s8(K, N)
        packed = pack_matmul_b(b)
        ms = time_ms(lambda: qmatmul(a, b, za, packed=packed), 20)
        bnd = bound(M * K + K * N + 4 * M * N, 2.0 * M * N * K, INT8_TC_OPS)
        entry = {"M_K_N": [M, K, N], "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                 "tops": 2.0 * M * N * K / ms / 1e9,
                 "ms_b_packed_a_call": time_ms(lambda: qmatmul(a, b, za), 20),
                 "bound_b_packed_a_call_ms": bound(M * K + 3 * K * N + 4 * M * N,
                                                   2.0 * M * N * K, INT8_TC_OPS)[0]}
        if name == "ffn1_768x3072":
            got = qmatmul(a, b, za, packed=packed).cpu()
            want, plain = host_ms(lambda: qmatmul_plain(a.cpu(), b.cpu(), za.cpu()))
            entry["max_abs_err"] = float((got.double() - want.double()).abs().max())
            entry["plain_ms"], entry["plain_device"] = plain, "cpu"
            # int8 x int8 without zero points: the one form torch._int_mm computes
            a8 = s8(M, K)
            k_ms = time_ms(lambda: qmatmul(a8, b, packed=packed), 20)
            lib_ms = time_ms(lambda: torch._int_mm(a8, b), 20)
            if not torch.equal(qmatmul(a8, b, packed=packed), torch._int_mm(a8, b)):
                fail("kernel Q (int8 x int8) differs from torch._int_mm")
            entry["int8_int8_no_zero_points"] = {
                "ms": k_ms, "ms_b_packed_a_call": time_ms(lambda: qmatmul(a8, b), 20),
                "torch_int_mm_ms": lib_ms}
            del a8
        shapes[name] = entry
        del a, b, packed
    main = shapes["ffn1_768x3072"]
    if main["max_abs_err"] != 0:
        fail(f"kernel Q (matmul) differs from its plain version by {main['max_abs_err']}")
    rows["onnx_qmatmul"] = dict(
        err=main["max_abs_err"], ms=main["ms"], plain_ms=main["plain_ms"],
        bound=(main["bound_ms"], main["bound_by"]), library_ms=None,
        extra={"shape": "BERT-base FFN-in: (64 x 128 tokens) x 768 uint8 with a zero point, "
                        "768 x 3,072 int8 packed once, int32 out",
               "plain_device": "cpu", "tops": main["tops"], "shapes": shapes})

    # -- Q, conv entry
    xz = torch.tensor(131, dtype=torch.uint8, device=dev)
    conv_shapes, batch_ms = {}, 0.0
    for name, c in RESNET50_CONVS.items():
        n_img = ONNX_IMAGE_BATCH
        x, w = u8(n_img, *c["x"][1:]), s8(*c["w"])
        st = c["attrs"].get("strides", [1, 1])
        p = c["attrs"].get("pads", [0, 0, 0, 0])
        pads = ((p[0], p[2]), (p[1], p[3]))
        packed = pack_conv_w(w)
        run = lambda: qconv(x, w, xz, None, st, pads, (1, 1), 1, packed=packed)
        ms = time_ms(run, 10)
        out = run()
        M, N = n_img * out.shape[2] * out.shape[3], out.shape[1]
        K = w.shape[1] * w.shape[2] * w.shape[3]
        bnd = bound(x.numel() + w.numel() + 4 * out.numel(), 2.0 * M * N * K, INT8_TC_OPS)
        x_cl = n_img * packed.cin_p * x.shape[2] * x.shape[3]
        entry = {"x": [n_img, *c["x"][1:]], "w": list(c["w"]), "strides": st, "ms": ms,
                 "bound_ms": bnd[0], "bound_by": bnd[1], "tops": 2.0 * M * N * K / ms / 1e9,
                 "convs_a_batch": _resnet50_conv_count(name),
                 "channels_last_ms": time_ms(lambda: channels_last(x, 1, packed.cin_p, xz), 10),
                 "bytes_moved": x.numel() + w.numel() + 4 * out.numel() + x.numel() + x_cl + x_cl}
        batch_ms += ms * entry["convs_a_batch"]
        if name == "s0_later_3x3":
            want, plain = host_ms(lambda: qconv_plain(x.cpu(), w.cpu(), xz.cpu(), None, st,
                                                      pads))
            entry["max_abs_err"] = float((out.cpu().double() - want.double()).abs().max())
            entry["plain_ms"] = plain
        conv_shapes[name] = entry
        del x, w, out, packed
    if sum(e["convs_a_batch"] for e in conv_shapes.values()) != 53:
        fail("phase 4: the ResNet-50 conv shapes do not count 53 convs a batch")
    main = conv_shapes["s0_later_3x3"]
    if main["max_abs_err"] != 0:
        fail(f"kernel Q (conv) differs from its plain version by {main['max_abs_err']}")
    rows["onnx_qconv"] = dict(
        err=main["max_abs_err"], ms=main["ms"], plain_ms=main["plain_ms"],
        bound=(main["bound_ms"], main["bound_by"]), library_ms=None,
        extra={"shape": "ResNet-50 stage-0 3x3 at batch 128: x (128, 64, 56, 56) uint8 with a "
                        "zero point, w (64, 64, 3, 3) int8 packed once, pad 1",
               "plain_device": "cpu", "tops": main["tops"],
               "bytes_moved": main["bytes_moved"], "channels_last_ms": main["channels_last_ms"],
               "ms_a_resnet50_batch_of_128": batch_ms, "shapes": conv_shapes})

    # -- Q, the conv entry's channels-last copy, at stage 0's widest input
    # (the later blocks' 1x1 reads 256 channels of 56 x 56)
    x = u8(ONNX_IMAGE_BATCH, 256, 56, 56)
    got, want = channels_last(x, 1, 256, xz), channels_last_plain(x, 1, 256, xz)
    if not torch.equal(got, want):
        fail("kernel Q's channels-last entry differs from its plain version")
    lib = lambda: x.contiguous(memory_format=torch.channels_last)
    if not torch.equal(lib().permute(0, 2, 3, 1).reshape(got.shape), got):
        fail("channels-last: the library call's layout differs from the entry's")
    rows["onnx_qconv_channels_last"] = dict(
        err=0.0, ms=time_ms(lambda: channels_last(x, 1, 256, xz), 10),
        plain_ms=time_ms(lambda: channels_last_plain(x, 1, 256, xz), 10),
        bound=bound(2 * x.numel(), 0, INT8_TC_OPS), library_ms=time_ms(lib, 10),
        extra={"shape": "x (128, 256, 56, 56) uint8 into (128, 1, 56, 56, 256)",
               "library": "x.contiguous(memory_format=torch.channels_last)"})
    del x, got, want

    # -- R
    def r_case(name, kind, lbr, dtype, peep, S, B, H, want_entry, library=False):
        c = rnn_step_case(kind, S, B, H, dtype, dev, seed=seed, peepholes=peep)
        if kind == "LSTM":
            run = lambda: lstm_steps(c["gx"], c["r"], c["h0"], c["c0"], c["p"])
            plain = lambda: lstm_steps_plain(c["gx"], c["r"], c["h0"], c["c0"], c["p"])
        else:
            run = lambda: gru_steps(c["gx"], c["r"], c["h0"], c["rb"], lbr)
            plain = lambda: gru_steps_plain(c["gx"], c["r"], c["h0"], c["rb"], lbr)
        before = {k.name: k.launches for k in (onnx_rnn.RNN_KERNEL, onnx_rnn.RNN_STEP_KERNEL)}
        got = run()
        torch.cuda.synchronize()
        served = [n for n, v in before.items() if all_launches()[n] > v]
        if served != [want_entry]:
            fail(f"kernel R {name}: served by {served}, want {want_entry}")
        want = plain()
        if dtype == torch.float32:
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            tol = 1e-5
        else:
            err = max(_onnx_err(g.float(), w.float(), True) for g, w in zip(got, want))
            tol = ONNX_ROW_TOL
        if not err <= tol:
            fail(f"kernel R {name}: {err} > {tol} from its plain version")
        g_ = 4 if kind == "LSTM" else 3
        esz = 4 if dtype == torch.float32 else 2
        n_bytes = esz * (S * B * g_ * H + g_ * H * H + 2 * B * H + S * B * H + B * H)
        bnd = bound(n_bytes, 2.0 * S * B * g_ * H * H,
                    F32_FLOPS if dtype == torch.float32 else BF16_TC_FLOPS)
        entry = {"kind": kind, "linear_before_reset": lbr, "dtype": str(dtype),
                 "S_B_H": [S, B, H], "peepholes": peep if kind == "LSTM" else None,
                 "max_err": err, "entry": want_entry,
                 "ms": time_ms(run, 5), "plain_ms": time_ms(plain, 2),
                 "bound_ms": bnd[0], "bound_by": bnd[1], "launches_a_call": 1,
                 "device_launches_a_call": 1 if want_entry == "onnx_rnn_steps" else
                 S * (2 if kind == "GRU" and not lbr else 1)}
        if kind == "LSTM" and not peep or kind == "GRU" and lbr or library:
            # cuDNN's layer (torch.nn.LSTM / GRU: PyTorch's GRU is ONNX's
            # linear_before_reset=1, the nearest library call to =0)
            # computes the input projection too: time R with the
            # projection beside it
            layer = (torch.nn.LSTM if kind == "LSTM" else torch.nn.GRU)(H, H).to(dev)
            xin = torch.randn(S, B, H, generator=gen, device=dev)
            w_ih, b_ih = layer.weight_ih_l0.detach(), layer.bias_ih_l0.detach()
            with torch.no_grad():
                entry["library_ms"] = time_ms(lambda: layer(xin), 5)

                def with_projection():
                    gx = torch.matmul(xin, w_ih.T) + b_ih
                    return (lstm_steps(gx, c["r"], c["h0"], c["c0"]) if kind == "LSTM"
                            else gru_steps(gx, c["r"], c["h0"], c["rb"], lbr))

                entry["ms_with_input_projection"] = time_ms(with_projection, 5)
            del layer, xin
        del c, got, want
        return entry

    kernel_objs = {k.name: k for k in (onnx_rnn.RNN_KERNEL, onnx_rnn.RNN_STEP_KERNEL)}
    all_launches = lambda: {n: k.launches for n, k in kernel_objs.items()}
    S, B, H = RNN_GNMT
    rshapes = {name: r_case(name, kind, lbr, dtype, peep, S, B, H, "onnx_rnn_steps")
               for name, kind, lbr, dtype, peep in (
                   ("lstm_cudnn_config_f32", "LSTM", 0, torch.float32, False),
                   ("lstm_peepholes_f32", "LSTM", 0, torch.float32, True),
                   ("lstm_peepholes_bf16", "LSTM", 0, torch.bfloat16, True),
                   ("gru_lbr0_f32", "GRU", 0, torch.float32, True),
                   ("gru_lbr0_bf16", "GRU", 0, torch.bfloat16, True),
                   ("gru_lbr1_f32", "GRU", 1, torch.float32, True))}
    main = rshapes["lstm_cudnn_config_f32"]
    gru = rshapes["gru_lbr1_f32"]
    rows["onnx_rnn_steps"] = dict(
        err=max(r["max_err"] for r in rshapes.values() if "float32" in r["dtype"]),
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound=(main["bound_ms"], main["bound_by"]), library_ms=main["library_ms"],
        extra={"shape": f"LSTM S={S} B={B} I=H={H} f32, no peepholes (a configuration cuDNN "
                        f"computes), all S steps in one persistent launch",
               "library": "torch.nn.LSTM on cuDNN, input projection included",
               "ms_with_input_projection": main["ms_with_input_projection"],
               "gru_lbr1": {"ms_with_input_projection": gru["ms_with_input_projection"],
                            "torch_nn_gru_ms": gru["library_ms"]},
               "shapes": rshapes})
    Sw, Bw, Hw = RNN_STEPWISE
    wide = r_case("lstm_wide_stepwise_f32", "LSTM", 0, torch.float32, False, Sw, Bw, Hw,
                  "onnx_rnn_stepwise")
    gru_wide = r_case("gru_lbr0_wide_stepwise_f32", "GRU", 0, torch.float32, True, Sw, Bw, Hw,
                      "onnx_rnn_stepwise", library=True)
    rows["onnx_rnn_stepwise"] = dict(
        err=max(wide["max_err"], gru_wide["max_err"]), ms=wide["ms"], plain_ms=wide["plain_ms"],
        bound=(wide["bound_ms"], wide["bound_by"]), library_ms=wide["library_ms"],
        extra={"shape": f"LSTM S={Sw} B={Bw} I=H={Hw} f32, no peepholes: R past the "
                        f"persistent entry's reach, one launch a step",
               "library": "torch.nn.LSTM on cuDNN, input projection included",
               "ms_with_input_projection": wide["ms_with_input_projection"],
               "device_launches_a_call": wide["device_launches_a_call"],
               "gru_lbr0": {key: gru_wide[key] for key in
                            ("max_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "ms_with_input_projection", "device_launches_a_call")}
               | {"torch_nn_gru_ms": gru_wide["library_ms"],
                  "library": "torch.nn.GRU on cuDNN (linear_before_reset=1), input "
                             "projection included"}})
    return rows


# -- phase 2l: sequence-parallel attention, tensor-parallel ONNX, topology ---------------

def _lse_err(lse: torch.Tensor, want: torch.Tensor) -> float:
    return float(((lse - want).abs() / want.abs().clamp(min=1.0)).max())


def lse_phase(gen, dev) -> dict:
    """Phase 2l (a): kernel C's lse entries at LSE_SHAPES (causal) against
    the plain version, their output bit-equal to the entry without lse;
    timed beside it and beside the library's attention that also returns
    the log-sum-exp. Returns each shape's record."""
    from synapseml_tpu_torch.parallel.flash import dense_attention, flash_attention, kernel_for

    aten = torch.ops.aten
    out = {}
    for key, (shape, dtype) in LSE_SHAPES.items():
        B, S_, H, H_kv, D = shape
        mk = lambda h: torch.randn(B, S_, h, D, generator=gen, device=dev).to(dtype)
        q, k, v = mk(H), mk(H_kv), mk(H_kv)
        o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        if not torch.equal(o, flash_attention(q, k, v, causal=True)):
            fail(f"phase 2l: the lse entry's output ({key}) differs from the entry without lse")
        (_, want), plain_ms = timed_once(lambda: dense_attention(
            q.float(), k.float(), v.float(), causal=True, return_lse=True))
        err = _lse_err(lse, want)
        del want
        if not err <= LSE_TOL:
            fail(f"phase 2l: kernel C's lse ({key}) is {err} from the plain version's "
                 f"(> {LSE_TOL})")
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True, return_lse=True), 10)
        ms_no_lse = time_ms(lambda: flash_attention(q, k, v, causal=True), 10)
        rep = H // H_kv
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        if dtype == torch.bfloat16:
            lib = lambda: aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
            lib_name = "aten._scaled_dot_product_flash_attention"
        else:
            lib = lambda: aten._scaled_dot_product_efficient_attention(qt, kt, vt, None, True,
                                                                         0.0, True)
            lib_name = "aten._scaled_dot_product_efficient_attention"
        try:   # a yardstick only: a refusal leaves its time null, with the reason
            lib_err = _lse_err(lib()[1][..., :S_].float(), lse)
            lib_ms = time_ms(lib, 10)
        except RuntimeError as e:
            lib_err, lib_ms, lib_name = None, None, f"{lib_name} refused: {str(e)[:200]}"
        del qt, kt, vt
        pairs = B * H * causal_pairs(S_, S_)
        flops = 4 * D * pairs
        n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S_
        b = bound(n_bytes, flops, BF16_TC_FLOPS if dtype == torch.bfloat16
                  else F32_3XTF32_FLOPS)
        out[key] = {"shape": f"B={B} S={S_} H={H} H_kv={H_kv} D={D} causal "
                             f"{'bf16' if dtype == torch.bfloat16 else 'f32'}",
                    "kernel": kernel_for(dtype, D, lse=True).name, "max_abs_err": err,
                    "ms": ms, "ms_without_lse": ms_no_lse, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library": lib_name,
                    "library_lse_vs_kernel": lib_err, "bound_ms": b[0], "bound_by": b[1],
                    "bytes": n_bytes, "lse_tol": LSE_TOL}
        log(json.dumps({"flash_lse": key, **out[key]}))
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    return out


def sp_one_rank_phase(kernels, gen, dev) -> dict:
    """Phase 2l (b), first part: ``sequence_sharded_attention`` at data=1 in
    a one-rank NCCL group, the ring over one block (one launch of C's lse
    entry) bit-equal to ``flash_attention``; bf16 at the headline shape, f32
    at the lse shape. The launch counts set to 0 just before, read after."""
    import torch.distributed as dist

    from synapseml_tpu_torch.parallel.flash import flash_attention, kernel_for
    from synapseml_tpu_torch.parallel.ring import sequence_sharded_attention
    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.runtime.layout import SpecLayout

    ins = {}
    for key in ("headline", "f32-d128"):
        (B, S_, H, H_kv, D), dtype = LSE_SHAPES[key]
        mk = lambda h: torch.randn(B, S_, h, D, generator=gen, device=dev).to(dtype)
        ins[key] = (mk(H), mk(H_kv), mk(H_kv))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        layout = SpecLayout.build(data=1)
        reset(kernels)
        collectives.reset_counts()
        t0 = time.perf_counter()
        outs = {key: sequence_sharded_attention(*t, layout, strategy="ring", causal=True)
                for key, t in ins.items()}
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, coll = counts(kernels), collectives.counts()
    finally:
        dist.destroy_process_group()
    for key, (q, k, v) in ins.items():
        if not torch.equal(outs[key], flash_attention(q, k, v, causal=True)):
            fail(f"phase 2l: sequence_sharded_attention at data=1 ({key}) differs from "
                 f"flash_attention")
    want = {kernel_for(torch.bfloat16, 64, lse=True).name: 1,
            kernel_for(torch.float32, 128, lse=True).name: 1}
    got = {name: launches[name] for name in want}
    if got != want or any(n for name, n in launches.items() if name not in want):
        fail(f"phase 2l: the one-rank ring launched {launches}, not {want}")
    rec = {"phase": "sequence_parallel_nccl_one_rank", "layout": layout.describe(),
           "shapes": {k: LSE_SHAPES[k][0] for k in ins}, "wall_s": wall_s,
           "launches": got, "collectives": coll, "bit_equal_to_flash_attention": True}
    log(json.dumps(rec))
    return rec


def _pair_main(rank: int, store: str, job: str, seed: int, outbox) -> None:
    """A rank of phase 2l's two-rank runs: ``cuda:0`` in a two-rank gloo
    world; ``job`` names the function it runs (``SP_JOBS``)."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=SP_RANKS, timeout=datetime.timedelta(seconds=120))
        try:
            outbox.put((rank, True, SP_JOBS[job](rank, seed)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the traceback goes back to the parent
        outbox.put((rank, False, traceback.format_exc()))


def run_pair(job: str, seed: int) -> dict:
    """Every rank's result of ``SP_JOBS[job]`` over two processes on
    ``cuda:0`` in one gloo world; a rank's failure fails the phase."""
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="smt_pair_")
    procs = [ctx.Process(target=_pair_main,
                         args=(r, os.path.join(store_dir, "store"), job, seed, outbox))
             for r in range(SP_RANKS)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            try:
                rank, ok, res = outbox.get(timeout=SP_TIMEOUT_S)
            except Exception:
                fail(f"phase 2l {job}: a rank gave no result in {SP_TIMEOUT_S} s")
            (got.__setitem__(rank, res) if ok else errors.append(f"rank {rank}:\n{res}"))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        fail(f"phase 2l {job}: a rank failed\n" + "\n".join(errors))
    return got


def _sp_rank_runs(rank: int, seed: int) -> dict:
    """Phase 2l (b)'s two-rank runs on one rank: ring and Ulysses (flash
    local) over SP_CASES, each rank's block against ``flash_attention`` over
    the whole sequence, with the launches, collectives and wall time; the
    merge's and one ring step's kernel time."""
    import torch.distributed as dist

    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.parallel.flash import flash_attention
    from synapseml_tpu_torch.parallel.ring import merge_lse, ring_attention, ulysses_attention
    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.runtime.layout import SpecLayout

    dev = torch.device("cuda", 0)
    kernels = all_kernels()
    layout = SpecLayout.build(data=SP_RANKS)
    n = layout.data_size
    out = {"layout": layout.describe(), "backend": dist.get_backend(),
           "transport": {"ring_shift": collectives.transport(torch.empty(1, device=dev), layout),
                         "all_to_all": "device"}, "runs": {}}
    for key, causal in SP_CASES:
        B, S_, H, H_kv, D = SP_SHAPES[key]
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        mk = lambda h: torch.randn(B, S_, h, D, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = mk(H), mk(H_kv), mk(H_kv)
        whole = flash_attention(q, k, v, causal=causal)
        s = S_ // n
        blk = slice(rank * s, (rank + 1) * s)
        ql, kl, vl = (t[:, blk].contiguous() for t in (q, k, v))
        want = whole[:, blk].float()
        del q, k, v, whole
        for strategy in ("ring", "ulysses"):
            reset(kernels)
            collectives.reset_counts()
            dist.barrier()
            t0 = time.perf_counter()
            if strategy == "ring":
                got = ring_attention(ql, kl, vl, layout, causal=causal)
            else:
                got = ulysses_attention(ql, kl, vl, layout, causal=causal, local="flash")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {name: c for name, c in counts(kernels).items() if c}
            err = float((got.float() - want).abs().max())
            rel = float(row_rel_err(got, want).max())
            out["runs"][f"{strategy}-{key}-{'causal' if causal else 'full'}"] = {
                "shape": SP_SHAPES[key], "causal": causal, "wall_s": wall_s,
                "launches": launches, "collectives": collectives.counts(),
                "max_abs_err": err, "row_rel_err": rel}
            del got
        # one ring step's pieces on this rank: kernel C on a block, the merge
        o_i, lse_i = flash_attention(ql, kl, vl, return_lse=True)
        acc = o_i.float()
        step_ms = time_ms(lambda: flash_attention(ql, kl, vl, return_lse=True), 5)
        merge_ms = time_ms(lambda: merge_lse(acc, lse_i, o_i, lse_i), 5)
        out["runs"][f"ring-{key}-{'causal' if causal else 'full'}"].update(
            kernel_step_ms=step_ms, merge_ms=merge_ms)
        del ql, kl, vl, want, o_i, lse_i, acc
        torch.cuda.empty_cache()
    return out


def _tp_rank_runs(rank: int, seed: int) -> dict:
    """Phase 2l (c) on one rank: BERT-base f32 over TP_SEQS x TP_SEQ_LEN
    tokens on the card without a layout, then under (data=1, model=2) and
    (data=1, fsdp=2): each layout's outputs against the one-device run,
    its at-rest weight bytes against the plan's, its collectives and the
    wall time of a warm call."""
    from synapseml_tpu_torch.models.zoo import bert_encoder
    from synapseml_tpu_torch.onnx import OnnxFunction
    from synapseml_tpu_torch.onnx.importer import placement_plan
    from synapseml_tpu_torch.onnx.wire import serialize_model
    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.runtime.layout import SpecLayout

    dev = torch.device("cuda", 0)
    mb = serialize_model(bert_encoder(seed=seed))
    feeds = {"input_ids": np.random.default_rng(seed).integers(0, BERT_VOCAB,
                                                              (TP_SEQS, TP_SEQ_LEN))}
    single = OnnxFunction(mb, device=dev)
    ref = {k: v.cpu() for k, v in single(feeds).items()}
    out = {"replicated_bytes": single.at_rest_bytes(), "layouts": {}}
    del single
    for name, layout in (("model2", SpecLayout.build(data=1, model=2)),
                         ("fsdp2", SpecLayout.build(data=1, fsdp=2))):
        fn = OnnxFunction(mb, layout=layout, device=dev)
        fn(feeds)
        torch.cuda.synchronize()
        collectives.reset_counts()
        t0 = time.perf_counter()
        res = fn(feeds)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        plan = placement_plan(mb, layout.model_size, layout.fsdp_size)
        planned = sum(r["nbytes"] for r in plan if r["decision"] != "replicated")
        whole = sum(r["nbytes"] for r in plan) - planned
        out["layouts"][name] = {
            "layout": layout.describe(), "wall_s": wall_s, "collectives": collectives.counts(),
            "at_rest_bytes": fn.at_rest_bytes(), "want_bytes": whole + planned // 2,
            "planned_weights": sum(r["decision"] != "replicated" for r in plan),
            "err": {k: _onnx_err(res[k], ref[k], rows=False) for k in ref}}
        del fn, res
        torch.cuda.empty_cache()
    return out


SP_JOBS = {"attention": _sp_rank_runs, "onnx": _tp_rank_runs}


def sp_two_ranks_phase(seed: int) -> dict:
    """Phase 2l (b), second part (module docstring)."""
    t0 = time.perf_counter()
    got = run_pair("attention", seed)
    for rank, res in got.items():
        for name, r in res["runs"].items():
            strategy, key = name.split("-")[:2]
            want = ({"flash_attention_fwd_lse": rank + 1 if r["causal"] else SP_RANKS}
                    if strategy == "ring" else {"flash_attention_fwd": 1})
            if r["launches"] != want:
                fail(f"phase 2l {name}: rank {rank} launched {r['launches']}, not {want}")
            if not (r["max_abs_err"] <= 5e-2 and r["row_rel_err"] <= FLASH_ROW_TOL):
                fail(f"phase 2l {name}: rank {rank}'s block is {r['max_abs_err']} "
                     f"(row {r['row_rel_err']}) from flash_attention over the whole sequence")
    rec = {"phase": "sequence_parallel_two_ranks_one_card", "backend": got[0]["backend"],
           "transport": got[0]["transport"], "layout": got[0]["layout"],
           "wall_s": time.perf_counter() - t0, "runs": {r: got[r]["runs"] for r in got}}
    log(json.dumps(rec))
    return rec


def tp_two_ranks_phase(seed: int) -> dict:
    """Phase 2l (c) (module docstring)."""
    t0 = time.perf_counter()
    got = run_pair("onnx", seed)
    for rank, res in got.items():
        for name, r in res["layouts"].items():
            if not max(r["err"].values()) <= ONNX_F32_TOL:
                fail(f"phase 2l ONNX {name}: rank {rank}'s outputs are {r['err']} from the "
                     f"one-device run (> {ONNX_F32_TOL})")
            if r["at_rest_bytes"] != r["want_bytes"]:
                fail(f"phase 2l ONNX {name}: rank {rank} holds {r['at_rest_bytes']} bytes, "
                     f"not the replicated tensors plus half the planned ones "
                     f"({r['want_bytes']})")
        if not got[rank]["layouts"]["model2"]["collectives"].get("gather:model"):
            fail(f"phase 2l ONNX model2: rank {rank} gathered nothing over model")
        if not got[rank]["layouts"]["fsdp2"]["collectives"].get("gather:fsdp"):
            fail(f"phase 2l ONNX fsdp2: rank {rank} gathered nothing over fsdp")
    rec = {"phase": "onnx_tensor_parallel_two_ranks_one_card", "model": "BERT-base f32",
           "tokens": [TP_SEQS, TP_SEQ_LEN], "wall_s": time.perf_counter() - t0,
           "replicated_bytes": got[0]["replicated_bytes"],
           "ranks": {r: got[r]["layouts"] for r in got}}
    log(json.dumps(rec))
    return rec


def topology_and_conv3d(dev) -> dict:
    """Phase 2l (d): the topology module on the card, and a 3-D ConvInteger
    through kernel Q (one launch a depth tap) bit-equal to its plain version
    on the host's CPU, timed. Returns the conv's record for phase 4."""
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.onnx import qgemm
    from synapseml_tpu_torch.onnx.ops import OPS
    from synapseml_tpu_torch.runtime.topology import cluster_info, require_backend
    from synapseml_tpu_torch.tools.kernel_cases import Q_CONV3D_CASES

    info = require_backend("gpu")
    if info != cluster_info() or info.platform != "gpu" or info.local_num_devices < 1:
        fail(f"phase 2l: cluster_info() on the card is {info}")
    log(json.dumps({"phase": "topology", "cluster_info": dataclasses_asdict(info)}))
    c = Q_CONV3D_CASES["c3d"]
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, c["x"]).astype(np.uint8)
    w = rng.integers(-128, 128, c["w"]).astype(np.int8)
    x_zp, w_zp = np.uint8(118), rng.integers(-4, 5, c["w"][0]).astype(np.int8)
    ctx = {"op_type": "ConvInteger", "opset": 17}
    xd = torch.from_numpy(x).to(dev)
    kern = all_kernels()["onnx_qconv"]
    before = kern.launches
    got = OPS["ConvInteger"]([xd, w, x_zp, w_zp], dict(c["attrs"]), dict(ctx))
    torch.cuda.synchronize()
    taps = c["w"][2]
    if kern.launches - before != taps:
        fail(f"phase 2l: the 3-D conv launched kernel Q {kern.launches - before} times, not "
             f"once a depth tap ({taps})")
    want, plain_ms = timed_once(lambda: OPS["ConvInteger"]([torch.from_numpy(x), w, x_zp, w_zp],
                                                           dict(c["attrs"]), dict(ctx)))
    if not torch.equal(got.cpu(), want):
        fail(f"phase 2l: the 3-D conv on the card differs from qconv_plain in "
             f"{int((got.cpu() != want).sum())} sums")
    # timed as the executor calls it: the weight on the card, packed once
    wd = torch.from_numpy(w).to(dev)
    packed = qgemm.pack_conv_w(wd)
    zps = (torch.tensor(x_zp, device=dev), torch.from_numpy(w_zp).to(dev))
    ms = time_ms(lambda: qgemm.qconv(xd, wd, *zps, (1, 1, 1), ((1, 1),) * 3, (1, 1, 1), 1,
                                     None, packed), 10)
    macs = int(np.prod(got.shape)) * int(np.prod(c["w"][1:]))
    n_bytes = x.nbytes + w.nbytes + got.numel() * got.element_size()
    b = bound(n_bytes, 2 * macs, INT8_TC_OPS)
    rec = {"shape": f"x {c['x']} u8, w {c['w']} s8, pads 1 (a C3D block)", "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
           "launches_a_call": taps, "bit_equal": True, "macs": macs}
    log(json.dumps({"qconv3d": rec}))
    del xd, wd, got, want
    return rec


# -- phase 2m: images and DL featurization, the explainers (kernel L), the forest (B) --

N_IMAGES = 256
IMAGE_SIDES = (240, 480)
IMAGE_STAGES = [{"action": "resize", "size": 256},
                {"action": "centercrop", "height": 224, "width": 224},
                {"action": "gaussiankernel", "aperturesize": 5},
                {"action": "flip", "flipcode": 1}]
IMAGE_BATCH = 64
IMAGE_CHECK = 8
# kernel L: LIME's default sample count, two targets, 256 instances (512 fits)
LASSO_M, LASSO_INSTANCES, LASSO_TARGETS, LASSO_KS = 1000, 256, 2, (32, 200)
LASSO_ALPHA, LASSO_ITERS = 0.01, 100
N_TAB_TRAIN, N_TAB_EXPLAIN, TAB_SAMPLES, TAB_CHECK, TAB_BACKGROUND = 65_536, 256, 1000, 16, 8
# card against the port's CPU run: the regressions' rounding (L against its
# plain version, LASSO_TOL; the SVD's on each device) of coefficients
# scaled by max(1, max|coefficient|)
EXPLAIN_TOL = 1e-3
# KernelSHAP: intercept + sum of attributions against the model's output
SHAP_ADD_TOL = 1e-3
LIME_IMAGES, LIME_SAMPLES, LIME_CELL, LIME_CHECK_SAMPLES = 2, 1000, 16.0, 64
# the min-norm fit of 64 samples over ~196 superpixels on the card and the
# CPU: linear in the logits, whose card and CPU runs differ by ONNX_F32_TOL
# of their max-abs
LIME_IMAGE_TOL = 1e-2
N_FOREST = 1_048_576
FOREST = dict(num_estimators=100, max_samples=256, contamination=0.02, random_seed=1)
FOREST_TOL = 1e-6
PHASE_2M_KERNELS = ("explainers_lasso_cd", "iforest_tree_score")


def ragged_images(seed: int, n: int) -> np.ndarray:
    """``n`` seeded uint8 BGR images, each side in IMAGE_SIDES."""
    rng = np.random.default_rng([seed, 22])
    col = np.empty(n, dtype=object)
    for i, (h, w) in enumerate(rng.integers(IMAGE_SIDES[0], IMAGE_SIDES[1] + 1, (n, 2))):
        col[i] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return col


def image_phase(seed: int, model_dir: str, card: str) -> dict:
    """Phase 2m (a): ImageTransformer over ragged images, then
    ImageFeaturizer (ResNet-50 from the zoo through ModelDownloader)."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.dl import ImageFeaturizer, ModelDownloader, ZooRepository
    from synapseml_tpu_torch.image import ImageTransformer

    col = ragged_images(seed, N_IMAGES)
    t0 = time.perf_counter()
    schema = ModelDownloader(model_dir, ZooRepository()).download_by_name("ResNet50")
    fetch_s = time.perf_counter() - t0
    table = Table({"image": col})
    stage = ImageTransformer(stages=IMAGE_STAGES)
    stage.transform(Table({"image": col[:4]}))                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = stage.transform(table)
    torch.cuda.synchronize()
    transformer_s = time.perf_counter() - t0
    if images["image"].shape != (N_IMAGES, 224, 224, 3):
        fail(f"phase 2m: ImageTransformer gave {images['image'].shape}")
    out = {"fetch_s": fetch_s, "model_bytes": schema.size, "transformer_s": transformer_s,
           "transformer_images_per_s": N_IMAGES / transformer_s}
    check = Table({"image": images["image"][:IMAGE_CHECK]})
    for policy in ("float32", "bfloat16"):
        kw = dict(model_name="ResNet50", model_dir=model_dir, batch_size=IMAGE_BATCH,
                  dtype_policy=policy)
        feat = ImageFeaturizer(**kw)
        t0 = time.perf_counter()
        feat.transform(Table({"image": images["image"][:IMAGE_BATCH]}))   # builds the plan
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = feat.transform(images)["features"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if got.shape != (N_IMAGES, 2048) or not np.isfinite(got).all():
            fail(f"phase 2m: {policy} features {got.shape}, finite {np.isfinite(got).all()}")
        cpu = ImageFeaturizer(device="cpu", **kw).transform(check)["features"]
        rows = policy == "bfloat16"
        err = _onnx_err(torch.from_numpy(got[:IMAGE_CHECK]), torch.from_numpy(cpu), rows)
        tol = ONNX_ROW_TOL if rows else ONNX_F32_TOL
        if not err <= tol:
            fail(f"phase 2m: {policy} features are {err} from the CPU run (> {tol})")
        out[policy] = {"first_batch_s": first_s, "wall_s": wall,
                       "images_per_s": N_IMAGES / wall, "err_vs_cpu": err, "tol": tol}
        log(f"phase 2m (a) {policy}: {N_IMAGES / wall:.1f} images/s, first batch "
            f"{first_s:.2f} s, error vs CPU {err:.3g} (tol {tol}) [{card}]")
    log(f"phase 2m (a): ImageTransformer {N_IMAGES / transformer_s:.1f} images/s; ResNet-50 "
        f"fetched in {fetch_s:.2f} s ({schema.size} bytes) [{card}]")
    return out, images["image"]


def lasso_rows(seed: int, dev, card: str) -> dict:
    """Phase 2m (b): kernel L against its plain version on the card at
    LIME's shapes, L, the plain version and the SVD path timed."""
    from synapseml_tpu_torch.explainers import regression as reg
    from synapseml_tpu_torch.tools.kernel_cases import lasso_case, lasso_cd_order, lasso_ties

    out = {"smem_k": reg.lasso_smem_k()}
    out["ks"] = LASSO_KS + (out["smem_k"] + 1,)     # and the limit's far side
    for k in out["ks"]:
        X, Y, w = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in
                   lasso_case(seed + k, LASSO_INSTANCES, LASSO_M, k, LASSO_TARGETS))
        *_, Xr, Yr = reg.rescaled(X, Y, w)
        gram, xty, sq = reg.lasso_system(Xr, Yr)
        lam = LASSO_ALPHA * LASSO_M
        in_smem, fits_a_block = reg.lasso_plan(k, LASSO_TARGETS)
        before = reg.LASSO_KERNEL.launches
        got = reg.lasso_cd(gram, xty, sq, lam, LASSO_ITERS)
        torch.cuda.synchronize()
        plain, plain_ms = timed_once(lambda: reg.lasso_cd_plain(gram, xty, sq, lam, LASSO_ITERS))
        scale = max(1.0, plain.abs().max().item())
        err = (got - plain).abs().max().item()
        if not err <= reg.LASSO_TOL * scale:
            fail(f"phase 2m (b): kernel L at k={k} is {err} from its plain version "
                 f"(> {reg.LASSO_TOL} x {scale})")
        # the same zero coefficients, but where the plain version's |rho| ties
        # with lam (kernel_cases.LASSO_TIE): there rounding decides
        flips = (got == 0) != (plain == 0)
        ties = int(flips.sum())
        if ties and not bool(lasso_ties(gram, xty, plain, lam)[flips].all()):
            fail(f"phase 2m (b): kernel L's zero coefficients differ from the plain version's "
                 f"at k={k}, away from a tie with lam")
        # and L's own order, step for step in torch ops on the card: bit-equal
        order = lasso_cd_order(gram, xty, sq, lam, LASSO_ITERS, triangle=in_smem)
        if not torch.equal(got, order):
            fail(f"phase 2m (b): kernel L at k={k} is {(got - order).abs().max().item()} from "
                 f"its order model (lasso_cd_order), not bit-equal")
        del order
        ms = time_ms(lambda: reg.lasso_cd(gram, xty, sq, lam, LASSO_ITERS), 5)
        svd_ms = time_ms(lambda: reg._min_norm_lstsq(Xr, Yr), 3)
        fits = LASSO_INSTANCES * LASSO_TARGETS
        n_bytes = 4 * (gram.numel() + xty.numel() + sq.numel() + xty.numel())
        out[k] = {"launches_checked": reg.LASSO_KERNEL.launches - before,
                  "max_abs_err": err, "tol": reg.LASSO_TOL * scale, "ms": ms,
                  "plain_ms": plain_ms, "svd_ms": svd_ms,
                  "bound": bound(n_bytes, fits * LASSO_ITERS * k * 2 * k, F32_FLOPS),
                  "bytes": n_bytes, "gram_in_smem": in_smem, "fits_a_block": fits_a_block,
                  "zero_flips_at_ties": ties, "bit_equal_to_order_model": True,
                  "nonzero_share": float((plain != 0).float().mean()),
                  "shape": f"{fits} fits ({LASSO_INSTANCES} instances x {LASSO_TARGETS} "
                           f"targets), m={LASSO_M}, k={k}, alpha={LASSO_ALPHA}, "
                           f"{LASSO_ITERS} sweeps"}
        log(f"phase 2m (b) L k={k} (Gram matrix in shared memory: {in_smem}, {fits_a_block} "
            f"fits a block): {ms:.4f} ms (plain {plain_ms:.1f}, SVD path {svd_ms:.3f}), "
            f"bound {out[k]['bound'][0]:.4f} ({out[k]['bound'][1]}), "
            f"max|L - plain| {err:.3g} <= {reg.LASSO_TOL * scale:.3g} [{card}]")
        del X, Y, w, Xr, Yr, gram, xty, sq, got, plain
    return out


def _adult_tables(seed: int):
    """Adult rows (NaN codes as one more level) for the tabular explainers."""
    from synapseml_tpu_torch.tools.schema_data import (ADULT_CARDINALITY, ADULT_COLUMNS,
                                                       adult_rows)

    x, y, _ = adult_rows(seed, N_TAB_TRAIN + N_TAB_EXPLAIN)
    for name, k in ADULT_CARDINALITY.items():
        j = ADULT_COLUMNS.index(name)
        x[np.isnan(x[:, j]), j] = k
    cols = {c: x[:, j].astype(np.float64) for j, c in enumerate(ADULT_COLUMNS)}
    return x, y, cols


def tabular_phase(seed: int, card: str) -> dict:
    """Phase 2m (c): TabularLIME (kernel L) and TabularSHAP over a
    LightGBMClassifier pipeline fitted on Adult-schema rows."""
    from synapseml_tpu_torch.core import PipelineModel, Table
    from synapseml_tpu_torch.explainers import TabularLIME, TabularSHAP
    from synapseml_tpu_torch.featurize import FastVectorAssembler
    from synapseml_tpu_torch.gbdt import LightGBMClassifier
    from synapseml_tpu_torch.stages import Lambda
    from synapseml_tpu_torch.tools.schema_data import (ADULT_CARDINALITY, ADULT_CATEGORICAL,
                                                       ADULT_COLUMNS)

    x, y, cols = _adult_tables(seed)
    t0 = time.perf_counter()
    clf = LightGBMClassifier(num_iterations=20, num_leaves=31, max_bin=255,
                             categorical_slot_indexes=list(ADULT_CATEGORICAL)).fit(
        Table({"features": x[:N_TAB_TRAIN], "label": y[:N_TAB_TRAIN]}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    cats = list(ADULT_CARDINALITY)
    as_codes = lambda t: t.with_columns({c: np.asarray(t[c], np.float64) for c in cats})

    def pipeline(model):
        return PipelineModel([Lambda(transform_func=as_codes),
                              FastVectorAssembler(input_cols=ADULT_COLUMNS), model])

    card_model, cpu_model = pipeline(clf), pipeline(clf.copy({"device": "cpu"}))
    explain = {c: v[N_TAB_TRAIN:] for c, v in cols.items()}
    background = Table({c: v[:TAB_BACKGROUND] for c, v in cols.items()})
    head = {c: v[:TAB_CHECK] for c, v in explain.items()}
    out = {"fit_s": fit_s}
    for name, make in (
            ("lime", lambda model, dev: TabularLIME(
                model=model, input_cols=ADULT_COLUMNS, categorical_cols=cats,
                target_classes=[1], num_samples=TAB_SAMPLES, regularization=LASSO_ALPHA,
                seed=seed, device=dev)),
            ("shap", lambda model, dev: TabularSHAP(
                model=model, input_cols=ADULT_COLUMNS, background_data=background,
                target_classes=[1], num_samples=TAB_SAMPLES, seed=seed, device=dev))):
        t0 = time.perf_counter()
        res = make(card_model, None).transform(Table(explain))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coef = np.stack([e for e in res["explanation"]])
        r2 = np.stack([e for e in res["r2"]])
        if not (np.isfinite(coef).all() and np.isfinite(r2).all()):
            fail(f"phase 2m (c) {name}: coefficients or r2 not finite")
        got = make(card_model, None).transform(Table(head))["explanation"]
        want = make(cpu_model, "cpu").transform(Table(head))["explanation"]
        got, want = np.stack(list(got)), np.stack(list(want))
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        if not err <= EXPLAIN_TOL * scale:
            fail(f"phase 2m (c) {name}: card and CPU attributions differ by {err} "
                 f"(> {EXPLAIN_TOL} x {scale})")
        rec = {"rows": N_TAB_EXPLAIN, "samples": TAB_SAMPLES, "wall_s": wall,
               "rows_per_s": N_TAB_EXPLAIN / wall, "err_vs_cpu": err,
               "tol": EXPLAIN_TOL * scale, "median_r2": float(np.median(r2))}
        if name == "shap":
            probs = card_model.transform(Table(explain))["probability"][:, 1]
            add = float(np.abs(coef[:, 0, 0] + coef[:, 0, 1:].sum(-1) - probs).max())
            if not add <= SHAP_ADD_TOL:
                fail(f"phase 2m (c) shap: intercept + attributions miss the model's "
                     f"probability by {add} (> {SHAP_ADD_TOL})")
            rec.update(additivity_err=add, background_rows=TAB_BACKGROUND,
                       rows_scored=N_TAB_EXPLAIN * TAB_SAMPLES * TAB_BACKGROUND)
        out[name] = rec
        log(f"phase 2m (c) {name}: {N_TAB_EXPLAIN} rows at {TAB_SAMPLES} samples in "
            f"{wall:.2f} s, card vs CPU {err:.3g} (tol {EXPLAIN_TOL * scale:.3g}) [{card}]")
    return out


def image_lime_phase(images: np.ndarray, model_dir: str, card: str) -> dict:
    """Phase 2m (d): ImageLIME over the featurizer's logits."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.dl import ImageFeaturizer
    from synapseml_tpu_torch.explainers import ImageLIME, SuperpixelTransformer

    models = {dev: ImageFeaturizer(model_name="ResNet50", model_dir=model_dir,
                                   batch_size=IMAGE_BATCH, cut_output_layers=0,
                                   output_col="logits", device=dev) for dev in (None, "cpu")}
    col = np.empty(LIME_IMAGES, dtype=object)
    col[:] = [images[i] for i in range(LIME_IMAGES)]
    logits = models[None].transform(Table({"image": images[:1]}))["logits"]
    target = int(np.argmax(logits[0]))
    t0 = time.perf_counter()
    table = SuperpixelTransformer(cell_size=LIME_CELL).transform(Table({"image": col}))
    slic_s = time.perf_counter() - t0

    def lime(dev, n):
        return ImageLIME(model=models[dev], target_col="logits", target_classes=[target],
                         cell_size=LIME_CELL, superpixel_col="superpixels", num_samples=n,
                         seed=0, device=dev)

    t0 = time.perf_counter()
    res = lime(None, LIME_SAMPLES).transform(table)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    coef = [np.asarray(e) for e in res["explanation"]]
    if not all(np.isfinite(c).all() for c in coef) or \
            not all(np.isfinite(np.asarray(r)).all() for r in res["r2"]):
        fail("phase 2m (d): ImageLIME's coefficients or r2 are not finite")
    one = table.slice(0, 1)
    got = np.asarray(lime(None, LIME_CHECK_SAMPLES).transform(one)["explanation"][0])
    want = np.asarray(lime("cpu", LIME_CHECK_SAMPLES).transform(one)["explanation"][0])
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    if not err <= LIME_IMAGE_TOL * scale:
        fail(f"phase 2m (d): ImageLIME on the card and the CPU differ by {err} "
             f"(> {LIME_IMAGE_TOL} x {scale})")
    log(f"phase 2m (d) ImageLIME: {LIME_IMAGES} images x {LIME_SAMPLES} samples in {wall:.2f} "
        f"s (superpixels {slic_s:.2f} s on the host before it), {coef[0].shape[1]} "
        f"superpixels, card vs CPU {err:.3g} [{card}]")
    return {"images": LIME_IMAGES, "samples": LIME_SAMPLES, "wall_s": wall, "slic_s": slic_s,
            "superpixels": [int(c.shape[1]) for c in coef], "target_class": target,
            "err_vs_cpu": err, "tol": LIME_IMAGE_TOL * scale,
            "median_r2": float(np.median([np.asarray(r) for r in res["r2"]]))}


def forest_phase(seed: int, dev, kernels, card: str) -> dict:
    """Phase 2m (e): IsolationForest on HIGGS-schema rows, all rows scored
    through kernel B, held against the heap descent on the card."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.device_predict import device_raw_scores
    from synapseml_tpu_torch.isolationforest import IsolationForest
    from synapseml_tpu_torch.isolationforest import forest as F
    from synapseml_tpu_torch.tools.schema_data import higgs_width_rows

    x, _ = higgs_width_rows(seed + 7, N_FOREST)
    table = Table({"features": x})
    t0 = time.perf_counter()
    reset(kernels)
    model = IsolationForest(**FOREST).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = counts(kernels)["iforest_tree_score"]     # the contamination threshold
    reset(kernels)
    t0 = time.perf_counter()
    out = model.transform(table)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    launches = kernels["iforest_tree_score"].launches
    if launches != 1:
        fail(f"phase 2m (e): the transform launched B's forest entry {launches} times, not 1")
    xd = torch.from_numpy(x).to(dev)
    T = FOREST["num_estimators"]
    plain, plain_ms = timed_once(lambda: F.path_lengths_plain(
        xd, model.tree_features, model.tree_thresholds, model.tree_path_lens,
        model.depth_limit))
    want = F.scores_from_total(plain, T, model.c_norm).cpu().numpy()
    got = out["outlierScore"]
    err = float(np.abs(got - want).max())
    if not err <= FOREST_TOL:
        fail(f"phase 2m (e): B's scores are {err} from the heap descent's (> {FOREST_TOL})")
    pred_plain = (want >= model.score_threshold).astype(np.float64)
    if not np.array_equal(out["predictedLabel"], pred_plain):
        fail("phase 2m (e): predictions through B differ from the heap descent's")
    plan = model._plan(x.shape[1], dev)
    binned = F.rebin(xd, plan)
    ones = np.ones(T, np.float32)
    call = lambda: device_raw_scores(binned, plan.parent, plan.feature, plan.bins,
                                     plan.leaf_value, ones, packed=plan.packed,
                                     kernel=F.IFOREST_KERNEL)
    ms = time_ms(call, 10)
    rebin_ms = time_ms(lambda: F.rebin(xd, plan), 10)
    n_bytes = (binned.numel() * binned.element_size() + plan.packed.nodes.numel() * 4
               + plan.leaf_value.size * 4 + N_FOREST * 4)
    flagged = float(out["predictedLabel"].mean())
    log(f"phase 2m (e) forest: fit {fit_s:.2f} s, transform {transform_s:.2f} s "
        f"({N_FOREST / transform_s:.0f} rows/s), B {ms:.4f} ms (plain {plain_ms:.1f}), "
        f"re-binning {rebin_ms:.3f} ms, max|B - heap| {err:.3g}, flagged {flagged:.4f} [{card}]")
    return {"fit_s": fit_s, "transform_s": transform_s, "rows_per_s": N_FOREST / transform_s,
            "launches": launches, "fit_launches": fit_launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "rebin_ms": rebin_ms, "bytes": n_bytes,
            "bound": bound(n_bytes, 0, F32_FLOPS), "bin_dtype": str(plan.bin_dtype),
            "splits_a_tree": int(plan.parent.shape[-1]), "flagged_share": flagged,
            "shape": f"{N_FOREST} x {x.shape[1]} rows, {T} trees of depth "
                     f"{model.depth_limit} (max_samples {FOREST['max_samples']})"}


def explainers_phase(kernels, seed: int, dev, card: str) -> dict:
    """Phase 2m: (b) kernel L against its plain version first, then the
    main path -- (a) images and featurization, (c) the tabular explainers,
    (d) ImageLIME, (e) the forest -- with every launch count set to 0 just
    before it and read just after."""
    import tempfile

    lasso = lasso_rows(seed, dev, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="smt-models-") as model_dir:
        reset(kernels)
        imgs, images = image_phase(seed, model_dir, card)
        tab = tabular_phase(seed, card)
        lime = image_lime_phase(images, model_dir, card)
        path_counts = counts(kernels)
    forest = forest_phase(seed, dev, kernels, card)
    path_counts["iforest_tree_score"] += forest["fit_launches"] + forest["launches"]
    for name in PHASE_2M_KERNELS:
        if path_counts[name] < 1:
            fail(f"phase 2m: the main path never launched {name}")
    log(f"phase 2m launches: { {k: v for k, v in path_counts.items() if v} }")
    return {"lasso": lasso, "images": imgs, "tabular": tab, "image_lime": lime,
            "forest": forest, "launches": path_counts}


# -- phase 2n: KNN / ConditionalKNN, SAR, AccessAnomaly (kernel K) ---------------------

# (b) keys, width, queries, k; ConditionalKNN at ResNet-50's pooled width
KNN_SHAPE = (1_048_576, 128, 16_384, 10)
CKNN_SHAPE = (262_144, 2_048, 4_096, 5)
CKNN_LABELS = 6
NN_CPU_QUERIES = 64
# (c) SAR on MovieLens-10M's shape (schema_data.MOVIELENS_10M), the defaults
SAR_K, SAR_HELD_OUT, SAR_CPU_USERS, SAR_COUNT_ITEMS = 10, 1_000_000, 256, 64
# (d) four tenants of 10,000 users x 2,000 resources, a fifth of 1,000 x 400
ANOMALY_TENANTS = ([(f"tenant{i}", 10_000, 2_000, 250_000) for i in range(4)]
                   + [("tenant4", 1_000, 400, 25_000)])
ANOMALY_PARAMS = dict(rank_param=10, max_iter=25, apply_implicit_cf=True)
ANOMALY_ROWS = 1_000_000
# (a) kernel K at 256 rows of each phase shape's scores: (n, k)
TOPK_ROWS = 256
TOPK_SHAPES = {"knn": (KNN_SHAPE[0], KNN_SHAPE[3]), "cknn": (CKNN_SHAPE[0], CKNN_SHAPE[3]),
               "sar": (10_677, SAR_K)}
PHASE_2N_KERNELS = ("topk_select",)


def _matches(rows, key="value"):
    """(indices, distances) arrays of a KNN output column's match lists."""
    return (np.array([[m[key] for m in r] for r in rows], np.int64),
            np.array([[m["distance"] for m in r] for r in rows], np.float64))


def knn_run(seed: int, card: str) -> dict:
    """Phase 2n (b), KNN: fit, then two transforms of the queries (the first
    uploads the keys); 64 queries held to the port's CPU run."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.nn import KNN, KNNModel
    from synapseml_tpu_torch.nn.topk import TOPK_TIE_TOL
    from synapseml_tpu_torch.tools.kernel_cases import same_up_to_ties
    from synapseml_tpu_torch.tools.schema_data import embedding_rows

    n, d, nq, k = KNN_SHAPE
    x, _ = embedding_rows(seed + 24, n + nq, d)
    keys, queries = x[:n], x[n:]
    t0 = time.perf_counter()
    model = KNN(k=k).fit(Table({"features": keys, "values": np.arange(n)}))
    fit_s = time.perf_counter() - t0
    qt = Table({"features": queries})
    t0 = time.perf_counter()
    model.transform(qt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(qt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    idx, dist = _matches(out["output"])
    if idx.shape != (nq, k) or not np.isfinite(dist).all():
        fail(f"phase 2n (b) KNN: matches {idx.shape}, finite {np.isfinite(dist).all()}")
    cpu = KNNModel.from_state(model.state_dict(), device="cpu")
    want_idx, want_dist = _matches(cpu.transform(Table({"features": queries[:NN_CPU_QUERIES]}))
                                   ["output"])
    if not same_up_to_ties(idx[:NN_CPU_QUERIES], dist[:NN_CPU_QUERIES], want_idx, want_dist,
                           TOPK_TIE_TOL):
        fail("phase 2n (b) KNN: the card's neighbours differ from the CPU run's beyond ties")
    swaps = int((idx[:NN_CPU_QUERIES] != want_idx).sum())
    log(f"phase 2n (b) KNN {n} x {d}, {nq} queries, k={k}: {nq / wall:.0f} queries/s "
        f"(first transform {first_s:.2f} s with the keys' upload; fit {fit_s:.2f} s), "
        f"{NN_CPU_QUERIES} queries as on the CPU ({swaps} places traded at ties) [{card}]")
    return {"model": model, "queries": queries, "fit_s": fit_s, "first_transform_s": first_s,
            "transform_s": wall, "queries_per_s": nq / wall, "cpu_swaps": swaps,
            "shape": f"{n} keys x {d} f32, {nq} queries, k={k}"}


def _conditioners(rng, nq: int):
    col = np.empty(nq, dtype=object)
    for r, size in enumerate(rng.integers(1, 4, nq)):
        col[r] = sorted(rng.choice(CKNN_LABELS, size=int(size), replace=False).tolist())
    return col


def cknn_run(seed: int, card: str) -> dict:
    """Phase 2n (b), ConditionalKNN at ResNet-50's pooled width."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.nn import ConditionalKNN, ConditionalKNNModel
    from synapseml_tpu_torch.nn.topk import TOPK_TIE_TOL
    from synapseml_tpu_torch.tools.kernel_cases import same_up_to_ties
    from synapseml_tpu_torch.tools.schema_data import embedding_rows

    n, d, nq, k = CKNN_SHAPE
    x, labels = embedding_rows(seed + 25, n + nq, d, n_labels=CKNN_LABELS, nonnegative=True)
    keys, queries = x[:n], x[n:]
    conds = _conditioners(np.random.default_rng([seed, 25]), nq)
    t0 = time.perf_counter()
    model = ConditionalKNN(k=k).fit(Table({"features": keys, "values": np.arange(n),
                                           "labels": labels[:n]}))
    fit_s = time.perf_counter() - t0
    qt = Table({"features": queries, "conditioner": conds})
    t0 = time.perf_counter()
    model.transform(qt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(qt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    idx, dist = _matches(out["output"])
    got_labels = np.array([[m["label"] for m in r] for r in out["output"]])
    if idx.shape != (nq, k) or not np.isfinite(dist).all():
        fail(f"phase 2n (b) ConditionalKNN: matches {idx.shape}")
    if not all(set(row.tolist()) <= set(c) for row, c in zip(got_labels, conds)):
        fail("phase 2n (b) ConditionalKNN: a match's label is not in its query's conditioner")
    cpu = ConditionalKNNModel.from_state(model.state_dict(), device="cpu")
    want = cpu.transform(Table({"features": queries[:NN_CPU_QUERIES],
                                "conditioner": conds[:NN_CPU_QUERIES]}))
    want_idx, want_dist = _matches(want["output"])
    if not same_up_to_ties(idx[:NN_CPU_QUERIES], dist[:NN_CPU_QUERIES], want_idx, want_dist,
                           TOPK_TIE_TOL):
        fail("phase 2n (b) ConditionalKNN: the card's neighbours differ from the CPU run's "
             "beyond ties")
    swaps = int((idx[:NN_CPU_QUERIES] != want_idx).sum())
    log(f"phase 2n (b) ConditionalKNN {n} x {d}, {CKNN_LABELS} labels, {nq} queries, k={k}: "
        f"{nq / wall:.0f} queries/s (first transform {first_s:.2f} s; fit {fit_s:.2f} s), "
        f"{NN_CPU_QUERIES} queries as on the CPU ({swaps} places traded at ties) [{card}]")
    return {"model": model, "queries": queries, "conditioners": conds, "fit_s": fit_s,
            "first_transform_s": first_s, "transform_s": wall, "queries_per_s": nq / wall,
            "cpu_swaps": swaps,
            "shape": f"{n} keys x {d} f32, {CKNN_LABELS} labels, {nq} queries with 1-3 "
                     f"admissible labels, k={k}"}


def sar_run(seed: int, dev, card: str) -> dict:
    """Phase 2n (c): SAR on MovieLens-10M's shape less the held-out ratings."""
    from scipy.sparse import csr_matrix

    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.nn.topk import TOPK_TIE_TOL
    from synapseml_tpu_torch.recommendation import SAR, SARModel
    from synapseml_tpu_torch.recommendation import sar as S
    from synapseml_tpu_torch.runtime.device import full_f32
    from synapseml_tpu_torch.tools.kernel_cases import same_up_to_ties
    from synapseml_tpu_torch.tools.schema_data import movielens_rows

    t0 = time.perf_counter()
    users, items, stars, times = movielens_rows(seed + 24)
    held = np.zeros(len(users), bool)
    held[np.random.default_rng([seed, 26]).choice(len(users), SAR_HELD_OUT, replace=False)] = True
    data_s = time.perf_counter() - t0
    fit_rows = Table({"user": users[~held], "item": items[~held], "rating": stars[~held],
                      "time": times[~held]})
    t0 = time.perf_counter()
    model = SAR().fit(fit_rows)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = model.recommend_for_all_users(SAR_K, remove_seen=True)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    pairs = Table({"user": users[held], "item": items[held]})
    t0 = time.perf_counter()
    scored = model.transform(pairs)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    n_users, n_items = model.user_affinity.shape
    lists = recs["recommendations"]
    if len(lists) != n_users or any(len(r) != SAR_K for r in lists):
        fail(f"phase 2n (c) SAR: {len(lists)} users' lists, not {n_users} of {SAR_K}")
    pred = np.asarray(scored["prediction"])
    if len(pred) != SAR_HELD_OUT or not np.isfinite(pred).all():
        fail(f"phase 2n (c) SAR: {len(pred)} held-out scores, finite {np.isfinite(pred).all()}")
    # co-occurrence counts of 64 items against a host count; their similarity
    # rows against the host's jaccard in f32, bit for bit
    u, i = users[~held], items[~held]
    sample = np.sort(np.random.default_rng([seed, 27]).choice(n_items, SAR_COUNT_ITEMS,
                                                               replace=False))
    occ = csr_matrix((np.ones(len(u), np.float64), (u, i)), shape=(n_users, n_items))
    host = np.asarray((occ[:, sample].T @ occ).todense()).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_c = S.cooccurrence(u, i, n_users, n_items, dev)
    torch.cuda.synchronize()
    cooc_s = time.perf_counter() - t0
    got = card_c[torch.from_numpy(sample).to(dev)].cpu().numpy()
    del card_c
    # the same product in full f32, for its time beside the TF32 one
    ones = torch.zeros((n_users, n_items), device=dev)
    ones[torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)] = 1.0
    with full_f32():
        f32_ms = time_ms(lambda: torch.matmul(ones.T, ones), 2)
    del ones
    if not np.array_equal(got, host):
        fail(f"phase 2n (c) SAR: co-occurrence counts differ from the host count in "
             f"{int((got != host).sum())} places")
    diag = np.asarray(occ.sum(axis=0)).ravel().astype(np.float32)
    denom = diag[sample][:, None] + diag[None, :] - host
    with np.errstate(divide="ignore", invalid="ignore"):
        jac = np.where(denom > 0, host / denom, np.float32(0.0)).astype(np.float32)
    jac = np.where(host < 4, np.float32(0.0), jac)
    sim_rows = np.asarray(model.item_similarity)[sample]
    if not np.array_equal(sim_rows.view(np.uint32), jac.view(np.uint32)):
        fail("phase 2n (c) SAR: the similarity rows differ from the host's jaccard")
    # 256 users' lists against the port's CPU run
    check = np.sort(np.random.default_rng([seed, 28]).choice(n_users, SAR_CPU_USERS,
                                                              replace=False))
    cpu = SARModel.from_state(model.state_dict(), device="cpu")
    want = cpu.recommend_for_user_subset(Table({"user": check}), SAR_K, remove_seen=True)
    to_arrays = lambda rows: (np.array([[r[0] for r in x] for x in rows], np.int64),
                              np.array([[r[1] for r in x] for x in rows], np.float64))
    gi, gv = to_arrays([lists[int(c)] for c in check])
    wi, wv = to_arrays(want["recommendations"])
    if not same_up_to_ties(gi, gv, wi, wv, TOPK_TIE_TOL):
        fail("phase 2n (c) SAR: the card's recommendations differ from the CPU run's "
             "beyond ties")
    swaps = int((gi != wi).sum())
    log(f"phase 2n (c) SAR on {len(u)} ratings ({n_users} users x {n_items} items): fit "
        f"{fit_s:.2f} s, recommend_for_all_users({SAR_K}, remove_seen) {rec_s:.2f} s, "
        f"transform {SAR_HELD_OUT / transform_s:.0f} rows/s, counts of {SAR_COUNT_ITEMS} items "
        f"as the host's, {SAR_CPU_USERS} users as on the CPU ({swaps} places traded at ties); "
        f"co-occurrence {cooc_s:.3f} s (its TF32 product; {f32_ms:.1f} ms in full f32); "
        f"data {data_s:.1f} s [{card}]")
    return {"model": model, "fit_s": fit_s, "recommend_s": rec_s, "cooccurrence_s": cooc_s,
            "cooccurrence_f32_product_ms": f32_ms,
            "transform_rows_per_s": SAR_HELD_OUT / transform_s, "transform_s": transform_s,
            "data_s": data_s, "cpu_swaps": swaps,
            "shape": f"{len(u)} ratings, {n_users} users x {n_items} items, jaccard, "
                     f"support 4, decay 30 days, top {SAR_K} with seen items removed"}


def _anomaly_probe(cols, seed: int):
    """ANOMALY_ROWS rows: 20 % training pairs, 70 % a training user with a
    resource of its tenant drawn at random (some across components), 5 %
    unknown users, 5 % unknown resources."""
    rng = np.random.default_rng([seed, 29])
    t, u, r = (np.asarray(cols[c]) for c in ("tenant", "user", "res"))
    n = ANOMALY_ROWS
    a = rng.integers(0, len(t), n)
    b = rng.integers(0, len(t), n)
    kind = rng.choice(4, size=n, p=[0.2, 0.7, 0.05, 0.05])
    same = t[a] == t[b]
    res = np.where((kind == 1) & same, r[b], r[a]).astype(object)
    user = u[a].astype(object)
    user[kind == 2] = "nobody"
    res[kind == 3] = "nothing"
    return {"tenant": t[a], "user": user, "res": res}


def anomaly_run(seed: int, dev, card: str) -> dict:
    """Phase 2n (d): AccessAnomaly over five tenants; the fifth held to the
    port's CPU fit of it."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.cyber import AccessAnomaly
    from synapseml_tpu_torch.cyber import anomaly as A
    from synapseml_tpu_torch.runtime.device import full_f32
    from synapseml_tpu_torch.tools.schema_data import access_rows

    cols = access_rows(seed + 24, ANOMALY_TENANTS)
    als_s = []
    real_als = A.als

    def timed_als(*args, **kw):
        t = time.perf_counter()
        out = real_als(*args, **kw)
        als_s.append(time.perf_counter() - t)
        return out

    A.als = timed_als
    try:
        t0 = time.perf_counter()
        model = AccessAnomaly(**ANOMALY_PARAMS).fit(Table(cols))
        fit_s = time.perf_counter() - t0
    finally:
        A.als = real_als
    probe = _anomaly_probe(cols, seed)
    t0 = time.perf_counter()
    scores = np.asarray(model.transform(Table(probe))["anomaly_score"])
    transform_s = time.perf_counter() - t0
    unknown = (probe["user"] == "nobody") | (probe["res"] == "nothing")
    if not np.array_equal(np.isnan(scores), unknown):
        fail("phase 2n (d) AccessAnomaly: NaN scores are not the unknown rows")
    cross = int(np.isposinf(scores).sum())
    if cross == 0 or not np.isfinite(scores[~unknown & ~np.isinf(scores)]).all():
        fail(f"phase 2n (d) AccessAnomaly: {cross} cross-component rows")
    # the fifth tenant against the port's CPU fit of it
    last = ANOMALY_TENANTS[-1][0]
    mine = np.asarray(cols["tenant"]) == last
    cpu = AccessAnomaly(device="cpu", **ANOMALY_PARAMS).fit(
        Table({k: v[mine] for k, v in cols.items()}))
    rows = probe["tenant"] == last
    sub = Table({k: v[rows] for k, v in probe.items()})
    got = np.asarray(model.transform(sub)["anomaly_score"])
    want = np.asarray(cpu.transform(sub)["anomaly_score"])
    for kind in (np.isnan, np.isposinf, lambda s: s == 0.0):
        if not np.array_equal(kind(got), kind(want)):
            fail("phase 2n (d) AccessAnomaly: the fifth tenant's NaN / inf / 0 rows differ "
                 "from the CPU fit's")
    ok = np.isfinite(want)
    err = float(np.abs(got[ok] - want[ok]).max())
    if not A.scores_agree(got[ok], want[ok]):
        fail(f"phase 2n (d) AccessAnomaly: the fifth tenant's scores are {err} from the CPU "
             f"fit's (> ANOMALY_TOL {A.ANOMALY_TOL} in z units)")
    # one implicit half-step at the large tenants' shape, its two library calls timed
    n_u, n_i = ANOMALY_TENANTS[0][1], ANOMALY_TENANTS[0][2]
    k = ANOMALY_PARAMS["rank_param"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = torch.rand(n_u, n_i, generator=gen, device=dev)
    r = torch.where(r < 250_000 / (n_u * n_i), r * 10, torch.zeros((), device=dev))
    fixed = torch.rand(n_i, k, generator=gen, device=dev)
    with full_f32():
        gram_ms = time_ms(lambda: A._gram(r, fixed), 5)
        a = (fixed.T @ fixed + torch.eye(k, device=dev))[None] + A._gram(r, fixed)
        b = ((1.0 + r) * (r > 0)) @ fixed
        solve_ms = time_ms(lambda: torch.linalg.solve(a, b[..., None]), 5)
    del r, fixed, a, b
    log(f"phase 2n (d) AccessAnomaly: {len(cols['tenant'])} rows over "
        f"{len(ANOMALY_TENANTS)} tenants, fit {fit_s:.2f} s (ALS {sum(als_s):.2f} s: "
        f"{', '.join(f'{s:.2f}' for s in als_s)}), transform {ANOMALY_ROWS / transform_s:.0f} "
        f"rows/s ({int(unknown.sum())} unknown, {cross} cross-component), fifth tenant within "
        f"{err:.3g} of the CPU fit; a {n_u} x {n_i} half-step's Gram product {gram_ms:.3f} ms, "
        f"batched solve {solve_ms:.3f} ms [{card}]")
    return {"fit_s": fit_s, "als_s": sum(als_s), "als_s_by_tenant": als_s,
            "transform_s": transform_s, "transform_rows_per_s": ANOMALY_ROWS / transform_s,
            "cross_component_rows": cross, "unknown_rows": int(unknown.sum()),
            "cpu_max_abs_err": err, "half_step_gram_ms": gram_ms,
            "half_step_solve_ms": solve_ms,
            "shape": f"{len(ANOMALY_TENANTS)} tenants "
                     f"({', '.join(f'{a} x {b}' for _, a, b, _ in ANOMALY_TENANTS)}), "
                     f"implicit, rank {k}, {ANOMALY_PARAMS['max_iter']} iterations"}


def _phase_scores(name: str, runs: dict, dev) -> torch.Tensor:
    """TOPK_ROWS rows of the scores the main path hands K at ``name``'s shape."""
    from synapseml_tpu_torch.runtime.device import full_f32

    with full_f32():
        if name == "sar":
            aff, sim = runs["sar"]["model"]._device_mats()
            a = aff[:TOPK_ROWS]
            return torch.where(a > 0, torch.tensor(-np.inf, device=dev), a @ sim)
        run = runs[name]
        keys = run["model"]._device_keys(dev)
        q = torch.from_numpy(np.ascontiguousarray(run["queries"][:TOPK_ROWS])).to(dev)
        scores = q @ keys.T
        if name == "cknn":
            model = run["model"]
            lut = {l: i for i, l in enumerate(model.label_levels)}
            allowed = np.zeros((TOPK_ROWS, len(lut)), bool)
            for r, c in enumerate(run["conditioners"][:TOPK_ROWS]):
                allowed[r, [lut[l] for l in c]] = True
            codes = torch.from_numpy(np.asarray(model.label_codes, np.int64)).to(dev)
            keep = torch.from_numpy(allowed).to(dev).index_select(1, codes)
            scores = torch.where(keep, scores, torch.tensor(-np.inf, device=dev))
        return scores


def topk_rows(runs: dict, seed: int, dev, card: str) -> dict:
    """Phase 2n (a): kernel K bit-equal to its plain version on every
    TOPK_CASES case and on TOPK_ROWS rows of each phase shape's scores; K,
    the plain version and torch.topk timed, with K's bound (the scores read
    once, the values and indices written once)."""
    from synapseml_tpu_torch.nn.topk import topk_select, topk_select_plain
    from synapseml_tpu_torch.tools.kernel_cases import TOPK_CASES, topk_case

    def same(x, k):
        """(values and indices bit-equal, max |v - plain v|: 0 where the
        bits agree, inf where a non-finite value differs)."""
        v, i = topk_select(x, k)
        pv, pi = topk_select_plain(x, k)
        bits = v.view(torch.int32) == pv.view(torch.int32)
        diff = torch.where(bits, 0.0, (v - pv).abs().nan_to_num(nan=float("inf")))
        err = float(diff.max()) if diff.numel() else 0.0
        return torch.equal(i, pi) and bool(bits.all()), err

    for case in TOPK_CASES:
        x, k = topk_case(case, seed)
        if not same(torch.from_numpy(x).to(dev), k)[0]:
            fail(f"phase 2n (a): kernel K differs from its plain version on the case {case}")
    out = {"cases": list(TOPK_CASES)}
    for name, (n, k) in TOPK_SHAPES.items():
        x = _phase_scores(name, runs, dev)
        equal, err = same(x, k) if x.shape == (TOPK_ROWS, n) else (False, float("inf"))
        if not equal:
            fail(f"phase 2n (a): kernel K differs from its plain version at {name}'s shape "
                 f"(max abs err {err})")
        ms = time_ms(lambda: topk_select(x, k), 10)
        plain_ms = time_ms(lambda: topk_select_plain(x, k), 3)
        lib_ms = time_ms(lambda: torch.topk(x, k, dim=1), 10)
        n_bytes = x.numel() * 4 + TOPK_ROWS * k * (4 + 8)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": n_bytes,
                     "max_abs_err": err,
                     "bound": bound(n_bytes, 0, F32_FLOPS),
                     "shape": f"{TOPK_ROWS} rows x {n} f32 scores of phase 2n's {name}, k={k}"}
        log(f"phase 2n (a) K at {name} ({TOPK_ROWS} x {n}, k={k}): {ms:.4f} ms (plain "
            f"{plain_ms:.3f}, torch.topk {lib_ms:.4f}), bound {out[name]['bound'][0]:.4f} "
            f"({out[name]['bound'][1]}), bit-equal to the plain version [{card}]")
        del x
    return out


def nn_rec_phase(kernels, seed: int, dev, card: str) -> dict:
    """Phase 2n: the main path -- (b) KNN and ConditionalKNN, (c) SAR, (d)
    AccessAnomaly -- with every launch count set to 0 just before it and
    read just after, then (a) kernel K against its plain version."""
    reset(kernels)
    runs = {"knn": knn_run(seed, card), "cknn": cknn_run(seed, card)}
    nn_counts = counts(kernels)
    runs["sar"] = sar_run(seed, dev, card)
    sar_counts = counts(kernels)
    anomaly = anomaly_run(seed, dev, card)
    path_counts = counts(kernels)
    for name in PHASE_2N_KERNELS:
        if nn_counts[name] < 1 or sar_counts[name] - nn_counts[name] < 1:
            fail(f"phase 2n: {name} did not launch in both (b) and (c): "
                 f"{nn_counts[name]}, {sar_counts[name] - nn_counts[name]}")
    log(f"phase 2n launches: { {k: v for k, v in path_counts.items() if v} }")
    topk = topk_rows(runs, seed, dev, card)
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("model", "queries", "conditioners")}
    return {"knn": strip(runs["knn"]), "cknn": strip(runs["cknn"]), "sar": strip(runs["sar"]),
            "anomaly": anomaly, "topk": topk, "launches": path_counts,
            "launches_knn": nn_counts["topk_select"],
            "launches_sar": sar_counts["topk_select"] - nn_counts["topk_select"]}


def dataclasses_asdict(obj) -> dict:
    import dataclasses

    return dataclasses.asdict(obj)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    run_t0 = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only on the GPU",
              file=sys.stderr)
        return 2

    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.binning import BinMapper, torch_bin_dtype
    from synapseml_tpu_torch.gbdt.boost import GBDTBooster, _preround, _sigmoid
    from synapseml_tpu_torch.gbdt.device_predict import (device_bin_cat,
                                                         device_bin_cat_plain,
                                                         device_leaf_indices,
                                                         device_raw_scores,
                                                         leaf_indices_plain,
                                                         pack_feature_table, pack_trees,
                                                         raw_scores_plain)
    from synapseml_tpu_torch.gbdt.estimators import (LightGBMClassificationModel,
                                                     LightGBMClassifier)
    from synapseml_tpu_torch.gbdt.histogram import (HIST_ROWS_TRACE, SIBLING_TRACE, histogram,
                                                    histogram_plain, histogram_rows,
                                                    histogram_rows_plain, sibling,
                                                    sibling_plain)
    from synapseml_tpu_torch.gbdt.partition import PARTITION_TRACE, RowPartition, partition_plain
    from synapseml_tpu_torch.gbdt.lambdarank import (QueryGroups, cell_count, lambda_grads,
                                                     lambda_grads_plain, pair_count)
    from synapseml_tpu_torch.gbdt.split_search import (SplitWorkspace, left_set,
                                                       split_gains_plain, split_search,
                                                       split_search_plain)
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.kernels.build import build
    from synapseml_tpu_torch.parallel.flash import (KEY_TILE_BY_HEAD_DIM, dense_attention,
                                                    flash_attention, kernel_for)
    from synapseml_tpu_torch.runtime.device import card_info
    from synapseml_tpu_torch.tools.kernel_cases import (bin_edge_case, bin_ragged_case,
                                                        check_left_sets, check_offgrid,
                                                        diff_runs, grow_synthetic,
                                                        offgrid_split_case, split_cases,
                                                        step_cases)
    from synapseml_tpu_torch.tools.schema_data import (ADULT_CATEGORICAL, COVTYPE_CLASSES,
                                                       FITS, SAMPLED_MODES, adult_rows,
                                                       adult_unseen_codes, covertype_rows,
                                                       higgs_width_rows)
    from synapseml_tpu_torch.tools.score_bench import (INT32_LANES_PER_SM, N_SMS,
                                                       max_sm_clock_hz, path_visits,
                                                       random_trees, tree_bound, tree_bytes)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_info()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # -- phase 1: build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build_log: list = []
    libs = build(log=build_log)
    print("\n".join(build_log), file=sys.stderr, flush=True)
    log(f"phase 1 build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    kernels = all_kernels()
    GBDT, adult_gbdt, cov_gbdt = (FITS[key][2] for key in ("higgs", "adult", "covertype"))

    def split_steps(params, classes=1):
        """Growth steps of a fit: one launch of kernel E's step entry each."""
        return params["num_iterations"] * classes * (params["num_leaves"] - 1)

    # -- phase 2: main path, LightGBMClassifier fit -> transform ------------------------
    t0 = time.perf_counter()
    x, y = higgs_width_rows(args.seed, N_TRAIN + N_TEST)
    x_tr, y_tr, x_te, y_te = x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:], y[N_TRAIN:]
    train_table = Table({"features": x_tr, "label": y_tr})
    test_table = Table({"features": x_te})
    log(f"phase 2 data: {N_TRAIN}+{N_TEST} x {N_FEATURES} in "
        f"{time.perf_counter() - t0:.1f} s")

    model, out, fit_s, transform_s, fit_launches, transform_launches = fit_and_transform(
        kernels, LightGBMClassifier(**GBDT), train_table, test_table)
    gbdt_launches = {name: fit_launches[name] + transform_launches[name] for name in kernels}
    log(f"phase 2 launches: fit {fit_launches}, transform {transform_launches}")
    for name in ("gbdt_histogram", "gbdt_histogram_rows", "gbdt_partition", "gbdt_sibling",
                 "gbdt_split_search", "gbdt_bin_features"):
        if fit_launches[name] < 1:
            fail(f"the main path's fit never launched {name}")
    for name in ("gbdt_split_search", "gbdt_partition", "gbdt_histogram_rows", "gbdt_sibling"):
        if fit_launches[name] != split_steps(GBDT):
            fail(f"{name} launched {fit_launches[name]} times in the fit, not once a split "
                 f"step ({split_steps(GBDT)})")
    if fit_launches["gbdt_histogram"] != GBDT["num_iterations"]:
        fail(f"kernel A's full entry launched {fit_launches['gbdt_histogram']} times in the "
             f"fit, not once a tree (the root)")
    for name in ("gbdt_tree_score", "gbdt_bin_features"):
        if transform_launches[name] < 1:
            fail(f"the main path's transform never launched {name}")

    prob = np.asarray(out["probability"])
    raw = np.asarray(out["rawPrediction"])
    if prob.shape != (N_TEST, 2) or raw.shape != (N_TEST, 2):
        fail(f"transform shapes {prob.shape}, {raw.shape}; expected ({N_TEST}, 2)")
    if not (np.isfinite(prob).all() and np.isfinite(raw).all()):
        fail("non-finite scores")
    booster = model.booster
    if booster.num_trees != GBDT["num_iterations"]:
        fail(f"{booster.num_trees} trees for {GBDT['num_iterations']} iterations")
    test_auc = auc(y_te, prob[:, 1])
    log(json.dumps({"phase": "gbdt_main_path", "rows_train": N_TRAIN, "rows_test": N_TEST,
                    "features": N_FEATURES, **GBDT, "fit_s": fit_s,
                    "transform_s": transform_s, "fit_rows_per_s": N_TRAIN / fit_s,
                    "transform_rows_per_s": N_TEST / transform_s,
                    "heldout_auc": test_auc}))
    if not test_auc > 0.9:
        fail(f"held-out AUC {test_auc:.4f} <= 0.9")

    # the same fit on a small slice, on the card and through the plain CPU path
    n_small = SMALL_FIT_ROWS
    small_err = small_fit_same_trees(LightGBMClassifier, dict(GBDT, num_iterations=3),
                                     x_tr[:n_small], y_tr[:n_small], x_te[:n_small])
    log(f"phase 2 small fit card vs CPU: identical trees, raw max|diff| {small_err:.3g}")
    if not small_err <= 1e-4:
        fail(f"small fit: raw scores differ by {small_err} (> 1e-4) between card and CPU")

    # -- phase 2b: categorical features, Adult Census schema ----------------------------
    t0 = time.perf_counter()
    x_a, y_a, p_a = adult_rows(args.seed, N_ADULT_TRAIN + N_ADULT_TEST)
    xa_tr, ya_tr = x_a[:N_ADULT_TRAIN], y_a[:N_ADULT_TRAIN]
    xa_te = adult_unseen_codes(x_a[N_ADULT_TRAIN:], args.seed + 1, 0.005)
    ya_te = y_a[N_ADULT_TRAIN:]
    label_auc = auc(ya_te, p_a[N_ADULT_TRAIN:])
    del x_a, y_a, p_a
    log(f"phase 2b data: {N_ADULT_TRAIN}+{N_ADULT_TEST} x 14 in "
        f"{time.perf_counter() - t0:.1f} s")
    model_a, out_a, fit_a, trans_a, fit_la, trans_la = fit_and_transform(
        kernels, LightGBMClassifier(**adult_gbdt), Table({"features": xa_tr, "label": ya_tr}),
        Table({"features": xa_te}))
    prob_a = np.asarray(out_a["probability"])
    adult_auc = auc(ya_te, prob_a[:, 1])
    n_cat_splits = int(((model_a.booster.bin < 0) & (model_a.booster.parent >= 0)).sum())
    small_err_a = small_fit_same_trees(LightGBMClassifier, dict(adult_gbdt, num_iterations=3),
                                       xa_tr[:n_small], ya_tr[:n_small], xa_te[:n_small])
    adult = {"phase": "gbdt_adult_cat", "rows_train": N_ADULT_TRAIN, "rows_test": N_ADULT_TEST,
             "features": 14, "categorical": len(ADULT_CATEGORICAL), **adult_gbdt,
             "fit_s": fit_a, "transform_s": trans_a,
             "transform_rows_per_s": N_ADULT_TEST / trans_a,
             "heldout_auc": adult_auc, "label_probability_auc": label_auc,
             "auc_floor": ADULT_AUC_FLOOR,
             "categorical_splits": n_cat_splits, "fit_launches": fit_la,
             "transform_launches": trans_la, "small_fit_raw_max_diff": small_err_a}
    log(json.dumps(adult))
    if prob_a.shape != (N_ADULT_TEST, 2) or not np.isfinite(prob_a).all():
        fail(f"adult transform: probability {prob_a.shape}, finite {np.isfinite(prob_a).all()}")
    if not adult_auc > ADULT_AUC_FLOOR:
        fail(f"adult held-out AUC {adult_auc:.4f} <= {ADULT_AUC_FLOOR}")
    if n_cat_splits < 1 or model_a.booster.cat_set is None:
        fail("adult fit took no categorical split")
    for name in ("gbdt_bin_features", "gbdt_split_search", "gbdt_histogram",
                 "gbdt_histogram_rows", "gbdt_partition", "gbdt_sibling"):
        if fit_la[name] < 1:
            fail(f"the adult fit never launched {name}")
    if fit_la["gbdt_split_search"] != split_steps(adult_gbdt):
        fail(f"kernel E launched {fit_la['gbdt_split_search']} times in the adult fit, not "
             f"once a split step ({split_steps(adult_gbdt)})")
    for name in ("gbdt_bin_features", "gbdt_tree_score"):
        if trans_la[name] < 1:
            fail(f"the adult transform never launched {name}")
    if not small_err_a <= 1e-4:
        fail(f"adult small fit: raw scores differ by {small_err_a} (> 1e-4) card vs CPU")
    del out_a, prob_a

    # -- phase 2c: multiclass, Covertype schema -----------------------------------------
    x_c, y_c, logit_c = covertype_rows(args.seed, N_COVTYPE)
    label_acc = float((logit_c[N_COVTYPE_TRAIN:].argmax(1) == y_c[N_COVTYPE_TRAIN:]).mean())
    xc_tr, yc_tr = x_c[:N_COVTYPE_TRAIN], y_c[:N_COVTYPE_TRAIN]
    xc_te, yc_te = x_c[N_COVTYPE_TRAIN:], y_c[N_COVTYPE_TRAIN:]
    model_c, out_c, fit_c, trans_c, fit_lc, trans_lc = fit_and_transform(
        kernels, LightGBMClassifier(**cov_gbdt), Table({"features": xc_tr, "label": yc_tr}),
        Table({"features": xc_te}))
    prob_c = np.asarray(out_c["probability"])
    acc_c = float((np.asarray(out_c["prediction"]) == yc_te).mean())
    bc = model_c.booster
    small_err_c = small_fit_same_trees(LightGBMClassifier, dict(cov_gbdt, num_iterations=2),
                                       xc_tr[:n_small], yc_tr[:n_small], xc_te[:n_small],
                                       col="probability")
    n_cov_test = N_COVTYPE - N_COVTYPE_TRAIN
    cov = {"phase": "gbdt_covertype_multiclass", "rows_train": N_COVTYPE_TRAIN,
           "rows_test": n_cov_test, "features": 12, "classes": COVTYPE_CLASSES, **cov_gbdt,
           "trees": int(bc.parent.shape[0] * bc.parent.shape[1]),
           "fit_s": fit_c, "transform_s": trans_c,
           "transform_rows_per_s": n_cov_test / trans_c,
           "heldout_accuracy": acc_c, "label_logit_accuracy": label_acc,
           "accuracy_floor": COVTYPE_ACC_FLOOR,
           "categorical_splits": int(((bc.bin < 0) & (bc.parent >= 0)).sum()),
           "fit_launches": fit_lc, "transform_launches": trans_lc,
           "small_fit_prob_max_diff": small_err_c}
    log(json.dumps(cov))
    if bc.num_class != COVTYPE_CLASSES or bc.parent.shape[:2] != (10, COVTYPE_CLASSES):
        fail(f"covertype booster: {bc.num_class} classes, trees {bc.parent.shape}")
    if prob_c.shape != (n_cov_test, COVTYPE_CLASSES) or not np.isfinite(prob_c).all():
        fail(f"covertype transform: probability {prob_c.shape}")
    if not acc_c > COVTYPE_ACC_FLOOR:
        fail(f"covertype held-out accuracy {acc_c:.4f} <= {COVTYPE_ACC_FLOOR}")
    for name in ("gbdt_split_search", "gbdt_histogram", "gbdt_histogram_rows",
                 "gbdt_partition", "gbdt_sibling", "gbdt_bin_features"):
        if fit_lc[name] < 1:
            fail(f"the covertype fit never launched {name}")
    if fit_lc["gbdt_split_search"] != split_steps(cov_gbdt, COVTYPE_CLASSES):
        fail(f"kernel E launched {fit_lc['gbdt_split_search']} times in the covertype fit, "
             f"not once a split step ({split_steps(cov_gbdt, COVTYPE_CLASSES)})")
    if trans_lc["gbdt_tree_score"] < 1:
        fail("the covertype transform never launched gbdt_tree_score")
    if not small_err_c <= 1e-5:
        fail(f"covertype small fit: probabilities differ by {small_err_c} card vs CPU")
    del out_c, prob_c, x_c, y_c, logit_c

    # -- phase 2d: training controls at HIGGS width -------------------------------------
    t0 = time.perf_counter()
    sampled = sampled_fits(kernels, GBDT, x_tr, y_tr, x_te, y_te, split_steps, dev)
    small_sampled = {}
    for mode, extra in SAMPLED_MODES.items():
        params = dict(GBDT, **extra, num_iterations=3)
        xs, ys, val = x_tr[:n_small], y_tr[:n_small], None
        if mode == "bagged_eval":
            params["validation_indicator_col"] = "validation"
            xs = np.concatenate([xs, x_te[:n_small // 4]])
            ys = np.concatenate([ys, y_te[:n_small // 4]])
            val = np.arange(len(ys)) >= n_small
        small_sampled[mode] = small_fit_same_trees(LightGBMClassifier, params, xs, ys,
                                                   x_te[:n_small], validation=val)
        if not small_sampled[mode] <= 1e-4:
            fail(f"{mode} small fit: raw scores differ by {small_sampled[mode]} card vs CPU")
    log(json.dumps({"phase": "gbdt_sampled_small_fits", "rows": n_small,
                    "identical_trees_card_cpu": sorted(small_sampled),
                    "raw_max_diff": small_sampled,
                    "phase_s": time.perf_counter() - t0}))

    # -- phase 2e: LightGBMRanker at MSLR-WEB30K width, and the model surface ---------------
    t0 = time.perf_counter()
    ranker = ranker_phase(kernels, args.seed, split_steps)
    surface = model_surface(kernels, model, model_a, x_te, xa_te)
    log(f"phase 2e in {time.perf_counter() - t0:.1f} s")

    # -- phase 2f: partitioned growth against the full pass; continued and batch training -
    t0 = time.perf_counter()
    leaf_local = leaf_local_phase(kernels, GBDT, x_tr, y_tr, x_te, split_steps)
    log(f"phase 2f in {time.perf_counter() - t0:.1f} s")

    # -- phase 2g: sparse input, hashed text at Amazon Review Polarity's schema ---------
    t0 = time.perf_counter()
    hashed = hashed_text_phase(kernels, args.seed, split_steps)
    log(f"phase 2g in {time.perf_counter() - t0:.1f} s")

    # -- phase 2h: GBDTDataset reuse, and TrainClassifier -> ComputeModelStatistics ----
    t0 = time.perf_counter()
    dataset_phase(kernels, args.seed, GBDT, x_tr, y_tr, fit_s, split_steps, dev)
    train_classifier_phase(kernels, args.seed, split_steps)
    log(f"phase 2h in {time.perf_counter() - t0:.1f} s")

    # -- phase 2i: the mesh: one rank over NCCL, two ranks on one card over gloo --------
    t0 = time.perf_counter()
    mesh_a = nccl_one_rank_phase(kernels, GBDT, train_table, booster, fit_s, split_steps)
    torch.cuda.empty_cache()
    mesh_b = two_ranks_one_card_phase(args.seed)
    binned_2i = booster.mapper.transform_torch(torch.from_numpy(x_tr).to(dev))
    mesh_rows = mesh_entry_rows(binned_2i, booster.mapper.n_bins, leaf_local["booster"],
                                hashed, args.seed, dev)
    del binned_2i
    log(f"phase 2i in {time.perf_counter() - t0:.1f} s")

    # -- phase 2j: the VW learner: fit -> transform, kernel V, the mesh ------------------
    t0 = time.perf_counter()
    vw, vw_col = vw_phase(kernels, hashed)
    vw_steps = vw_step_checks(vw_col, hashed["y_tr"], dev)
    vw_rows = vw_mesh_rows(vw_col, hashed["y_tr"])
    del vw_col
    vw_nccl = vw_nccl_one_rank(kernels, *vw_rows)
    torch.cuda.empty_cache()
    vw_two = vw_two_ranks_phase(vw_rows)
    del vw_rows
    log(f"phase 2j in {time.perf_counter() - t0:.1f} s")

    # -- phase 2k: the ONNX executor: ResNet-50, BERT-base, quantized, LSTM / GRU ---------
    t0 = time.perf_counter()
    onnx = onnx_phase(kernels, args.seed)
    torch.cuda.empty_cache()
    log(f"phase 2k in {time.perf_counter() - t0:.1f} s")

    # -- phase 2l: sequence-parallel attention, tensor-parallel ONNX, topology -----------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    lse_rows = lse_phase(gen, dev)
    sp_one = sp_one_rank_phase(kernels, gen, dev)
    sp_two = sp_two_ranks_phase(args.seed)
    tp_two = tp_two_ranks_phase(args.seed)
    conv3d = topology_and_conv3d(dev)
    torch.cuda.empty_cache()
    log(f"phase 2l in {time.perf_counter() - t0:.1f} s")

    # -- phase 2m: images and featurization, the explainers (kernel L), the forest (B) ----
    t0 = time.perf_counter()
    expl = explainers_phase(kernels, args.seed, dev, card)
    torch.cuda.empty_cache()
    log(f"phase 2m in {time.perf_counter() - t0:.1f} s [{card}]")

    # -- phase 2n: KNN / ConditionalKNN, SAR, AccessAnomaly (kernel K) -------------------
    t0 = time.perf_counter()
    nnrec = nn_rec_phase(kernels, args.seed, dev, card)
    torch.cuda.empty_cache()
    log(f"phase 2n in {time.perf_counter() - t0:.1f} s [{card}]")

    # -- phase 3: flash attention's entry point -----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def qkv(B, S, H, H_kv, D, dtype):
        mk = lambda h: torch.randn(B, S, h, D, generator=gen, device=dev).to(dtype)
        return mk(H), mk(H_kv), mk(H_kv)

    flash_dtype = {**{key: torch.bfloat16 for key in FLASH_SHAPES},
                   **{key: torch.float32 for key in F32_SHAPES}}
    flash_shapes = {**FLASH_SHAPES, **F32_SHAPES}
    flash_in = {key: qkv(*shape, flash_dtype[key]) for key, shape in flash_shapes.items()}
    flash_names = sorted({kernel_for(flash_dtype[key], shape[-1]).name
                          for key, shape in flash_shapes.items()})
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    flash_out = {key: flash_attention(*t, causal=True) for key, t in flash_in.items()}
    torch.cuda.synchronize()
    flash_launches = {name: kernels[name].launches for name in flash_names}
    log(f"phase 3 flash launches: {flash_launches}")
    for name, n in flash_launches.items():
        if n < 1:
            fail(f"the flash entry point never launched {name}")

    # -- phase 4: each kernel against its plain version, and timed ----------------------
    rows = []

    def record(name, launches, err, ms, plain_ms, b, library_ms, **extra):
        k = kernels[name]
        # launches in phase 2d's fit and transform of each training control
        per_mode = {mode: r["fit_launches"][name] + r["transform_launches"][name]
                    for mode, r in sampled["fits"].items()}
        if any(per_mode.values()):
            extra["launches_sampled_fits"] = per_mode
        rows.append({"name": name, "route": "cuda",
                     "source": f"synapseml_tpu_torch/csrc/{k.source}.cu",
                     "replaces": k.replaces.split()[0], "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms,
                     **extra})
        log(json.dumps({"kernel": rows[-1]}))

    # A: gradient histogram at the fit's shape, on the pre-rounded gradients
    # after the last iteration, at three weightings: half the rows (0/1, as
    # in PR 1's timing), every row at weight 1 (a root histogram, 10 of a
    # fit's launches) and a child of about 1/16 of the rows (a split step).
    # A row is live (its bins are read) iff w != 0 or g or h is not finite.
    mapper = booster.mapper
    T, C, S = booster.parent.shape
    tree_args = [torch.from_numpy(a).to(dev).contiguous() for a in (
        booster.parent, booster.feature, booster.bin, booster.leaf_value,
        booster.tree_scale.astype(np.float32))]
    binned_tr = mapper.transform_torch(torch.from_numpy(x_tr).to(dev))
    n_bins = mapper.n_bins
    y_d = torch.from_numpy(y_tr).to(dev, torch.float32)
    p0 = _sigmoid(device_raw_scores(binned_tr, *tree_args)[:, 0]
                  + float(booster.base_score[0]))
    n_bound = 1 << (N_TRAIN - 1).bit_length()
    g = _preround((p0 - y_d)[:, None], n_bound)[:, 0].contiguous()
    h = _preround((p0 * (1 - p0))[:, None], n_bound)[:, 0].contiguous()
    weightings = {
        "half": (binned_tr[:, 0].to(torch.int32) > n_bins // 2).to(torch.float32),
        "all": torch.ones(N_TRAIN, device=dev),
        "sixteenth": (binned_tr[:, 1].to(torch.int32) < n_bins // 16).to(torch.float32),
    }
    hist_runs = []
    for key, w in weightings.items():
        h_kern = histogram(binned_tr, g, h, w, n_bins)
        h_plain = histogram_plain(binned_tr, g, h, w, n_bins)
        if not torch.equal(h_kern, h_plain):
            fail(f"histogram kernel ({key} weighting) differs from the plain version by "
                 f"{float((h_kern - h_plain).abs().max())}")
        n_live = int(((w != 0) | ~torch.isfinite(g) | ~torch.isfinite(h)).sum())
        ms = time_ms(lambda: histogram(binned_tr, g, h, w, n_bins), 20)
        b = bound(12 * N_TRAIN + n_live * N_FEATURES * binned_tr.element_size()
                  + N_FEATURES * n_bins * 12, 2 * N_TRAIN + 3 * n_live * N_FEATURES, F32_FLOPS)
        hist_runs.append({"weighting": key, "n_live": n_live, "ms": ms, "bound_ms": b[0],
                          "bound_by": b[1]})
        log(json.dumps({"histogram": hist_runs[-1]}))
    # NaN in g and inf in h on rows of zero weight: those rows still count
    w = weightings["sixteenth"]
    dead = torch.nonzero(w == 0)[:64, 0]
    g_nf, h_nf = g.clone(), h.clone()
    g_nf[dead[:32]] = float("nan")
    h_nf[dead[32:]] = float("inf")
    h_kern = histogram(binned_tr, g_nf, h_nf, w, n_bins)
    h_plain = histogram_plain(binned_tr, g_nf, h_nf, w, n_bins)
    nan_cells = int(h_plain.isnan().sum())
    if not (nan_cells > 0 and torch.equal(h_kern.isnan(), h_plain.isnan())
            and torch.equal(h_kern.nan_to_num(), h_plain.nan_to_num())):
        fail(f"histogram kernel with non-finite g/h on zero-weight rows: NaN cells "
             f"{int(h_kern.isnan().sum())} against the plain version's {nan_cells}, or other "
             f"cells differ")
    log(f"phase 4 histogram non-finite: NaN in the same {nan_cells} cells, the rest bit-equal")
    del g_nf, h_nf
    w = weightings["half"]
    flat = (binned_tr.to(torch.int64)
            + torch.arange(N_FEATURES, device=dev)[None, :] * n_bins).reshape(-1)
    panel = torch.stack([g * w, h * w, w], dim=1)
    vals = panel[:, None, :].expand(N_TRAIN, N_FEATURES, 3).reshape(-1, 3).contiguous()
    h_lib = torch.zeros(N_FEATURES * n_bins, 3, device=dev)
    plain_ms = time_ms(lambda: histogram_plain(binned_tr, g, h, w, n_bins), 5)
    lib_ms = time_ms(lambda: h_lib.index_add_(0, flat, vals), 5)
    del flat, vals, h_lib, panel
    half = hist_runs[0]
    record("gbdt_histogram", gbdt_launches["gbdt_histogram"], 0.0, half["ms"], plain_ms,
           (half["bound_ms"], half["bound_by"]), lib_ms,
           shape=f"n={N_TRAIN} d={N_FEATURES} B={n_bins} {binned_tr.dtype}, half the rows live",
           weightings=hist_runs, nonfinite_nan_cells=nan_cells)

    # P and A's row list at four splits (leaf_splits): the fitted tree's
    # root split (every training row routed), its deepest split (scattered
    # ids, as the fit left them), and leaves of 1,024 and 40 rows drawn at
    # random. P against its plain version (a stable boolean-mask partition)
    # on the card: the same segments as sets (read from the buffer the state
    # names), counts, buffers, smaller child and node; then A's row list over
    # the split's smaller child (root, deep) or the whole leaf (1,024 and 40
    # rows listed), every row at weight 1 (a plain gbdt fit), bit-equal to
    # its plain version. Device times from a trace of 20 launches (P's
    # state restored before each). P's bound: per routed row its id read and
    # written (4 + 4 bytes), the split feature's bins gathered and node
    # written for the right rows, each counted as the distinct 32-byte
    # sectors it touches (gathered_bytes); library: the one torch call of a
    # stable partition, argsort of the side key. A's bound: per listed row
    # its id (4 bytes), its g, h and w and its row of bins gathered (sectors),
    # the output once; library: index_add_ over the gathered rows.
    lb = leaf_local["booster"]
    ones_w = weightings["all"]
    e_bin = binned_tr.element_size()
    splits = leaf_splits(binned_tr, n_bins, lb.parent[0, 0], lb.feature[0, 0], lb.bin[0, 0],
                         args.seed)
    p_runs, a_runs = {}, {}
    for key, (pk, nk, s, choice, ok_t, in_set) in splits.items():
        leaf, f = (int(v) for v in choice.tolist())
        snap = snapshot(pk, nk)
        pp = RowPartition(N_TRAIN, pk.num_leaves, dev)
        npl = torch.empty_like(nk)
        restore(pp, npl, snap)
        leaf_ids = pk.rows(leaf).clone()  # the split leaf's ids, as P reads them
        count = leaf_ids.numel()
        # A's list: the small leaves' own rows, else P's smaller child
        span = (torch.tensor([int(pk.seg[leaf, 0]), count, int(pk.side[leaf])],
                             dtype=torch.int32, device=dev)
                if key.startswith("rows_") else pk.small)
        pk.split(s, binned_tr, nk, choice, ok_t, in_set)
        partition_plain(pp, s, binned_tr, npl, choice, ok_t, in_set)
        if not same_split(pk, nk, pp, npl, (leaf, s + 1)):
            fail(f"kernel P differs from its plain version at the {key} split")
        n_left, n_right = (int(pp.seg[j, 1]) for j in (leaf, s + 1))

        def p_step():
            restore(pk, nk, snap)
            pk.split(s, binned_tr, nk, choice, ok_t, in_set)

        p_ms = kernel_times(lambda: [p_step() for _ in range(20)],
                            (PARTITION_TRACE,))[PARTITION_TRACE][0] / 20
        p_plain_ms = time_ms(lambda: (restore(pp, npl, snap), partition_plain(
            pp, s, binned_tr, npl, choice, ok_t, in_set)), 3)
        key_lr = (~in_set[binned_tr[leaf_ids.long(), f].to(torch.int64)]).to(torch.uint8)
        p_lib_ms = time_ms(lambda: torch.argsort(key_lr, stable=True), 5)
        p_bytes = (8 * count + gathered_bytes(leaf_ids, N_FEATURES * e_bin, f * e_bin, e_bin)
                   + gathered_bytes(pp.rows(s + 1), 4, 0, 4))
        p_runs[key] = {"rows_routed": count, "step": s, "leaf": leaf, "feature": f,
                       "left": n_left, "right": n_right, "ms": p_ms, "plain_ms": p_plain_ms,
                       "library_ms": p_lib_ms, "bytes_moved": p_bytes,
                       **dict(zip(("bound_ms", "bound_by"), bound(p_bytes, 0, F32_FLOPS)))}
        log(json.dumps({"partition": key, **p_runs[key]}))

        cnt = int(span[1])
        h_rows = histogram_rows(binned_tr, g, h, ones_w, n_bins, pk.ids, span)
        if not torch.equal(h_rows, histogram_rows_plain(binned_tr, g, h, ones_w, n_bins,
                                                        pk.ids, span)):
            fail(f"kernel A's row-list entry differs from its plain version over the {key} "
                 f"list")
        rows_ms = kernel_times(lambda: [histogram_rows(binned_tr, g, h, ones_w, n_bins,
                                                       pk.ids, span) for _ in range(20)],
                               (HIST_ROWS_TRACE,))[HIST_ROWS_TRACE][0] / 20
        rows_plain_ms = time_ms(lambda: histogram_rows_plain(binned_tr, g, h, ones_w, n_bins,
                                                             pk.ids, span), 3)
        b_s, c_s, buf = (int(v) for v in span)
        idx = pk.ids[buf, b_s:b_s + c_s].to(torch.int64)
        flat = (binned_tr[idx].to(torch.int64)
                + torch.arange(N_FEATURES, device=dev)[None, :] * n_bins).reshape(-1)
        vals = torch.stack([g[idx], h[idx], ones_w[idx]], 1)[:, None, :].expand(
            c_s, N_FEATURES, 3).reshape(-1, 3).contiguous()
        h_lib = torch.zeros(N_FEATURES * n_bins, 3, device=dev)
        rows_lib_ms = time_ms(lambda: h_lib.index_add_(0, flat, vals), 5)
        rows_bytes = (4 * cnt + 3 * gathered_bytes(idx, 4, 0, 4)
                      + gathered_bytes(idx, N_FEATURES * e_bin, 0, N_FEATURES * e_bin)
                      + N_FEATURES * n_bins * 12)
        a_runs[key] = {"rows_listed": cnt, "ms": rows_ms, "plain_ms": rows_plain_ms,
                       "library_ms": rows_lib_ms, "bytes_moved": rows_bytes,
                       **dict(zip(("bound_ms", "bound_by"),
                                  bound(rows_bytes, 3 * cnt * N_FEATURES, F32_FLOPS)))}
        log(json.dumps({"histogram_rows": key, **a_runs[key]}))
        del pp, npl, leaf_ids, key_lr, idx, flat, vals, h_lib, h_rows
    del splits
    root_p, root_a = p_runs["root"], a_runs["root"]
    record("gbdt_partition", gbdt_launches["gbdt_partition"], 0.0, root_p["ms"],
           root_p["plain_ms"], (root_p["bound_ms"], root_p["bound_by"]), root_p["library_ms"],
           bytes_moved=root_p["bytes_moved"],
           shape=f"root split of n={N_TRAIN} rows, {binned_tr.dtype} bins, feature "
                 f"{root_p['feature']}, {root_p['left']} left / {root_p['right']} right",
           splits=p_runs)
    record("gbdt_histogram_rows", gbdt_launches["gbdt_histogram_rows"], 0.0, root_a["ms"],
           root_a["plain_ms"], (root_a["bound_ms"], root_a["bound_by"]),
           root_a["library_ms"], bytes_moved=root_a["bytes_moved"],
           shape=f"the root split's smaller child: {root_a['rows_listed']} of n={N_TRAIN} "
                 f"rows listed, d={N_FEATURES} B={n_bins} {binned_tr.dtype}, every row at "
                 f"weight 1", splits=a_runs)

    # the step's epilogue at the fit's table (L leaves, d=28, B bins): the
    # sibling by subtraction against its plain version (the torch ops it
    # replaced), bit for bit and NaN for NaN, with NaN, +-inf and -0.0 in
    # the split leaf and the child, the smaller child on either side and an
    # inert step. Bound: bytes, small and the split leaf read, two leaves and
    # the zeroed small written. Library: the torch ops it replaced (the row
    # list's zeroed output, index_select, a subtraction, where, the copy into
    # leaf s + 1 and index_add_), their device time.
    L_fit = lb.parent.shape[-1] + 1
    sib_s, sib_leaf = L_fit - 2, L_fit // 3
    rng_e = np.random.default_rng(args.seed)
    hists0 = special_cells(rng_e, (L_fit, N_FEATURES, n_bins, 3), dev)
    small0 = special_cells(rng_e, (N_FEATURES, n_bins, 3), dev)
    leaf_t = torch.tensor([sib_leaf], device=dev)
    for case in ("smaller_right", "smaller_left", "inert"):
        right_t = torch.tensor([case != "smaller_left"], device=dev)
        small_c = torch.zeros_like(small0) if case == "inert" else small0
        outs = []
        for fn in (sibling, sibling_plain):
            hk, sk = hists0.clone(), small_c.clone()
            fn(hk, sk, leaf_t, right_t, sib_s)
            outs.append((hk, sk))
        (hk, sk), (hp, sp) = outs
        keep = ~hk.isnan()
        if not (torch.equal(keep, ~hp.isnan()) and torch.equal(hk[keep].view(torch.int32),
                                                               hp[keep].view(torch.int32))
                and not sk.view(torch.int32).any() and not sp.view(torch.int32).any()):
            fail(f"the sibling epilogue differs from its plain version ({case})")
    del outs, hk, sk, hp, sp, keep
    right_t = torch.tensor([False], device=dev)
    hk, sk = hists0.clone(), small0.clone()
    sib_ms = kernel_times(lambda: [sibling(hk, sk, leaf_t, right_t, sib_s) for _ in range(20)],
                          (SIBLING_TRACE,))[SIBLING_TRACE][0] / 20
    sib_plain_ms = time_ms(lambda: sibling_plain(hk, sk, leaf_t, right_t, sib_s), 20)

    def replaced_ops():
        torch.zeros(N_FEATURES, n_bins, 3, device=dev)
        child = torch.where(right_t, sk, torch.index_select(hk, 0, leaf_t)[0] - sk)
        hk[sib_s + 1] = child
        hk.index_add_(0, leaf_t, child[None], alpha=-1)

    sib_lib_ms = device_ms(replaced_ops, 20)
    sib_bytes = 5 * small0.numel() * 4
    record("gbdt_sibling", gbdt_launches["gbdt_sibling"], 0.0, sib_ms, sib_plain_ms,
           bound(sib_bytes, 2 * small0.numel(), F32_FLOPS), sib_lib_ms, bytes_moved=sib_bytes,
           shape=f"L={L_fit} d={N_FEATURES} B={n_bins} f32 table, leaf {sib_leaf} at step "
                 f"{sib_s}; checked smaller right, smaller left and inert")
    del hists0, small0, hk, sk
    del binned_tr, g, h, w, weightings, y_d, p0, h_kern, h_plain

    # B: tree scoring, both entries, at five shapes: (i) the fitted model on
    # the held-out rows; (ii) higgs500 and (iii) higgs500-cat, random trees of
    # LightGBM's Higgs experiment on the held-out rows binned at 255 bins
    # (bit-equal on the first TREE_CHECK_ROWS rows: the plain replay takes
    # 254 steps a tree); (iv) the fitted model's shape at C=3 and C=9.
    # Bound: bytes against one INT32 decision per node on each row's path.
    clock_hz = max_sm_clock_hz()
    int32_per_s = N_SMS * INT32_LANES_PER_SM * clock_hz
    log(f"phase 4 tree scoring: max SM clock {clock_hz / 1e6:.0f} MHz, "
        f"INT32 rate {int32_per_s:.4g} /s")
    binned_te = mapper.transform_torch(torch.from_numpy(x_te).to(dev))
    mapper_255 = BinMapper(max_bin=255).fit(x_te)
    binned_255 = mapper_255.transform_torch(torch.from_numpy(x_te).to(dev))
    rng = np.random.default_rng(args.seed)
    higgs = random_trees(rng, *HIGGS500, N_FEATURES, mapper_255.n_bins)
    tree_cases = {
        "fit10": (dict(parent=booster.parent, feature=booster.feature, bins=booster.bin,
                       leaf_value=booster.leaf_value, scale=booster.tree_scale,
                       cat_set=None), binned_te, N_TEST),
        "higgs500": (higgs, binned_255, TREE_CHECK_ROWS),
        "higgs500-cat": (random_trees(rng, *HIGGS500, N_FEATURES, mapper_255.n_bins,
                                      n_cat=4), binned_255, TREE_CHECK_ROWS),
        "fit10-c3": (random_trees(rng, T, 3, S + 1, N_FEATURES, mapper.n_bins), binned_te,
                     N_TEST),
        "fit10-c9": (random_trees(rng, T, 9, S + 1, N_FEATURES, mapper.n_bins), binned_te,
                     N_TEST),
    }
    tree_rows = {"gbdt_tree_score": {}, "gbdt_tree_leaf": {}}
    for key, (tr, binned, n_check) in tree_cases.items():
        lists = (tr["parent"], tr["feature"], tr["bins"])
        cats = tr["cat_set"]
        lv = torch.from_numpy(tr["leaf_value"]).to(dev)
        sc = torch.from_numpy(np.asarray(tr["scale"], dtype=np.float32)).to(dev)
        packed = pack_trees(*lists, cats, device=dev)
        scores = device_raw_scores(binned, *lists, lv, sc, cats, packed=packed)
        leaves = device_leaf_indices(binned, *lists, cats, packed=packed)
        sub = binned[:n_check]
        s_plain, s_plain_ms = timed_once(lambda: raw_scores_plain(sub, *lists, lv, sc, cats))
        l_plain, l_plain_ms = timed_once(lambda: leaf_indices_plain(sub, *lists, cats))
        if not torch.equal(scores[:n_check], s_plain):
            fail(f"tree-scoring kernel ({key}) differs from the plain version by "
                 f"{float((scores[:n_check] - s_plain).abs().max())}")
        if not torch.equal(leaves[:, :, :n_check], l_plain):
            fail(f"leaf kernel ({key}) differs from the plain version in "
                 f"{int((leaves[:, :, :n_check] != l_plain).sum())} leaf ids")
        visits = path_visits(leaves, packed.depth)
        if key == "higgs500":
            higgs_check = (scores.cpu().numpy(), l_plain.cpu().numpy())
        del leaves, scores, s_plain, l_plain
        reps = 50 if packed.shape[2] < 100 else 10
        times = {
            "gbdt_tree_score": (time_ms(lambda: device_raw_scores(
                binned, *lists, lv, sc, cats, packed=packed), reps), s_plain_ms),
            "gbdt_tree_leaf": (time_ms(lambda: device_leaf_indices(
                binned, *lists, cats, packed=packed), max(reps // 2, 1)), l_plain_ms)}
        T_, C_, S_ = packed.shape
        n_rows = binned.shape[0]
        for name, (ms, plain_ms) in times.items():
            b = tree_bound(tree_bytes(n_rows, N_FEATURES, binned.element_size(), packed,
                                      leaf=name == "gbdt_tree_leaf"), visits, int32_per_s)
            entry = {"shape": f"n={n_rows} d={N_FEATURES} T={T_} C={C_} S={S_} "
                              f"{binned.dtype}" + (" 4 categorical" if cats is not None else ""),
                     "ms": ms, "plain_ms": plain_ms, "plain_rows": n_check, "visits": visits,
                     "bound_ms": b[0], "bound_by": b[1], "max_abs_err": 0.0}
            log(json.dumps({"tree": key, "kernel": name, **entry}))
            if not ms >= b[0]:
                fail(f"{name} {key}: {ms} ms is under its bound {b[0]} ms")
            tree_rows[name][key] = entry
        torch.cuda.empty_cache()
    del binned_te

    # (v) end to end: a classification model around (ii)'s trees and the
    # 255-bin mapper, transform with and without leaf_prediction_col
    zeros = np.zeros(higgs["parent"].shape)
    higgs_booster = GBDTBooster(
        mapper=mapper_255, objective="binary", num_class=1, base_score=0.0,
        parent=higgs["parent"], feature=higgs["feature"], threshold=zeros,
        bin_=higgs["bins"], gain=zeros.astype(np.float32), leaf_value=higgs["leaf_value"],
        leaf_hess=np.zeros_like(higgs["leaf_value"]), tree_scale=higgs["scale"])
    LightGBMClassificationModel(booster=higgs_booster).transform(
        Table({"features": x_te[:1024]}))  # packs the trees once
    e2e = {}
    for leaf_col in (None, "leaves"):
        model_h = LightGBMClassificationModel(booster=higgs_booster, leaf_prediction_col=leaf_col)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_h = model_h.transform(test_table)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: kernels[name].launches for name in tree_rows}
        run = "with_leaf_col" if leaf_col else "scores_only"
        e2e[run] = {"transform_s": wall, "rows_per_s": N_TEST / wall, "launches": counts}
        log(json.dumps({"phase": "gbdt_higgs500_transform", "leaf_prediction_col": leaf_col,
                        **e2e[run]}))
        if counts["gbdt_tree_score"] < 1 or (leaf_col and counts["gbdt_tree_leaf"] < 1):
            fail(f"higgs500 transform ({run}) launched {counts}")
        if not np.array_equal(np.asarray(out_h["rawPrediction"])[:, 1], higgs_check[0][:, 0]):
            fail("higgs500 transform: rawPrediction differs from kernel B's scores")
        if leaf_col:
            got = np.asarray(out_h["leaves"])
            if got.shape != (N_TEST, HIGGS500[0]) or got.dtype != np.float64 or not \
                    np.array_equal(got[:TREE_CHECK_ROWS].T, higgs_check[1][:, 0]):
                fail(f"higgs500 transform: leaf column {got.shape} {got.dtype} differs "
                     f"from the plain version's leaf ids")
        del out_h
    leaf_launches = e2e["with_leaf_col"]["launches"]["gbdt_tree_leaf"]
    for name, launches in (("gbdt_tree_score", gbdt_launches["gbdt_tree_score"]),
                           ("gbdt_tree_leaf", leaf_launches)):
        main = tree_rows[name]["fit10"]
        record(name, launches, 0.0, main["ms"], main["plain_ms"],
               (main["bound_ms"], main["bound_by"]), None, shape=main["shape"],
               visits=main["visits"], shapes=tree_rows[name],
               higgs500_transform=e2e)
    del binned_255

    # D: device binning at the two fits' rows (HIGGS width, int8; Adult
    # schema with 8 categorical columns, int16) and on the edge cases at each
    # output type. Bound: read each f32 once, write each bin once. Library:
    # the one torch.searchsorted over the f32 table, on rows already
    # transposed to (d, n), that the port used before (numeric features).
    bin_shapes = {}
    for key, (m, xs) in {"higgs_fit": (mapper, x_tr),
                         "adult_fit": (model_a.booster.mapper, xa_tr)}.items():
        xd = torch.from_numpy(xs).to(dev)
        table, lens, flags = m.device_table(dev)
        out_dt = torch_bin_dtype(m.n_bins)
        run = lambda: device_bin_cat(xd, table, lens, flags, m.missing_bin, out_dt)
        got = run()
        want, plain_ms = timed_once(lambda: device_bin_cat_plain(xd, table, lens, flags,
                                                                 m.missing_bin, out_dt))
        if not torch.equal(got, want):
            fail(f"binning kernel ({key}) differs from the plain version in "
                 f"{int((got != want).sum())} bins")
        del want
        ms = time_ms(run, 20)
        xt_d = xd.t().contiguous()
        lib_ms = time_ms(lambda: torch.searchsorted(table, xt_d, side="left"), 20)
        n_rows, d = xs.shape
        b = bound(n_rows * d * (4 + got.element_size()), 0, F32_FLOPS)
        bin_shapes[key] = {"shape": f"n={n_rows} d={d} Emax={table.shape[1]} {got.dtype}"
                                    f" {int(flags.sum())} categorical",
                           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": b[0], "bound_by": b[1], "max_abs_err": 0.0}
        log(json.dumps({"binning": key, **bin_shapes[key]}))
        del xd, xt_d, got
    m_edge, probe = bin_edge_case(args.seed + 5)
    edge_args = [torch.from_numpy(a).to(dev) for a in (probe, *pack_feature_table(m_edge))]
    host_bins = m_edge.transform(probe)
    for out_dt in (torch.int8, torch.int16, torch.int32):
        got = device_bin_cat(*edge_args, m_edge.missing_bin, out_dt)
        if not (torch.equal(got, device_bin_cat_plain(*edge_args, m_edge.missing_bin, out_dt))
                and np.array_equal(got.cpu().numpy(), host_bins)):
            fail(f"binning kernel differs from the plain version on the edge cases ({out_dt})")
    # ragged tails: n*d not a multiple of the 4 elements a thread loads at once
    for n_rows, d in ((1001, 1), (4099, 13), (333, 300)):
        m_r, x_r = bin_ragged_case(n_rows, d, args.seed + 7)
        xr = torch.from_numpy(x_r).to(dev)
        table, lens, flags = m_r.device_table(dev)
        for out_dt in (torch.int8, torch.int16, torch.int32):
            got = device_bin_cat(xr, table, lens, flags, m_r.missing_bin, out_dt)
            if not torch.equal(got, device_bin_cat_plain(xr, table, lens, flags,
                                                         m_r.missing_bin, out_dt)):
                fail(f"binning kernel differs from the plain version at n={n_rows} d={d} "
                     f"({out_dt})")
    log("phase 4 binning edge cases and ragged tails (d = 1, 13, 300): bit-equal at int8, "
        "int16 and int32")
    main_b = bin_shapes["higgs_fit"]
    record("gbdt_bin_features", gbdt_launches["gbdt_bin_features"], 0.0, main_b["ms"],
           main_b["plain_ms"], (main_b["bound_ms"], main_b["bound_by"]),
           main_b["library_ms"], shape=main_b["shape"], shapes=bin_shapes,
           launches_adult_fit=fit_la["gbdt_bin_features"],
           launches_covertype_fit=fit_lc["gbdt_bin_features"])

    # E: split search. Both entries on the card: the full table bit-equal on
    # histograms on the pre-rounded grid and, off the grid, the same split
    # wherever the runner-up is more than one ulp below the best; the step
    # entry (the one the fits launch, once a split step) bit-equal to the
    # plain step over every step of whole trees. Timed at the three fits'
    # shapes (L=31; HIGGS d=28 B=64; Adult d=14 B=256, 8 categorical;
    # Covertype d=12 B=256, 2 categorical): device time from the profiler,
    # and time a call from the host (events over back-to-back calls). The
    # step is timed at step 15 of a grown tree, which rescores two leaves.
    # Bound: the histograms the call reads, once (12 bytes a cell); launch
    # latency, not the card, sets the time, and in a fit the host's cost.
    cases = split_cases(args.seed)
    for key, (hh, fm, cm, n_active, cfg) in cases.items():
        t_args = [None if a is None else torch.from_numpy(a).to(dev) for a in (hh, fm, cm)]
        got = split_search(*t_args, n_active, cfg)
        want = split_search_plain(*t_args, n_active, cfg)
        for a, w_, what in zip(got, want, ("gain", "feature", "bin")):
            if not (torch.equal(a.isnan(), w_.isnan())
                    and torch.equal(a.nan_to_num(), w_.nan_to_num())):
                fail(f"split kernel ({key}) differs from the plain version in {what}")
        check_left_sets(t_args[0], t_args[2], n_active, cfg, got)
    hh, fm, cm, n_active, cfg = offgrid_split_case(args.seed + 1)
    t_args = [torch.from_numpy(a).to(dev) for a in (hh, fm, cm)]
    held, close = check_offgrid(split_gains_plain(*t_args, cfg),
                                split_search(*t_args, n_active, cfg))
    steps_by_case = step_cases(args.seed)
    workspaces = {}
    for key, (hh, fm, cm, _, cfg) in steps_by_case.items():
        runs = []
        for on in (dev, torch.device("cpu")):
            t_args = [None if a is None else torch.from_numpy(a).to(on) for a in (hh, fm, cm)]
            ws = SplitWorkspace(t_args[0].shape[1], t_args[1], t_args[2], cfg, on)
            runs.append(grow_synthetic(ws, t_args[0]))
            if on.type == "cuda":
                workspaces[key] = (ws, t_args)
        differ = diff_runs(*runs)
        if differ:
            fail(f"split step kernel ({key}) differs from the plain step in {differ}")
    log(f"phase 4 split search: full table bit-equal on {sorted(cases)}; off the grid the "
        f"same split in {held} leaves, {close} with a runner-up within one ulp; the step "
        f"entry bit-equal to the plain step over whole trees on {sorted(steps_by_case)}")
    split_shapes = {}
    for key in ("numeric", "mixed_cat", "covertype"):
        hh, fm, cm, n_active, cfg = cases[key]
        t_args = [None if a is None else torch.from_numpy(a).to(dev) for a in (hh, fm, cm)]
        ws, _ = workspaces[key]
        s_t = 15
        n_scored = 2 if int(ws.record.parent[s_t - 1]) >= 0 else 1

        def plain_step():
            """The step as torch ops on the card: every active leaf scored,
            the argmax over leaves and the left set of the choice."""
            gain, feat, bins = split_search_plain(ws.hists, ws.fmask, ws.cmask, s_t + 1, cfg)
            leaf = torch.argmax(gain)
            f_sel = feat[leaf].long()
            is_cat = (ws.cmask[f_sel] > 0) if ws.cmask is not None else torch.tensor(
                False, device=dev)
            return left_set(ws.hists[leaf, f_sel], is_cat, bins[leaf], cfg)

        kern = lambda: split_search(*t_args, n_active, cfg)
        plain = lambda: split_search_plain(*t_args, n_active, cfg)
        step = lambda: ws.step(s_t)
        ms, plain_ms = device_ms(kern, 100), device_ms(plain, 20)
        call_ms, plain_call_ms = time_ms(kern, 200), time_ms(plain, 20)
        step_ms, plain_step_ms = device_ms(step, 200), device_ms(plain_step, 20)
        step_call_ms, plain_step_call_ms = time_ms(step, 500), time_ms(plain_step, 20)
        L_, d_, B_, _ = hh.shape
        b = bound(L_ * d_ * B_ * 12, 0, F32_FLOPS)
        b_step = bound(n_scored * d_ * B_ * 12, 0, F32_FLOPS)
        split_shapes[key] = {"shape": f"L={L_} d={d_} B={B_}" + (
            f" {int(cm.sum())} categorical" if cm is not None else ""), "ms": ms,
            "plain_ms": plain_ms, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": b[0], "bound_by": b[1], "step_ms": step_ms,
            "plain_step_ms": plain_step_ms, "step_call_ms": step_call_ms,
            "plain_step_call_ms": plain_step_call_ms, "step_leaves_scored": n_scored,
            "step_bound_ms": b_step[0], "step_bound_by": b_step[1], "max_abs_err": 0.0}
        log(json.dumps({"split_search": key, **split_shapes[key]}))
    del workspaces
    main_e = split_shapes["numeric"]
    record("gbdt_split_search", gbdt_launches["gbdt_split_search"], 0.0, main_e["step_ms"],
           main_e["plain_step_ms"], (main_e["step_bound_ms"], main_e["step_bound_by"]), None,
           shape=main_e["shape"] + ", step entry at step 15", shapes=split_shapes,
           offgrid_leaves_held=held, offgrid_leaves_close=close,
           launches_adult_fit=fit_la["gbdt_split_search"],
           launches_covertype_fit=fit_lc["gbdt_split_search"],
           launches_hashed_text_fit=hashed["record"]["fit_launches"]["gbdt_split_search"],
           split_steps={"higgs": split_steps(GBDT), "adult": split_steps(adult_gbdt),
                        "covertype": split_steps(cov_gbdt, COVTYPE_CLASSES)})

    g_row = sparse_hist_checks(hashed, dev, gen)
    torch.cuda.empty_cache()

    # F: the LambdaRank gradient over phase 2e's training rows (18,919 queries
    # of up to 1,251 documents), at iteration 0 (every score tied) and at the
    # fitted ranker's margins, then at those margins with the truncation at
    # G (every document top: queries over TOP_MAX documents take the kernel's
    # two-sided second loop): bit-equal to the plain version (the same
    # exp_f32, sums in j order). Each shape prints the counted pairs, the
    # first design's visits (sum m^2) and the cells the kernel visits. Bound:
    # the rows' bytes (score, label, weight, gain in; g, h out) against one
    # exponential a counted pair (its rho feeds both documents) at the SFU
    # rate; no one PyTorch call computes the function (library null).
    y_rank = torch.from_numpy(ranker["y"].astype(np.float32)).to(dev)
    n_rank = len(y_rank)
    w_rank = torch.ones(n_rank, device=dev)
    G_rank = int(ranker["sizes"].max())
    rank_shapes = {}
    for key, score_np, trunc in (
            ("iteration0", np.zeros(n_rank, np.float32), ranker["truncation"]),
            ("fitted", ranker["fitted"], ranker["truncation"]),
            ("fitted_truncation_G", ranker["fitted"], G_rank)):
        groups = QueryGroups(ranker["sizes"], ranker["y"], trunc, dev)
        score = torch.from_numpy(score_np).to(dev)
        g_k, h_k = lambda_grads(score, y_rank, w_rank, groups)
        (g_p, h_p), plain_ms = timed_once(lambda: lambda_grads_plain(score, y_rank, w_rank,
                                                                     groups))
        ulps = max(int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())
                   for a, b in ((g_k, g_p), (h_k, h_p)))
        if ulps > F_ULPS:
            fail(f"lambdarank kernel ({key}) differs from the plain version by {ulps} ulps")
        if not (torch.isfinite(g_k).all() and (h_k > 0).all()):
            fail(f"lambdarank kernel ({key}): non-finite g or h <= 0")
        # the rows whose g and h survive the reference's pre-rounding grid
        # (the next power of two over the rows times max|g|, 24 bits)
        n_bound_rank = 1 << (n_rank - 1).bit_length()
        live = {f"{name}_nonzero_after_preround": float(
            (_preround(t[:, None], n_bound_rank)[:, 0] != 0).float().mean())
            for name, t in (("g", g_k), ("h", h_k))}
        ms = time_ms(lambda: lambda_grads(score, y_rank, w_rank, groups), 10)
        pairs = pair_count(ranker["sizes"], ranker["y"], trunc, score_np)
        cells, visits_first = cell_count(ranker["sizes"], trunc)
        b = bound(n_rank * 16, pairs, EX2_PER_S)
        rank_shapes[key] = {"shape": f"n={n_rank} Q={len(ranker['sizes'])} G={groups.G} "
                                     f"truncation={trunc}",
                            "ms": ms, "plain_ms": plain_ms, "pairs": pairs, "cells": cells,
                            "visits_first_design": visits_first, "bound_ms": b[0],
                            "bound_by": b[1], "max_ulps": ulps, "max_abs_err": 0.0,
                            "max_abs_g": float(g_k.abs().max()), **live}
        log(json.dumps({"lambdarank": key, **rank_shapes[key]}))
        del g_k, h_k, g_p, h_p, groups
        torch.cuda.empty_cache()
    main_f = rank_shapes["fitted"]
    record("gbdt_lambdarank", ranker["record"]["fit_launches"]["gbdt_lambdarank"], 0.0,
           main_f["ms"], main_f["plain_ms"], (main_f["bound_ms"], main_f["bound_by"]), None,
           shape=main_f["shape"] + ", the fitted ranker's margins", shapes=rank_shapes,
           ulp_tolerance=F_ULPS)
    del y_rank, w_rank

    # C: flash attention at the entry point's shapes (bf16, then f32)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_rows = {}
    for key, shape in flash_shapes.items():
        B, S_, H, H_kv, D = shape
        dtype = flash_dtype[key]
        q, k, v = flash_in[key]
        ref = dense_attention(q.float(), k.float(), v.float(), causal=True)
        err = float((flash_out[key].float() - ref).abs().max())
        rel = row_rel_err(flash_out[key], ref)
        del ref
        tol = 5e-2 if dtype == torch.bfloat16 else 2e-5
        log(f"phase 4 flash {key} {shape} {dtype}: max|kernel - plain f32| = {err:.3g}")
        if not err <= tol:
            fail(f"flash {key}: {dtype} error {err} > {tol}")
        extra = {}
        if dtype == torch.bfloat16:
            # the tight check: per-row error against the plain version, and
            # the median error that dropping one key tile (of the kernel at
            # this head dim) gives the deepest rows (a kernel that drops it
            # for a query tile fails when any one of those rows passes the
            # limit; the median must stand well above it)
            tile = KEY_TILE_BY_HEAD_DIM[D]
            row_err, row_mean = float(rel.max()), float(rel.mean())
            mid = S_ // 2 // tile * tile
            skip_err = float(row_rel_err(
                tail_attention(q, k, v, tile, slice(mid, mid + tile)),
                tail_attention(q, k, v, tile)).median())
            log(f"phase 4 flash {key}: per-row error vs plain max {row_err:.3g} "
                f"(mean {row_mean:.3g}, limit {FLASH_ROW_TOL}); one {tile}-key tile dropped "
                f"from the last {tile} rows gives a median {skip_err:.3g}")
            if not skip_err >= 2 * FLASH_ROW_TOL:
                fail(f"flash {key}: a dropped key tile moves a row by only {skip_err}; "
                     f"the limit {FLASH_ROW_TOL} cannot see it")
            if not row_err <= FLASH_ROW_TOL:
                fail(f"flash {key}: per-row bf16 error {row_err} > {FLASH_ROW_TOL}")
            extra = dict(row_err=row_err, skip_err=skip_err)
        del rel
        rep = H // H_kv
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 10)
        plain_ms = time_ms(lambda: dense_attention(q, k, v, causal=True), 2)
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 10)
        del qt, kt, vt
        pairs = B * H * causal_pairs(S_, S_)
        flops = 4 * D * pairs
        b = bound(q.element_size() * (2 * q.numel() + k.numel() + v.numel()), flops,
                  BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_3XTF32_FLOPS)
        flash_rows[key] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=b, lib_ms=lib_ms,
                               tflops=flops / ms / 1e9, shape=shape, dtype=dtype,
                               kernel=kernel_for(dtype, D).name, **extra)
        log(json.dumps({"flash": key, "B_S_H_Hkv_D": shape, "dtype": str(dtype),
                        "kernel": flash_rows[key]["kernel"], "ms": ms, "plain_ms": plain_ms,
                        "sdpa_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1],
                        "ex2_floor_ms": pairs / EX2_PER_S * 1e3, "tflops": flops / ms / 1e9,
                        "sdpa_tflops": flops / lib_ms / 1e9, "bound_tflops": flops / b[0] / 1e9}))
    del flash_in, flash_out
    f32_err = 0.0
    for shape in ((1, 4096, 4096, 8, 2, 64), (2, 300, 300, 4, 4, 128)):
        B, S_q, S_k, H, H_kv, D = shape
        q = torch.randn(B, S_q, H, D, generator=gen, device=dev)
        k = torch.randn(B, S_k, H_kv, D, generator=gen, device=dev)
        v = torch.randn(B, S_k, H_kv, D, generator=gen, device=dev)
        for causal in (False, True):
            e = float((flash_attention(q, k, v, causal=causal)
                       - dense_attention(q, k, v, causal=causal)).abs().max())
            f32_err = max(f32_err, e)
    log(f"phase 4 flash f32 short shapes: max|kernel - plain| = {f32_err:.3g}")
    if not f32_err <= 2e-5:
        fail(f"flash f32 error {f32_err} > 2e-5")

    def shape_text(r):
        B, S_, H, H_kv, D = r["shape"]
        kind = "bf16" if r["dtype"] == torch.bfloat16 else "f32"
        return f"B={B} S={S_} H={H} H_kv={H_kv} D={D} causal {kind}"

    def shape_entry(r):
        entry = {"shape": shape_text(r), "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                 "library_ms": r["lib_ms"],
                 "tflops": r["tflops"], "max_abs_err": r["err"]}
        if "row_err" in r:
            entry.update(row_rel_err=r["row_err"],
                         one_tile_dropped_median_row_rel_err=r["skip_err"])
        return entry

    for name in flash_names:
        mine = {key: r for key, r in flash_rows.items() if r["kernel"] == name}
        main = mine.get("headline", mine.get("f32-gqa"))
        extra = ({"row_rel_tol": FLASH_ROW_TOL} if main["dtype"] == torch.bfloat16
                 else {"short_shapes_max_abs_err": f32_err})
        record(name, flash_launches[name], max(r["err"] for r in mine.values()), main["ms"],
               main["plain_ms"], main["bound"], main["lib_ms"], shape=shape_text(main),
               tflops=main["tflops"],
               shapes={key: shape_entry(r) for key, r in mine.items()}, **extra)

    # C's lse entries (phase 2l): their launches in the main path's run (the
    # one-rank ring), the two-rank ring's on each rank, the headline and f32
    # shapes of 2l (a); a ring step's merge beside C's step on rank 0
    ring = {"launches_two_rank_ring": {
                f"rank{rank}": {k: v["launches"]["flash_attention_fwd_lse"]
                                for k, v in runs.items() if k.startswith("ring")}
                for rank, runs in sp_two["runs"].items()},
            "ring_step_ms_rank0": {k: {"kernel": v["kernel_step_ms"], "merge": v["merge_ms"]}
                                   for k, v in sp_two["runs"][0].items() if "merge_ms" in v}}
    for key, name in (("headline", "flash_attention_fwd_lse"),
                      ("f32-d128", "flash_attention_fwd_f32_lse")):
        r = lse_rows[key]
        record(name, sp_one["launches"][name], r["max_abs_err"], r["ms"], r["plain_ms"],
               (r["bound_ms"], r["bound_by"]), r["library_ms"], shape=r["shape"],
               ms_without_lse=r["ms_without_lse"], library=r["library"],
               library_lse_vs_kernel=r["library_lse_vs_kernel"], lse_tol=LSE_TOL,
               bytes_moved=r["bytes"], **(ring if key == "headline" else {}))

    # G's row, with the device ms of the traced phase 2g fits (the last traces)
    traced = trace_hashed_fits(hashed)
    per_path = lambda field: {path: traced[path][field] for path in ("half_pass", "full_pass")}
    record("gbdt_sparse_hist", hashed["record"]["fit_launches"]["gbdt_sparse_hist"], 0.0,
           g_row.pop("ms"), g_row.pop("plain_ms"), g_row.pop("bound"), g_row.pop("library_ms"),
           **g_row, fit_device_ms=per_path("g_device_ms_a_fit"),
           device_kernels_a_call=per_path("g_device_kernels_a_call"),
           kernel_ms_a_fit=per_path("g_kernel_ms_a_fit"),
           launches_per_split_step=per_path("launches_per_split_step"))

    # the mesh's entries (phase 2i): P's mesh entry and pick with their
    # launches in the one-rank NCCL fit, G's mesh use with its launches in
    # rank 0's two-rank hashed-text fit
    two = mesh_b["fits"]
    p_root, pick_root = mesh_rows["partition"]["root"], mesh_rows["pick"]["root"]
    record("gbdt_partition_mesh", mesh_a["fit_launches"]["gbdt_partition_mesh"], 0.0,
           p_root["ms"], p_root["plain_ms"], (p_root["bound_ms"], p_root["bound_by"]),
           p_root["library_ms"], bytes_moved=p_root["bytes_moved"],
           shape=f"root split of n={N_TRAIN} rows, the local counts out, no side chosen",
           splits=mesh_rows["partition"],
           launches_two_rank_fits={k: f["launches"]["gbdt_partition_mesh"]
                                   for k, f in two.items()})
    record("gbdt_partition_pick", mesh_a["fit_launches"]["gbdt_partition_pick"], 0.0,
           pick_root["ms"], pick_root["plain_ms"],
           (pick_root["bound_ms"], pick_root["bound_by"]), None,
           bytes_moved=PICK_BYTES, shape="one thread after the counts' all-reduce",
           splits=mesh_rows["pick"],
           launches_two_rank_fits={k: f["launches"]["gbdt_partition_pick"]
                                   for k, f in two.items()})
    g_main = mesh_rows["sparse"]["root_child"]
    record("gbdt_sparse_hist_mesh", two["hashed_text_data2"]["launches"]["gbdt_sparse_hist_mesh"],
           0.0, g_main["ms"], g_main["plain_ms"], (g_main["bound_ms"], g_main["bound_by"]),
           g_main["library_ms"], bytes_moved=g_main["bytes"],
           shape=f"phase 2g's rows, the first tree's root split, the smaller side forced, "
                 f"no parent", shapes=mesh_rows["sparse"],
           launches_rank_1=two["hashed_text_data2"]["launches_rank1"]["gbdt_sparse_hist_mesh"])

    # kernel V's row: a launch of the main path's configuration (logistic,
    # sparse regime) over phase 2j (b)'s 64 batches, as the fit launches it
    # (ms: CUDA events around the launch; plain: the 64 plain steps; bound:
    # the launch's bytes; beside it the traced device time a batch and
    # the same batches launched one by one), its launches in the fit
    vw_main = vw_steps["steps"]["logistic-sparse"]
    record("vw_step", vw["fit_launches"], 0.0, vw_main["ms"], vw_main["plain_ms"],
           (vw_main["bound_ms"], vw_main["bound_by"]), None, bytes_moved=vw_main["bytes"],
           shape=f"one launch of {VW_STEP_BATCHES} batches of {VW_PARAMS['batch_size']} "
                 f"hashed reviews at 2^{VW_PARAMS['num_bits']} slots (K={vw_steps['K']}), "
                 f"logistic, l1 = l2 = 0",
           us_a_batch=vw_main["whole"]["us_a_batch"],
           device_us_a_batch=vw_main["whole"]["device_us_a_batch"],
           host_us_to_submit_a_pass=vw_main["whole"]["host_us_to_submit_a_pass"],
           by_batch=vw_main["by_batch"], launches_a_pass=1,
           batches_a_pass=vw["batches_a_pass"], steps=vw_steps["steps"],
           launches_nccl_one_rank=vw_nccl["launches"],
           launches_two_rank_fits={k: f["launches"] for k, f in vw_two["fits"].items()})

    # kernels Q and R (phase 2k's ONNX executor): their launches in phase 2k
    t0 = time.perf_counter()
    for name, r in onnx_kernel_rows(args.seed, dev).items():
        if name == "onnx_qconv":
            r["extra"]["conv3d"] = conv3d
        record(name, onnx["launches"][name], r["err"], r["ms"], r["plain_ms"], r["bound"],
               r["library_ms"], **r["extra"])
    log(f"phase 4 kernels Q and R in {time.perf_counter() - t0:.1f} s")

    # kernel L (phase 2m (b)) at k = 32, its other shape beside it, and B's
    # forest entry (phase 2m (e)): their launches in phase 2m's main path
    main_k = LASSO_KS[0]
    lr = expl["lasso"][main_k]
    record("explainers_lasso_cd", expl["launches"]["explainers_lasso_cd"], lr["max_abs_err"],
           lr["ms"], lr["plain_ms"], lr["bound"], None, shape=lr["shape"], tol=lr["tol"],
           bytes_moved=lr["bytes"], svd_path_ms=lr["svd_ms"], smem_k=expl["lasso"]["smem_k"],
           shapes={f"k{k}": {key: expl["lasso"][k][key] for key in
                             ("shape", "ms", "plain_ms", "svd_ms", "max_abs_err", "tol",
                              "bytes", "gram_in_smem", "fits_a_block", "zero_flips_at_ties",
                              "bit_equal_to_order_model", "nonzero_share")}
                   | {"bound_ms": expl["lasso"][k]["bound"][0],
                      "bound_by": expl["lasso"][k]["bound"][1]} for k in expl["lasso"]["ks"]})
    fr = expl["forest"]
    record("iforest_tree_score", expl["launches"]["iforest_tree_score"], fr["max_abs_err"],
           fr["ms"], fr["plain_ms"], fr["bound"], None, shape=fr["shape"], tol=FOREST_TOL,
           bytes_moved=fr["bytes"], rebin_ms=fr["rebin_ms"], bin_dtype=fr["bin_dtype"],
           launches_transform=fr["launches"], launches_fit=fr["fit_launches"])

    # kernel K (phase 2n (a)) at KNN's shape, the other shapes beside it: its
    # launches in phase 2n's main path, its largest error over the shapes
    kr = nnrec["topk"]["knn"]
    k_err = max(nnrec["topk"][name]["max_abs_err"] for name in TOPK_SHAPES)
    record("topk_select", nnrec["launches"]["topk_select"], k_err, kr["ms"], kr["plain_ms"],
           kr["bound"], kr["library_ms"], shape=kr["shape"], bytes_moved=kr["bytes"],
           library="torch.topk (the same values, its own order at ties)",
           replaces_all=kernels["topk_select"].replaces,
           launches_knn=nnrec["launches_knn"], launches_sar=nnrec["launches_sar"],
           cases=nnrec["topk"]["cases"],
           shapes={name: {key: nnrec["topk"][name][key] for key in
                          ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bytes")}
                   | {"bound_ms": nnrec["topk"][name]["bound"][0],
                      "bound_by": nnrec["topk"][name]["bound"][1]}
                   for name in TOPK_SHAPES},
           phase_2n={key: nnrec[key] for key in ("knn", "cknn", "sar", "anomaly")})

    missing = set(kernels) - {r["name"] for r in rows}
    if missing:
        fail(f"kernels never checked: {sorted(missing)}")
    log(f"chip_smoke: the whole run took {time.perf_counter() - run_t0:.1f} s [{card}]")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
