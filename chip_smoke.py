#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, retraining, sharded and
multi-process training paths once on one GPU, its default training route,
the scan route of CUDA graphs, unsharded and sharded, its model-family
reproduction suite at a cut budget, its benchmark entry points, the
scaling report's executed-bytes check, the substrate lab, the parity
checks of the sharded step against the single-device step and the
speed-of-light audit of the train step.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing of JAX.
``--phases 6,7`` runs phases 1-3 and then only the kernel phases named
(6, 7), and prints no report: a kernel's check and times alone.

Phases, each printing its own lines:
1. device: the card's name and power limit, as nvidia-smi gives them, and
   ``nvidia-smi -L``;
2. build: the CUDA kernels of ``deepctr_torch/csrc`` compiled from source,
   one nvcc per source in parallel, with ptxas registers, static shared
   memory, spills and any wgmma serialization warning per kernel, the tower
   kernels' rows a block, ring slots and dynamic shared memory at FNN and
   DeepFM widths, and the tensor-core instructions (``HGMMA`` or ``HMMA``)
   ``cuobjdump -sass`` finds in each kernel: every tower kernel (forward,
   backward rows, weight gradient) must have them, the FM scorer none;
3. kernel vs plain: ``mlp_tower_fwd`` against ``mlp_tower_plain`` on the
   card at the serving shape [8192, 176] with FNN widths 200-300-100 tanh,
   at [65536, 176], at a ragged batch, at SNN's [8192, 200] with its tower
   300-100, at the Criteo configs' [8192, 663] with 512-256-128 (tanh, the
   configs', and relu), and at small relu and sigmoid towers, each also with
   input rows that hold one NaN, +inf, -inf, +FLT_MAX or -FLT_MAX (the
   kernel's logits there must have the plain version's NaN and inf pattern
   and its values, dropout 0 and 0.5, and the other rows keep their bits;
   every case prints before a failure raises); the FNN and Criteo shapes
   timed on both with CUDA events;
4. serving end to end: full-width iPinYou FNN parameters from a seed are
   written with the port's checkpoint writer, 65,536 synthetic requests are
   scored through ``deepctr_torch.cli --score``, and the output is held
   against the same gather and pooling followed by the plain tower on the
   card, and against a float64 numpy forward;
5. profile: ``torch.profiler`` around one scorer call over the requests,
   printing the device's busy share and its time per op;
6. training kernels vs plain: the forward with dropout and the backward
   kernel against the plain tower and autograd through it, for FNN's tanh
   200-300-100 and DeepFM's relu 200-200, at [8192, 176] and [1000, 176],
   SNN's tanh 300-100 at [8192, 200], and the Criteo tower 512-256-128 tanh
   and relu at [8192, 663],
   dropout 0.5 and 0 (relu: rows at its derivative's step get no upstream
   gradient, see RELU_EDGE); phase 3's special input rows through the
   forward, and one special row at a time through the backward, held to
   autograd where autograd is finite (the rest counted); a second backward
   launch compared bit for bit; the seed given as a 0-d device tensor (a graph's seed buffer)
   against the int seed, forward and backward, bit for bit; the FNN tower's forward, backward and both timed against the plain
   ones, and the Criteo tower's forward and backward with dropout 0.5;
7. FM scorer kernel vs plain: ``fm_score_fwd`` against ``fm_score_plain``
   at [8192, 18, 11], [65536, 18, 11], a ragged [1000, 18, 11], a small odd
   [77, 5, 4], the Criteo configs' k=16 ([8192, 39, 17]), a batch that is
   no multiple of the kernel's tile ([8197, 18, 11]) and one of exactly one
   tile ([16, 18, 11]), with pad slots and an all-pad example; the launch's
   shape (examples a tile, blocks, shared memory); a second launch compared
   bit for bit; the first two shapes timed on both, with GB/s, beside an
   empty kernel of the same launch (the launch floor) and, at 8192 rows,
   over eight inputs in turn (57 MB, past the 50 MB L2; one input stays in
   L2 over the timed calls); the kernels line takes [65536, 18, 11]'s; the
   autograd Function's gradient against autograd through the plain version;
8. FM training end to end: ``deepctr_torch.cli``'s run on
   ``configs/fm_k10.json`` at full iPinYou width, batch 8192, bf16 table,
   one epoch of 40 steps; the FM scorer's launch count, the eval AUC, the
   ``.fm_table`` it writes, and its checkpoint scored by ``--score``
   against the eval step; then 5 steps of the kernel path against 5 steps
   of a plain comparator from one state, 3 steps run twice compared bit for
   bit, step times on both paths and ``torch.profiler`` around warm steps;
9. FNN training end to end, seeded from phase 8's ``.fm_table`` (the FM ->
   FNN pipeline): ``configs/fnn_full_ipinyou.json`` with
   ``model.init_from`` set to it, the same cut and checks as phase 8 for
   the tower kernels, the occurrence-gradient scatter's forms timed;
10. DeepFM: 10 training steps through the CLI at full width (relu 200-200,
    dropout 0.5), launching the FM scorer and both tower kernels,
    ``--score`` of its checkpoint against the eval step, 5 kernel steps
    against 5 plain steps and 3 steps run twice compared bit for bit, and
    ``torch.profiler`` around warm steps;
11. LR and IPNN: ``--score`` of checkpoints written from seeded parameters,
    against a float64 numpy forward (LR) and the plain path on the card
    (IPNN, tower input 296);
12. SNN with its pretraining: ``deepctr_torch.cli``'s run on
    ``configs/snn_rbm.json`` at full iPinYou width (table 927,658 x 200,
    f32), batch 8192, cut to 20 RBM pretraining steps and 20 fine-tune steps
    (the config's one pretraining epoch and 10 epochs over 200,000
    examples): the pretrain record, the hand-off event, the tower kernels'
    launch counts, eval AUC above 0.5, ``--score`` of its checkpoint against
    the eval step, 5 kernel steps against 5 plain steps, 3 steps run twice
    compared bit for bit, step times and ``torch.profiler`` around the
    fine-tune step and around RBM and DAE pretraining steps; the same run
    with ``train.pretrain=dae`` cut to 5 and 5 steps; the occurrence
    scatter's fixed-point sums at a DAE step's 557,056 rows of 200 floats
    against float64; peak device memory;
13. the resumable, streamed retraining job: FNN from
    ``configs/fnn_full_ipinyou.json`` (``model.init_from=none``, bf16
    table, dropout 0.5) through the CLI on 4 yx shards of 81,920 rows from
    ``synthetic.generate(seed=3)`` (40 steps an epoch) and a test file of
    16,384 rows. Run A streams and prefetches 2 epochs; run B takes 1 and
    B' resumes it to 2, and B''s final checkpoint must equal A's bit for
    bit, with a ``resumed`` event at step 40, epoch 1; A's launch counts
    (forward with dropout and backward once a step, the eval forward once
    an eval batch). One in-RAM epoch with ``train.prefetch`` off and on, in
    turns, bit-identical; the three CLI epoch rates (in RAM without and
    with prefetch, streamed with prefetch); ``torch.profiler`` over warm
    steps fed by numpy batches and by the prefetcher; run A's eval logits
    through ``AucState`` on the card against ``exact_auc``, the host waiting
    on the card in no update and twice in finalize; 5 batches with
    ``train.profile_dir`` (the trace of the graph route must name the tower
    kernels), 5 with ``train.debug_nans``, 5 with ``optim.dense=adam``, and in a subprocess a run seeded with a NaN in a
    row of the first batch, which must exit non-zero at step 1;
14. quantised serving: phase 9's trained FNN checkpoint scored over 65,536
    rows (the run's held-out rows and the last of its training rows) by the
    f32, bf16 and int8 ``Scorer``s: AUC within 0.002 of f32's, the int8
    logits against a plain path on the card that quantises the f32
    scorer's table itself (the reference's rule), dequantises the gathered
    rows and runs the plain tower, each table's bytes (V·D·2, V·(D+4)) with the model's f32 table released,
    the tower launches, host ms and device ms a batch;
15. sharded training in a world of one NCCL rank (one card; NCCL refuses
    two ranks on one GPU, so the multi-rank checks run on the CPU with gloo
    in the tests): (a) from one state, 3 sharded steps against 3 unsharded
    steps bit for bit (loss, table, Adagrad accumulator, dense parameters)
    for FNN at full iPinYou width (bf16 table, dropout 0.5, dense mode) and
    FM k=10 (the FM scorer kernel), and the world-1 eval logits against the
    unsharded eval's; (b) the same 3 steps with ``exchange_dtype=bf16``
    against the f32 wire, within the reference's band; (c)
    ``configs/fnn_full_ipinyou.json`` with ``train.sharded=true`` through
    the CLI, one epoch of 40 steps on the sharded scan route: launches
    41 / 41 of the forward with dropout and of the backward (one a step,
    one the capture's warm-up step), no dropped ids, its checkpoint equal to
    phase 9's unsharded run's leaf for leaf and through ``--score`` against
    the eval step; (d) ``configs/criteo_sharded_stretch.json`` at full width
    (``criteo_schema(1_000_000)``, a 26,000,833 x 17 f32 table and its
    accumulator, sorted mode, tower 663-512-256-128 with dropout 0.5,
    capacity 2.0), cut to one epoch of 40 steps of 8192: eval AUC above 0.5,
    no dropped ids, launches 41 / 41, the CLI epoch's examples/s, the
    per-step route's step time (CUDA events), ``torch.profiler`` over warm
    steps (the NCCL all-to-all named), the step's own pieces timed alone
    (bucketing, the lookup and gradient exchanges, the sorted-mode scatter)
    and the peak
    device memory;
16. ``train.distributed=true`` in a world of one NCCL rank: (a) phase 13's
    streamed FNN job with ``train.sharded=true train.distributed=true``
    (rank-local stream, agreed step counts, per-rank shard checkpoints
    ``<ckpt>.hostshards/proc0.npz``): run A takes 2 epochs, run B 1 and B'
    resumes from B's host shards to 2; B''s shard file must equal A's bit
    for bit, with a ``resumed_hostshards`` event at epoch 1; A's shard file,
    sentinel rows dropped, must equal phase 13's run A checkpoint leaf for
    leaf; launches 80 / 80 and a warm-up step a capture (the sharded scan
    route) and one eval forward an eval batch;
    ``rows_skipped`` 0; no portable checkpoint and no ``.fm_table``; the
    shard file's bytes, the row count's rows/s, the CLI epochs' examples/s,
    and the FNN state's save and load; (b) phase 15 (d)'s Criteo state
    (26,000,833 x 17 f32 and its accumulator) through ``save_host_shards``
    and ``load_host_shards`` into a freshly packed state, bit for bit, with
    the temporary directory's free space, the bytes, seconds and GB/s each
    way and the peak host RSS.
17. the scan route, ``train.scan_steps`` = 8, the configs' default:
    eight train steps captured as one ``torch.cuda.CUDAGraph`` and replayed
    once a chunk. (a) From one state, one replay against 8 eager steps on a
    clone, bit for bit (losses, table, both optimizers' states, tower,
    step, generator), for FNN at full iPinYou width (bf16 table, dense
    mode, dropout 0.5), FNN with Adam, FM k=10, DeepFM and SNN's fine-tune
    (f32 927,658 x 200, sorted mode); (b) a chunk of 3 real steps and 5
    weight-0 pad steps (FNN with Adam, whose moments the pad steps move);
    (c) the state put back in place and the same graph replayed again, bit
    for bit; (d) eager steps and replays in turns at FNN, FM, DeepFM and
    SNN widths: wall ms a step (host clock), the device's span a step
    (CUDA events), busy ms a step and busy share (``torch.profiler``),
    capture seconds, the bytes the capture's warm-up keeps of the state,
    and peak device memory, the graph's at most 0.25 GiB over the eager
    route's (the warm-up runs on the state itself and puts back what it
    wrote: no copy of the state); the sorted-mode Adagrad update,
    static-shape form against the boolean-mask form it replaced, at
    Criteo's and SNN's shapes; (e) ``configs/fnn_full_ipinyou.json``
    through the CLI with ``train.scan_steps=8`` and ``=0`` in turns, 2
    epochs of 40 steps: checkpoints equal leaf for leaf, each epoch's
    examples/s; (f) a replay and an eager step under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync.
18. the sharded scan route in a world of one NCCL rank: K = 8 sharded
    steps captured as one CUDA graph, both all-to-all exchanges and the
    all-reduces of each step inside. First ``all_to_all_single`` alone in
    a graph, replayed after its input is rewritten (the exchange runs in
    the replay), with the device ops the profiler records. (a) From one
    state, one replay against 8 eager sharded steps on a clone, bit for
    bit (losses, dropped counts,
    table shard, accumulator, tower, dense optimizer's state, step,
    generator), for FNN at full iPinYou width (bf16 table, dense mode,
    dropout 0.5), FM k=10 (the FM scorer kernel) and
    ``configs/criteo_sharded_stretch.json`` at full width (26,000,833 x 17
    f32 and its accumulator, sorted mode, 663-512-256-128 tanh, dropout
    0.5, capacity 2.0); (a') for FNN and FM the sharded replay against
    phase 17's unsharded graph from the same state, bit for bit; (b) a
    chunk of 3 real and 5 weight-0 steps with Adam; (c) FNN's and the
    Criteo config's sharded eager steps and graph replays in turns (wall
    ms a step, the device's span a step, busy share, device ops a chunk and the
    NCCL names the profiler gives, capture s and the bytes its warm-up
    keeps, peak memory, the graph's at most 0.25 GiB over the eager
    route's), and its CLI
    run with ``train.scan_steps=8`` and ``=0`` in turns, 40 steps each:
    checkpoints equal leaf for leaf, each run's examples/s and peak
    device memory; (d) a replay under
    ``torch.cuda.set_sync_debug_mode("error")`` for FNN and Criteo: no host
    sync; (e) the tower launches of the CLI run: 8 a replay and each
    capture's warm-up step.
19. the model-family suite, ``deepctr_torch.tools.reproduce`` (the
    counterpart of ``tools/reproduce.py``, whose full run writes
    ``RESULTS_TORCH.md``) at a cut budget: LR, FM, FNN seeded from FM's
    table, SNN-RBM after pretraining, DeepFM and IPNN, 2 epochs each of
    batch 512 on its 120,000 synthetic rows, each through ``cli.run`` on
    the scan route. First the suite's FNN step alone at batch 512: the
    memory one capture keeps, wall and device ms a step over 5 replays and
    the busy share (``torch.profiler``). Then the suite, with the counts set
    to 0 just before it: its family table in MODELS order, every AUC finite
    and above 0.5; the tower forward, backward and FM scorer launches equal
    to the scan route's prediction (a replay adds its capture's, one graph
    a run and one warm-up step a capture, the eval forward once an eval
    batch); no graph alive after the last run, no private graph pool left,
    and the device memory read twice on each side of the suite, as held
    and with cuBLAS's workspaces (32 MiB a stream) cleared, each within 64
    MiB of before (every capture warms up and captures on the device's one
    capture stream, so the suite's captures add no workspace); the
    seconds, launches, captures, both readings and the workspace bytes the
    clearing frees printed.
20. the benchmark suite: ``python -m
    deepctr_torch.tools.bench_suite --sections parser,models,lookup,serving``
    in a subprocess, in a temporary directory (the checkout's
    ``BENCH_TORCH.*`` stay as they are): its ``BENCH_TORCH.json``, each
    model's examples/s above 0, the launches a replay of 8 steps (8 forward
    with dropout and 8 backward for FNN and DeepFM, 8 ``fm_score`` for FM
    and DeepFM, none for LR), one tower forward a scored batch, each
    section's peak device memory, and its ``BENCH_TORCH.md`` naming the
    card;
21. the scaling report and the substrate lab: (a) in a world of one NCCL
    rank, full-width iPinYou FNN (capacity 2.0, f32 wire, bf16 table; and
    capacity 1.25, bf16 wire, f32 table) and FM (bf16 table): a sharded train
    step, an eval step and a scan step's capture under
    ``parallel/sharded.py::record_collectives``, every collective's bytes
    and calls against ``parallel/comm.py::sent_volume``, as
    ``deepctr_torch.tools.scaling_report`` checks them (ids 1,179,648 B,
    rows 3,244,032 B in bf16, gradients 6,488,064 B, the dense all-reduce
    503,604 B and 3 scalar all-reduces a train step for the headline;
    the capture's warm-up step one step's and one ``all_gather`` of the
    ids whose rows it puts back, its captured collectives K steps'); (b)
    ``python -m deepctr_torch.tools.substrate_lab --exp
    rank2`` at its defaults (120,000 examples: LR, FM, SNN-RBM and FNN
    seeded from FM through ``cli.run`` on the scan route) with its gate,
    SNN and FNN above LR by more than 0.02 AUC, each AUC and the seconds,
    and the tower forward (both branches), backward and FM scorer launched.
22. the scan route at a state of 55% of the card: FNN at ``bench.py``'s
    widths (k=10, 200-300-100 tanh, dropout 0.5) on iPinYou's 16 fields
    with the url field grown until the f32 table and its f32 Adagrad
    accumulator (sorted mode) take 55% of ``torch.cuda.mem_get_info()``'s
    total (about 530 M rows of 88 B on an 80 GB card), made on the card and
    filled in place from a CUDA generator; 8 eager steps of 8192, then the
    state filled again in place from the same seeds and one chunk of 8 on
    the graph route (``make_scan_train_step``): losses equal bit for bit,
    the graph chunk's peak device memory at most 0.25 GiB over the eager
    steps', the tower forward with dropout and backward launched 9 times
    each (the warm-up step and a replay); the state's bytes, both peaks,
    the capture's seconds and the bytes its warm-up kept, and the graph's
    wall ms a step over 3 more replays. A route that copied the state at a
    capture would run out of memory here.
23. the parity checks (``deepctr_torch/parallel/parity.py``, the rank
    program of the drill's ``parity`` leg and the counterpart of
    ``__graft_entry__.py::dryrun_multichip``) in a world of one NCCL rank on
    cuda:0, with the counts set to 0 just before and read just after: at
    the reference's size (``ipinyou_like_schema()``, FNN k=10 200-300-100
    tanh, 16 rows) its seven checks: five sharded SGD steps against five
    single-device steps (losses rtol 1e-4 / atol 1e-5, table and dense
    leaves rtol 2e-4 / atol 1e-4), five Adagrad steps (finite, no drops,
    learning), the sharded eval against the single-device eval (rtol 2e-4
    / atol 2e-3), a starved capacity's drops, the dropout-0.5 tower twice
    from one init bit for bit, a bf16 table with the bf16 wire, and a
    stream-fed sharded scan epoch through ``DevicePrefetcher`` and a CUDA
    graph (every row once); at full iPinYou width (8192 rows) checks 1 and
    3, and 5 and 6 at ``bench.py``'s configuration. Each check's largest
    difference a leaf beside its tolerance, whether checks 1 and 3 are the
    single-device step's bits (a world of one is that step), the tower
    launches a check, the seconds. The same checks on 2 and 4 GPUs are
    ``python -m deepctr_torch.parallel.drill --legs parity``.
24. the speed-of-light audit of the full-vocab FNN step: ``python -m
    deepctr_torch.tools.step_breakdown`` (the counterpart of
    ``tools/step_breakdown.py``, ``profile_step.py``,
    ``bench_step_breakdown.py`` and ``roofline_lab.py``) in a subprocess at
    ``bench.py``'s configuration, f32 and bf16 tables, every part but
    ``--quality``: the step's five variants on the graph route, each
    component timed with its bytes, FLOP and bound, the top device ops of
    a replay, the full step at batch 8192, 16384 and 32768; its gates
    passed (first-step losses of ``full``, ``no_sparse``,
    ``fwd_bwd_no_update`` and ``fwd_only`` bit for bit, the state kept
    where no update runs, ``full`` equal to ``make_scan_train_step``), the
    tower launches a replay (8 / 0 / 8; ``fwd_only`` 8 / 0 / 0; the plain
    tower 0), and its ``ROOFLINE_TORCH.md`` naming phase 1's card.
26. the dense-mode sparse Adagrad kernel (``csrc/sparse_adagrad.cu``) at
    iPinYou's 927,658 x 11 table, bf16 and f32, on batches of 8192 x 18
    Zipf ids: table and accumulator bit for bit against the plain version
    after 1 and 3 updates, the workspace clean after them, untouched rows
    kept, a second run and a CUDA graph's replays bit for bit, its launches,
    rows written and rows split as predicted, and its ms beside its byte
    bound and the plain version's (``_phase26_sparse_adagrad``);
27. DLRM-DCNv2 at MLPerf's widths (``_phase27_dlrm``): the dense-mode
    sparse Adagrad kernel at the benchmark cell's scale (a 26,500,128 x 128
    f32 table, 1,753,088 Zipf occurrences a batch) bit for bit against the
    plain version on the touched rows, untouched rows kept, the workspace
    clean, its ms beside its byte bound and its rows split; the CLI's loop
    (``configs/dlrm_dcnv2_criteo.json``) for 3 chunks of 8 x 8192, losses
    finite; one 8-step graph replay against 8 eager steps bit for bit, and
    the step's device ms by phase; in each part the dense-mode kernel's
    launches as predicted, one a step and one a capture's warm-up step
    (``launches_dlrm`` in the report);
28. the dense layers' backward kernel (``csrc/dense_bwd.cu``) at each of
    the 14 shapes of DLRM's 24 kernel products a step (batch 8192): its
    error against a float64 product beside cuBLAS f32's, the same bits on a
    second call, its ms beside its 3xTF32 bound and cuBLAS f32's ms; then
    two fresh DLRM states through one replay each of an 8-step graph, bit
    for bit, with 192 kernel products and 24 cuBLAS products a replay
    (``_phase28_dense_bwd``).
Phases 8-13 train through the CLI, so on the scan route: their launch
counts add each replay's captured launches (the wrappers run but launch
nothing during a capture), and each capture's warm-up step on the state
(restored after it); the runs of 10, 20 and 5 batches are padded to whole chunks
(16, 24 and 8 steps). Under phase 13's ``train.debug_nans`` a chunk runs
as 8 eager steps. The sharded CLI runs of phases 15 (c), (d) and 16 (a)
take the sharded scan route too (the configs' ``train.scan_steps`` is 8):
their launches count 8 a replay and a warm-up step a capture, and 15 (c)
and 16 (a) still match phases 9 and 13 leaf for leaf; 15 (d)'s step time
is the per-step route's, phase 18's the graph's.
Then one JSON line on the kernels (each with its least time on the card
from the shapes: ``bound_ms`` against f32 on the CUDA cores, 67 TFLOP/s,
and 3.35 TB/s, as ``bound_by`` and ``bound_kind`` say, and
``bound_3xtf32_ms`` against three TF32 products a multiply on the tensor
cores), and last ``{"ok": true, "device": ...}``.
Any failure raises, and the script exits non-zero without that last line;
so it does without a CUDA device, or outside a checkout of the repository.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# kernel and plain version both keep f32's accuracy (the kernels' products
# are 3xTF32 on the tensor cores); they differ in summation order and in
# tanh (the kernels' from one exp, within 2.5e-7 of torch.tanh)
RTOL, ATOL = 1e-4, 1e-5
# printed probabilities: 6 decimals (5e-7) plus the logit tolerance through
# the sigmoid, whose slope is at most 1/4
PROB_ATOL = 1e-5
# a weight or bias gradient sums 8192 rows in another order than cuBLAS:
# held to this share of the gradient's largest element
GRAD_REL = 1e-4
# relu's derivative steps at 0: where a hidden pre-activation lies within the
# two sums' f32 rounding (~1e-6 at these widths) of 0, kernel and plain may
# take different sides of the step. The backward checks set the upstream
# gradient of such rows to 0 (a few per cent of the rows at this band)
RELU_EDGE = 1e-4
FNN_HIDDEN = (200, 300, 100)
K = 10
BATCH = 8192
REQUESTS = 8 * BATCH
DROPOUT = 0.5
TRAIN_STEPS = 40            # steps of the CLI's one-epoch training runs
DEEPFM_STEPS = 10
SNN_CONFIG = "configs/snn_rbm.json"
SNN_HIDDEN1 = 200           # the config's bottom layer; its tower is 300-100
SNN_HIDDEN = (300, 100)
SNN_STEPS = 20              # RBM pretraining steps, and fine-tune steps
SNN_DAE_STEPS = 5
RETRAIN_SHARDS = 4          # phase 13: yx shards of the streamed retraining job
RETRAIN_SHARD_ROWS = 81_920
RETRAIN_TEST_ROWS = 16_384
RETRAIN_SHORT_STEPS = 5     # the profiled and the Adam runs
SCAN_K = 8                  # phase 17: steps a graph, the configs' train.scan_steps
SCAN_TIMED_CHUNKS = 5       # chunks of SCAN_K steps timed on each route
# phases 17, 18 and 22: a graph's peak device memory over the eager route's
# (the capture's warm-up keeps a few rows of the state, never a copy of it)
GRAPH_PEAK_GAP_GIB = 0.25
CAPACITY_SHARE = 0.55       # phase 22: the table and its accumulator, of the card
TEST_FRACTION = 0.15        # the configs' held-out share
FM_CONFIG = "configs/fm_k10.json"
FNN_CONFIG = "configs/fnn_full_ipinyou.json"
CRITEO_CONFIG = "configs/criteo_sharded_stretch.json"
# the Criteo configs' tower: FNN pools each of the 39 fields' (w | v) rows of
# 1 + k = 17 (26 hashed and 13 bucketised fields) into 512-256-128; a row of
# 663 floats is no 16-byte multiple, which the weight-gradient kernel's
# tensor copies need (the backward copies x to a stride of 664 first)
CRITEO_IN = 39 * 17
CRITEO_HIDDEN = (512, 256, 128)
# the reference's band for the bf16 wire against f32 (tests/test_parallel.py).
# Rounding each occurrence's gradient to bf16 before duplicates are summed can
# flip the sign of a sum that nearly cancels, and Adagrad's first update of a
# coordinate, lr * g / (|g| + eps), then moves it by up to 2 lr the other way:
# the reference's band allows about two such flips in its small table. A
# systematic fault (a double cast, a lost gradient) moves most changed
# elements; at most this share of them may lie outside the band
WIRE_RTOL, WIRE_ATOL = 0.05, 0.025
WIRE_SHARE = 0.01
# quantised scoring against f32: the reference's serving band
# (tests/test_serving.py) is 0.01; the chip holds the full-width model to
AUC_BAND = 0.002
PNN_HIDDEN = (200, 200)
DEEPFM_HIDDEN = (200, 200)  # relu, dropout 0.5: the reference's DeepFM tower
# FM scorer, kernel vs plain: both sum in f32 in other orders; the
# reference's own tolerance for its kernel (tests/test_pallas.py:26), at
# rows N(0, FM_SIGMA) (the error grows with the squared sums)
FM_TOL = 1e-4
FM_SIGMA = 0.5
# the card's peaks for a kernel's least time (NVIDIA's H100 SXM data sheet):
# f32 on the CUDA cores, TF32 on the tensor cores (3xTF32 takes three
# products a multiply), and device memory
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12
# phases 3 and 6: input rows that each hold one special value at column 1,
# beside rows of finite values; FLT_MAX (3.4028235e38) lies above the
# 3xTF32 split's rounding threshold, (2 - 2^-11) 2^127
FLT_MAX = float(np.finfo(np.float32).max)
SPECIAL_ROWS = {3: float("nan"), 4: float("inf"), 5: float("-inf"), 6: FLT_MAX,
                7: -FLT_MAX}
SPECIAL_NAMES = "nan, +inf, -inf, +FLT_MAX, -FLT_MAX"


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _np_layers(rng, dims) -> list:
    """A tower's layers in the JAX layout, ``[{"w": [in, out], "b": [out]}]``:
    Glorot-uniform weights and N(0, 0.1) biases, f32."""
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (d_in + d_out))
        layers.append({"w": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                       "b": rng.normal(0.0, 0.1, d_out).astype(np.float32)})
    return layers


def _tower(rng, dims, device):
    import torch

    return [(torch.from_numpy(layer["w"]).to(device),
             torch.from_numpy(layer["b"]).to(device))
            for layer in _np_layers(rng, dims)]


def _check_close(what, got, want, rtol=RTOL, atol=ATOL) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    err = np.abs(got - want)
    max_err = float(err.max()) if err.size else 0.0
    bad = int((err > atol + rtol * np.abs(want)).sum())
    print(f"{what}: max |d| {max_err:.3e} (rtol {rtol:g}, atol {atol:g}), "
          f"{bad} of {err.size} outside")
    if bad or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: kernel and reference disagree")
    return max_err


def _special_inputs(x):
    """x with one element of each SPECIAL_ROWS value in its row (column 1),
    the rows that hold them and a mask of the other rows."""
    import torch

    bad = x.clone()
    for row, value in SPECIAL_ROWS.items():
        bad[row, 1] = value
    rows = torch.tensor(list(SPECIAL_ROWS), device=x.device)
    rest = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    rest[rows] = False
    return bad, rows, rest


def _same_pattern(got, want, rtol=RTOL, atol=ATOL) -> bool:
    """NaN where want is NaN, want's infs with their signs, and want's finite
    values within rtol and atol."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    inf = np.isinf(want)
    return bool(np.array_equal(np.isnan(got), np.isnan(want))
                and np.array_equal(got[inf], want[inf])
                and np.all(np.isfinite(got[fin]))
                and np.all(np.abs(got[fin] - want[fin]) <= atol + rtol * np.abs(want[fin])))


def _check_special_rows(what, x, layers, act) -> list:
    """Rows of x that hold one NaN, +inf, -inf, +FLT_MAX or -FLT_MAX
    (SPECIAL_ROWS): the kernel's logits there must have the plain
    version's NaN and inf pattern and its finite values within RTOL and
    ATOL, with and without dropout, and every other row must keep the bits
    it has without them (rows are independent). Prints each case and
    returns the failures, so that a phase reports every case before it
    raises."""
    import torch

    from deepctr_torch.ops.kernels import mlp as mlp_k

    bad, rows, rest = _special_inputs(x)
    failures = []
    for dropout in (0.0, DROPOUT):
        got = mlp_k.mlp_tower_fwd(bad, layers, act, dropout, 7)
        want = mlp_k.mlp_tower_plain(bad, layers, act, dropout, 7)
        clean = mlp_k.mlp_tower_fwd(x, layers, act, dropout, 7)
        g, w = got[rows].cpu().numpy(), want[rows].cpu().numpy()
        same = _same_pattern(g, w)
        kept = (bool(torch.isfinite(got[rest]).all())
                and torch.equal(got[rest], clean[rest]))
        print(f"{what}, dropout {dropout}: input rows with {SPECIAL_NAMES}: kernel "
              f"{g.tolist()}, plain {w.tolist()}: same pattern and values {same}; "
              f"the other rows keep their bits {kept}")
        if not (same and kept):
            failures.append(f"{what}, dropout {dropout}")
    return failures


def _check_special_backward(what, x, layers, g, act, drop, seed) -> list:
    """The backward kernel against autograd through the plain version on x
    with one SPECIAL_ROWS value at a time (a NaN row makes every weight
    gradient NaN): gx and every gW and gb held to the phase's tolerances
    where autograd's value is finite; where it is not, printed: how many
    such entries and at how many of them the kernel gives the same NaN or
    inf. Returns the failures."""
    import torch

    from deepctr_torch.ops.kernels import mlp as mlp_k

    failures, report = [], []
    for row, value in SPECIAL_ROWS.items():
        bad = x.clone()
        bad[row, 1] = value
        g_up = g
        if act == "relu":
            g_up = torch.where(_relu_edge_rows(bad, layers, drop, seed), 0.0, g)
        gx, grads = mlp_k.mlp_tower_bwd(bad, layers, g_up, act, drop, seed)
        wgx, wgrads = mlp_k.mlp_tower_bwd_plain(bad, layers, g_up, act, drop, seed)
        pairs = [("gx", gx, wgx)]
        for i, ((gw, gb), (ww, wb)) in enumerate(zip(grads, wgrads)):
            pairs += [(f"gW{i}", gw, ww), (f"gb{i}", gb, wb)]
        outside, nonfinite, matched = {}, 0, 0
        for name, got, want in pairs:   # on the card: gx is 8192 rows
            got, want = got.detach().double(), want.detach().double()
            fin = torch.isfinite(want)
            if name == "gx":
                tol = ATOL + RTOL * want[fin].abs()
            else:   # a batch sum: GRAD_REL of the largest finite element
                tol = GRAD_REL * (float(want[fin].abs().max()) if bool(fin.any()) else 0.0)
            n = int((~((got[fin] - want[fin]).abs() <= tol)).sum())
            if n:
                outside[name] = n
            nonfinite += int((~fin).sum())
            matched += int((torch.isnan(got) & torch.isnan(want)).sum()
                           + (got == want)[torch.isinf(want)].sum())
        report.append(f"{value:g}: outside {outside or 0}, not finite {nonfinite}, "
                      f"the same {matched}")
        if outside:
            failures.append(f"{what}, {value:g}")
    print(f"{what}: backward with one special input row, entries outside the "
          f"tolerances where autograd is finite, entries where autograd is not "
          f"finite, and where the kernel gives the same NaN or inf: {'; '.join(report)}")
    return failures


def _time_ms(fn, iters=50, warmup=5) -> float:
    """Device time of one call, in ms: CUDA events around `iters` calls.
    A sleep kernel holds the stream while the host enqueues them, so the
    events bracket the device's work and not the host's launch overhead
    (the wrappers' argument checks and ctypes calls cost tens of us)."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # twice the host's time for the loop, at 2 GHz; at most 0.2 s
    torch.cuda._sleep(int(min(2 * iters * host_s, 0.2) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flop: float, nbytes: float) -> dict:
    """A kernel's least time on the card, in ms: the larger of its FLOP at
    f32's 67 TFLOP/s and its bytes at 3.35 TB/s; and at 3xTF32's rate."""
    compute_ms, memory_ms = flop / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    by = "operations" if compute_ms >= memory_ms else "bytes"
    return {"bound_ms": max(compute_ms, memory_ms), "bound_by": by,
            "bound_kind": "compute" if by == "operations" else "memory",
            "bound_3xtf32_ms": max(flop / (TF32_FLOPS / 3) * 1e3, memory_ms)}


def _tower_work(batch, dims) -> dict:
    """FLOP and bytes of the tower kernels at [batch, dims[0]]: the forward
    (every layer's product), and the backward (the hidden layers'
    recompute, the transposed chain and the weight-gradient products),
    each input read once and each output written once."""
    macs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    params = sum(macs) + sum(dims[1:])
    fwd_bytes = 4 * (batch * dims[0] + params + batch)
    return {"fwd": (2 * batch * sum(macs), fwd_bytes),
            "bwd": (2 * batch * (sum(macs[:-1]) + 2 * sum(macs)),
                    4 * (2 * batch * dims[0] + batch + 2 * params))}


def _numpy_fnn(table, layers, schema, ids):
    """float64 numpy forward of FNN: gather, mask, pool, tower."""
    rows = table[ids].astype(np.float64)
    rows *= (ids != schema.pad_id)[..., None]
    pooled = np.zeros((ids.shape[0], schema.num_fields, table.shape[1]))
    for s, f in enumerate(schema.slot_field):
        pooled[:, f] += rows[:, s]
    h = pooled.reshape(ids.shape[0], -1)
    for i, layer in enumerate(layers):
        h = h @ layer["w"].astype(np.float64) + layer["b"]
        if i < len(layers) - 1:
            h = np.tanh(h)
    return h[:, 0]


def _device_ops(prof) -> list:
    """(device µs, count, name) of each op a ``torch.profiler`` run saw on
    the card, largest first."""
    from torch.autograd import DeviceType

    device = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        device.append((us, e.count, e.key))
    return sorted(device, reverse=True)


def _profile_scorer(scorer, ids, n_batches) -> None:
    """Device time per op and the device's busy share of the wall time,
    under ``torch.profiler``, for one ``Scorer.logits`` call. The profiler
    adds host time, so the busy share it gives is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scorer.logits(ids)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.logits(ids)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = _device_ops(prof)
    busy_us = sum(us for us, _, _ in device)
    print(f"profile: device busy {busy_us:.1f} us of {wall_us:.1f} us wall "
          f"({100 * busy_us / wall_us:.1f}%) for {n_batches} batches")
    for us, count, key in device[:10]:
        print(f"  {us / n_batches:9.2f} us/batch  {count // n_batches:3d}/batch  "
              f"{key[:90]}")


def _check_grad(what, got, want) -> float:
    """A batch-summed gradient: held to GRAD_REL of its largest element."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    return _check_close(f"{what} (atol {GRAD_REL:g} x max |want| = "
                        f"{GRAD_REL * scale:.2e})", got, want, rtol=0.0,
                        atol=GRAD_REL * scale)


def _in_turns(fns: dict, iters=50) -> dict:
    """Mean CUDA-event ms of each callable, timed in turns a, b, b, a."""
    names = list(fns)
    order = names + names[::-1]
    times = {name: [] for name in names}
    for name in order:
        times[name].append(_time_ms(fns[name], iters=iters))
    return {name: float(np.mean(t)) for name, t in times.items()}


def _relu_edge_rows(x, layers, drop, seed):
    """Rows ``[B]`` (bool) with a hidden pre-activation within RELU_EDGE of
    0, from a float64 forward with the tower's dropout masks."""
    import torch

    from deepctr_torch.ops.kernels.mlp import dropout_mask_plain

    h = x.double()
    edge = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for i, (w, b) in enumerate(layers[:-1]):
        z = h @ w.double() + b.double()
        edge |= (z.abs() < RELU_EDGE).any(dim=1)
        h = torch.relu(z)
        if drop > 0.0:
            h = h * dropout_mask_plain(tuple(h.shape), 1.0 - drop, seed, i,
                                       device=h.device).double()
    return edge


def _phase3_tower_fwd(dev, rng):
    """``mlp_tower_fwd`` against ``mlp_tower_plain`` at the serving and
    training shapes, each case also with SPECIAL_ROWS in its input, and the
    FNN and Criteo shapes timed on both. Returns ``({case: (kernel ms, plain
    ms)}, the first case's max abs error)``; raises after every case has
    printed if any failed."""
    import torch

    from deepctr_torch.ops.kernels import mlp as mlp_k

    in_dim = 16 * (1 + K)   # ipinyou_full_schema: 16 fields of 1+k
    fnn_dims = (in_dim,) + FNN_HIDDEN + (1,)
    cases = [
        ("fnn tanh", BATCH, fnn_dims, "tanh", True),
        ("fnn tanh, 8 batches", REQUESTS, fnn_dims, "tanh", True),
        ("fnn tanh ragged", 1000, fnn_dims, "tanh", True),
        ("snn tanh", BATCH, (SNN_HIDDEN1,) + SNN_HIDDEN + (1,), "tanh", False),
        ("criteo tanh", BATCH, (CRITEO_IN,) + CRITEO_HIDDEN + (1,), "tanh", True),
        ("criteo relu", BATCH, (CRITEO_IN,) + CRITEO_HIDDEN + (1,), "relu", False),
        ("small relu", 300, (24, 32, 16, 1), "relu", False),
        ("small sigmoid", 77, (24, 32, 16, 1), "sigmoid", False),
    ]
    tower_times = {}
    main_err = None
    failures = []
    for name, batch, dims, act, timed in cases:
        x = torch.from_numpy(
            rng.normal(size=(batch, dims[0])).astype(np.float32)).to(dev)
        layers = _tower(rng, dims, dev)
        got = mlp_k.mlp_tower_fwd(x, layers, act)
        torch.cuda.synchronize()
        want = mlp_k.mlp_tower_plain(x, layers, act)
        err = _check_close(f"kernel vs plain [{batch}, {dims[0]}] "
                           f"{'-'.join(map(str, dims[1:]))} {act} ({name})",
                           got.cpu(), want.cpu())
        if main_err is None:
            main_err = err
        failures += _check_special_rows(name, x, layers, act)
        if not timed:
            continue
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = mlp_k.mlp_tower_plain if which == "plain" else mlp_k.mlp_tower_fwd
            times[which].append(_time_ms(lambda: fn(x, layers, act)))
        kernel_ms = float(np.mean(times["kernel"]))
        plain_ms = float(np.mean(times["plain"]))
        tower_times[name] = (kernel_ms, plain_ms)
        flop = 2 * batch * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        print(f"time [{batch}, {dims[0]}]: kernel {kernel_ms:.4f} ms "
              f"({flop / kernel_ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms ({flop / plain_ms / 1e9:.2f} TFLOP/s); "
              f"runs {times}")
    if failures:
        raise AssertionError(f"special input rows: the kernel differs from the plain "
                             f"version in {failures}")
    return tower_times, main_err


def _phase6_training_kernels(dev, rng) -> dict:
    """The forward with dropout and the backward kernel against the plain
    tower and autograd through it, for FNN's tanh tower and DeepFM's relu
    tower; returns errors and times (FNN's) for the report."""
    import torch

    from deepctr_torch.ops.kernels import mlp as mlp_k

    in_dim = 16 * (1 + K)
    seed = 12345
    out = {"fwd_drop_err": 0.0, "bwd_err": 0.0}
    failures = []
    for act, hidden, batch, width in (("tanh", FNN_HIDDEN, BATCH, in_dim),
                                      ("tanh", FNN_HIDDEN, 1000, in_dim),
                                      ("relu", DEEPFM_HIDDEN, BATCH, in_dim),
                                      ("relu", DEEPFM_HIDDEN, 1000, in_dim),
                                      ("tanh", SNN_HIDDEN, BATCH, SNN_HIDDEN1),
                                      ("tanh", CRITEO_HIDDEN, BATCH, CRITEO_IN),
                                      ("relu", CRITEO_HIDDEN, BATCH, CRITEO_IN)):
        dims = (width,) + hidden + (1,)
        x = torch.from_numpy(rng.normal(size=(batch, width)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=batch).astype(np.float32)).to(dev)
        layers = _tower(rng, dims, dev)
        for drop in (DROPOUT, 0.0):
            tag = f"[{batch}, {width}] {'-'.join(map(str, dims[1:]))} {act} dropout {drop}"
            got = mlp_k.mlp_tower_fwd(x, layers, act, drop, seed)
            want = mlp_k.mlp_tower_plain(x, layers, act, drop, seed)
            err = _check_close(f"fwd kernel vs plain {tag}", got.cpu(), want.cpu())
            if drop > 0:
                out["fwd_drop_err"] = max(out["fwd_drop_err"], err)
            g_up = g
            if act == "relu":
                edge = _relu_edge_rows(x, layers, drop, seed)
                print(f"bwd {tag}: {int(edge.sum())} of {batch} rows have a hidden "
                      f"pre-activation within {RELU_EDGE:g} of 0; their upstream "
                      f"gradient is set to 0")
                g_up = torch.where(edge, 0.0, g)
            gx, grads = mlp_k.mlp_tower_bwd(x, layers, g_up, act, drop, seed)
            torch.cuda.synchronize()
            wgx, wgrads = mlp_k.mlp_tower_bwd_plain(x, layers, g_up, act, drop, seed)
            errs = [_check_close(f"bwd kernel vs autograd {tag}: gx", gx.cpu(),
                                 wgx.cpu())]
            for i, ((gw, gb), (ww, wb)) in enumerate(zip(grads, wgrads)):
                errs.append(_check_grad(f"bwd kernel vs autograd {tag}: gW{i}",
                                        gw.cpu(), ww.cpu()))
                errs.append(_check_grad(f"bwd kernel vs autograd {tag}: gb{i}",
                                        gb.cpu(), wb.cpu()))
            out["bwd_err"] = max(out["bwd_err"], *errs)
            gx2, grads2 = mlp_k.mlp_tower_bwd(x, layers, g_up, act, drop, seed)
            same = torch.equal(gx, gx2) and all(
                torch.equal(a, c) and torch.equal(b, d)
                for (a, b), (c, d) in zip(grads, grads2))
            print(f"bwd kernel {tag}: second launch bitwise equal: {same}")
            if not same:
                raise AssertionError("two backward launches gave different bits")
            # the seed as a 0-d device tensor (a graph's seed buffer): the
            # int seed's bits, forward and backward
            dseed = torch.tensor(seed, dtype=torch.int32, device=dev)
            gx3, grads3 = mlp_k.mlp_tower_bwd(x, layers, g_up, act, drop, dseed)
            same = (torch.equal(mlp_k.mlp_tower_fwd(x, layers, act, drop, dseed), got)
                    and torch.equal(gx, gx3) and all(
                        torch.equal(a, c) and torch.equal(b, d)
                        for (a, b), (c, d) in zip(grads, grads3)))
            print(f"fwd and bwd kernels {tag}: seed in device memory vs the int "
                  f"seed bitwise equal: {same}")
            if not same:
                raise AssertionError("a device seed gave other bits than the int seed")
            failures += _check_special_backward(f"bwd kernel vs autograd {tag}", x,
                                                layers, g, act, drop, seed)
        failures += _check_special_rows(f"fwd kernel vs plain [{batch}, {width}] "
                                        f"{'-'.join(map(str, dims[1:]))} {act}",
                                        x, layers, act)
    if failures:
        raise AssertionError(f"special input rows: the kernels differ from the plain "
                             f"versions in {failures}")

    dims = (in_dim,) + FNN_HIDDEN + (1,)
    x = torch.from_numpy(rng.normal(size=(BATCH, in_dim)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)).to(dev)
    layers = _tower(rng, dims, dev)
    xg = x.clone().requires_grad_(True)
    lg = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
          for w, b in layers]
    flat = [xg] + [t for pair in lg for t in pair]

    def kernel_step():
        torch.autograd.grad(mlp_k.mlp_tower(xg, lg, "tanh", DROPOUT, seed), flat, g)

    def plain_step():
        torch.autograd.grad(mlp_k.mlp_tower_plain(xg, lg, "tanh", DROPOUT, seed),
                            flat, g)

    fwd = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_plain(x, layers, "tanh", DROPOUT, seed),
        "kernel": lambda: mlp_k.mlp_tower_fwd(x, layers, "tanh", DROPOUT, seed)})
    bwd = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_bwd_plain(x, layers, g, "tanh", DROPOUT, seed),
        "kernel": lambda: mlp_k.mlp_tower_bwd(x, layers, g, "tanh", DROPOUT, seed)})
    both = _in_turns({"plain": plain_step, "kernel": kernel_step})
    for name, t in (("forward with dropout", fwd),
                    ("backward (recompute + gradients; plain: forward + "
                     "autograd)", bwd),
                    ("forward + backward (autograd.grad)", both)):
        print(f"time [{BATCH}, {dims[0]}] dropout {DROPOUT}, {name}: kernel "
              f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms")
    # without dropout the plain version has no hash mask to compute
    bwd0 = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_bwd_plain(x, layers, g, "tanh"),
        "kernel": lambda: mlp_k.mlp_tower_bwd(x, layers, g, "tanh")})
    print(f"time [{BATCH}, {dims[0]}] dropout 0, backward: kernel "
          f"{bwd0['kernel']:.4f} ms, plain {bwd0['plain']:.4f} ms")
    out.update(fwd_drop_ms=fwd["kernel"], fwd_drop_plain_ms=fwd["plain"],
               bwd_ms=bwd["kernel"], bwd_plain_ms=bwd["plain"])

    # the Criteo configs' tower, tanh with dropout 0.5
    x = torch.from_numpy(rng.normal(size=(BATCH, CRITEO_IN)).astype(np.float32)).to(dev)
    layers = _tower(rng, (CRITEO_IN,) + CRITEO_HIDDEN + (1,), dev)
    fwd = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_plain(x, layers, "tanh", DROPOUT, seed),
        "kernel": lambda: mlp_k.mlp_tower_fwd(x, layers, "tanh", DROPOUT, seed)})
    bwd = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_bwd_plain(x, layers, g, "tanh", DROPOUT, seed),
        "kernel": lambda: mlp_k.mlp_tower_bwd(x, layers, g, "tanh", DROPOUT, seed)})
    for name, t in (("forward with dropout", fwd), ("backward", bwd)):
        print(f"time [{BATCH}, {CRITEO_IN}] {'-'.join(map(str, CRITEO_HIDDEN))} tanh "
              f"dropout {DROPOUT}, {name}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms")
    out.update(criteo_fwd_drop_ms=fwd["kernel"], criteo_fwd_drop_plain_ms=fwd["plain"],
               criteo_bwd_ms=bwd["kernel"], criteo_bwd_plain_ms=bwd["plain"])
    return out


def _plain_train_step(schema, sparse_opt, dense_opt, plain_logits, l2=0.0):
    """The port's train step with the model's kernels replaced by their plain
    versions (``plain_logits(model, rows, mask, seed)``), built from the
    port's pieces: the comparator of the kernel path."""
    import torch

    from deepctr_torch.models import lazy_l2, weighted_bce_with_logits
    from deepctr_torch.train import dense_params

    def step(state, ids, labels, weights, seed):
        model = state.model
        mask = (ids != schema.pad_id).float()
        rows = model.table.detach()[ids].float().requires_grad_(True)
        params = dense_params(model)
        logits = plain_logits(model, rows, mask, seed)
        loss = weighted_bce_with_logits(logits, labels, weights)
        loss = loss + lazy_l2(rows, mask, l2)
        g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)
        sparse_opt.update(model.table.data, state.sparse_state, ids.reshape(-1),
                          g_rows.reshape(-1, g_rows.shape[-1]))
        dense_opt.update(params, g_dense, state.dense_state)
        state.step += 1
        return state, loss.detach()

    return step


def _fnn_plain_logits(model, rows, mask, seed):
    from deepctr_torch.ops.kernels.mlp import mlp_tower_plain

    spec = model.mlp.spec
    return mlp_tower_plain(model.tower_input(rows, mask), model.mlp.params(),
                           spec.activation, spec.dropout, seed)


def _fm_plain_logits(model, rows, mask, seed):
    from deepctr_torch.ops.kernels.interaction import fm_score_plain

    del seed
    return fm_score_plain(rows, mask) + model.bias


def _deepfm_plain_logits(model, rows, mask, seed):
    from deepctr_torch.models.base import pool_fields
    from deepctr_torch.ops.kernels.interaction import fm_score_plain
    from deepctr_torch.ops.kernels.mlp import mlp_tower_plain

    spec = model.mlp.spec
    pooled = pool_fields(rows, mask, model.slot_onehot)
    deep = mlp_tower_plain(pooled.reshape(pooled.shape[0], -1), model.mlp.params(),
                           spec.activation, spec.dropout, seed)
    return fm_score_plain(rows, mask) + deep + model.bias


def _snn_plain_logits(model, rows, mask, seed):
    from deepctr_torch.ops.kernels.mlp import mlp_tower_plain

    spec = model.mlp.spec
    return mlp_tower_plain(model.bottom(rows, mask), model.mlp.params(),
                           spec.activation, spec.dropout, seed)


def _bf16_ulps(a, b):
    import torch

    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _check_close_on_device(what, got, want, rtol, atol) -> None:
    """:func:`_check_close` for tensors too large to compare on the host."""
    err = (got.double() - want.double()).abs()
    bad = int((err > atol + rtol * want.double().abs()).sum())
    print(f"{what}: max |d| {float(err.max()):.3e} (rtol {rtol:g}, atol {atol:g}), "
          f"{bad} of {err.numel()} outside")
    if bad or not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: kernel and reference disagree")


def _compare_states(what, a, b) -> None:
    """Table, Adagrad accumulator and dense parameters of two states. A few
    table elements may lie further apart than rounding: Adagrad's first
    update of a coordinate is lr * g / (|g| + eps), which carries the last
    bits of a gradient near eps (or its sign near 0) into the row."""
    import torch

    allowed = a.table.numel() // 10000
    if a.table.dtype == torch.bfloat16:
        ulps = _bf16_ulps(a.table, b.table)
        far = int((ulps > 1).sum())
        print(f"{what}: table {int((ulps > 0).sum())} of {ulps.numel()} elements "
              f"differ, max {int(ulps.max())} bf16 ulps, {far} beyond 1 ulp "
              f"(allowed: {allowed})")
    else:
        err = (a.table - b.table).abs()
        far = int((err > 1e-5 + 1e-3 * b.table.abs()).sum())
        print(f"{what}: f32 table {int((err > 0).sum())} of {err.numel()} elements "
              f"differ, max |d| {float(err.max()):.3e}, {far} beyond atol 1e-5 + rtol "
              f"1e-3 (allowed: {allowed})")
    if far > allowed:
        raise AssertionError(f"{what}: tables disagree")
    acc_a, acc_b = a.sparse_state.acc, b.sparse_state.acc
    _check_close_on_device(f"{what}: Adagrad accumulator (atol 1e-6 x max)", acc_a,
                           acc_b, rtol=1e-3, atol=1e-6 * float(acc_b.max()))
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        if name != "table":
            _check_close(f"{what}: {name}", p.detach().cpu(), q.detach().cpu(),
                         rtol=1e-4, atol=1e-5)


def _profile_loop(run, n, tag, per="step") -> dict:
    """Device time per op and the device's busy share of the wall time,
    under ``torch.profiler``, for ``run(0) .. run(n - 1)`` after the same
    calls as a warm-up; each call is one ``per``. Also returns the port's
    kernels the trace names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(n):  # warm
        run(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = _device_ops(prof)
    busy_us = sum(us for us, _, _ in device)
    print(f"profile, {tag}: device busy {busy_us:.1f} us of {wall_us:.1f} "
          f"us wall ({100 * busy_us / wall_us:.1f}%) for {n} x {per}")
    # the top ops, and the port's own kernels and NCCL's wherever they rank
    kernels, nccl = set(), set()
    for i, (us, count, key) in enumerate(device):
        own = re.search(r"::(fm_score|tower_\w+)_kernel|nccl", key)
        if own and "nccl" not in own.group(0):
            kernels.add(own.group(0)[2:])
        elif own:
            nccl.add(key)
        if i < 14 or own:
            name = key.replace("void ", "").replace("at::native::", "")
            print(f"  {us / n:9.2f} us/{per}  {count / n:5.1f}/{per}  {name[:120]}")
    return {"device_us": busy_us / n, "wall_us": wall_us / n,
            "busy": busy_us / wall_us, "kernels": kernels, "nccl": nccl,
            "ops_per_call": sum(count for _, count, _ in device) / n}


def _profile_steps(step, state, batches, seeds, tag) -> None:
    """:func:`_profile_loop` around warm train steps (the state is updated
    in place)."""
    def run(i):
        step(state, *batches[i], seed=seeds[i])

    _profile_loop(run, len(batches), f"{tag} train step")


def _time_scatter_forms(dev, schema, ids) -> None:
    """The dense-mode occurrence-gradient scatter at the step's shape: the
    port's sorted prefix-sum form against ``index_put_(accumulate=True)``
    (deterministic too) and ``index_add_`` (float atomics), each with
    bitwise repeatability."""
    import torch

    from deepctr_torch.ops.scatter import scatter_totals

    shape = (schema.padded_vocab_size, 1 + K)
    occ = ids.reshape(-1)
    rows = torch.randn(occ.shape[0], 1 + K, device=dev)
    forms = {
        "sort + prefix-sum totals (the port's)":
            lambda: scatter_totals(shape[0], occ, rows),
        "index_put_(accumulate=True)":
            lambda: torch.zeros(shape, device=dev).index_put_((occ,), rows,
                                                              accumulate=True),
        "index_add_ (atomics)":
            lambda: torch.zeros(shape, device=dev).index_add_(0, occ, rows),
    }
    times = _in_turns(forms, iters=20)
    want = forms["index_put_(accumulate=True)"]().double()
    for name, fn in forms.items():
        got = fn()
        same = torch.equal(got, fn())
        err = float((got.double() - want).abs().max())
        print(f"scatter of {occ.shape[0]} occurrence rows into {shape}: {name} "
              f"{times[name]:.4f} ms, two calls bitwise equal: {same}, max |d| "
              f"vs index_put_ {err:.2e}")


def _fm_launch_shape(lib, batch, slots, d) -> str:
    """The launch ``fm_score_fwd`` makes at a shape, as the library reports
    it."""
    rows, ring, stages, blocks = (ctypes.c_int() for _ in range(4))
    smem = ctypes.c_size_t()
    code = lib.fm_score_launch_shape(batch, slots, d, ctypes.byref(rows),
                                     ctypes.byref(ring), ctypes.byref(stages),
                                     ctypes.byref(blocks), ctypes.byref(smem))
    if code != 0:
        raise AssertionError(f"fm_score_launch_shape returned {code}")
    how = (f"whole tiles by bulk copies into a ring of {stages.value} stages"
           if ring.value else "every tile by thread loads")
    return (f"{rows.value} examples a tile, {blocks.value} blocks, {smem.value} B of "
            f"dynamic shared memory, {how}")


def _phase7_fm_kernel(dev, rng) -> dict:
    """``fm_score_fwd`` against ``fm_score_plain`` on the card at the FM
    path's shapes, ragged batches, a small odd case and the Criteo configs'
    width; a second launch compared bit for bit; the first two shapes timed
    in turns beside an empty kernel of the same launch; the autograd
    Function's gradient against autograd through the plain version."""
    import torch

    from deepctr_torch.ops.kernels import _build
    from deepctr_torch.ops.kernels import interaction as fm_k

    lib = _build.load_library()
    lib.fm_score_empty.restype = ctypes.c_int
    lib.fm_score_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.fm_score_launch_shape.restype = ctypes.c_int
    lib.fm_score_launch_shape.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    cases = [(BATCH, 18, K, True), (REQUESTS, 18, K, True), (1000, 18, K, False),
             (77, 5, 3, False), (BATCH, 39, 16, False), (BATCH + 5, 18, K, False),
             (16, 18, K, False)]
    out = {"err": 0.0}

    def inputs(batch, slots, k):
        rows = rng.normal(0.0, FM_SIGMA, (batch, slots, 1 + k)).astype(np.float32)
        mask = (rng.random((batch, slots)) < 0.9).astype(np.float32)
        mask[0] = 0.0   # an all-pad example
        return (torch.from_numpy(rows).to(dev), torch.from_numpy(mask).to(dev))

    def empty(batch, slots, d):
        if lib.fm_score_empty(batch, slots, d, stream) != 0:
            raise AssertionError("fm_score_empty did not launch")

    for batch, slots, k, timed in cases:
        rows, mask = inputs(batch, slots, k)
        tag = f"[{batch}, {slots}, {1 + k}]"
        print(f"fm_score launch {tag}: {_fm_launch_shape(lib, batch, slots, 1 + k)}")
        got = fm_k.fm_score_fwd(rows, mask)
        torch.cuda.synchronize()
        want = fm_k.fm_score_plain(rows, mask)
        out["err"] = max(out["err"], _check_close(
            f"fm_score kernel vs plain {tag}", got.cpu(), want.cpu(),
            rtol=FM_TOL, atol=FM_TOL))
        same = torch.equal(got, fm_k.fm_score_fwd(rows, mask))
        print(f"fm_score kernel {tag}: second launch bitwise equal: {same}")
        if not same:
            raise AssertionError("two fm_score launches gave different bits")
        if timed:
            t = _in_turns({"plain": lambda: fm_k.fm_score_plain(rows, mask),
                           "kernel": lambda: fm_k.fm_score_fwd(rows, mask),
                           "empty": lambda: empty(batch, slots, 1 + k)})
            nbytes = 4 * (rows.numel() + mask.numel() + batch)
            print(f"time fm_score {tag}: kernel {t['kernel']:.4f} ms "
                  f"({nbytes / t['kernel'] / 1e6:.1f} GB/s of its {nbytes} bytes, "
                  f"{nbytes / HBM_BYTES * 1e3:.4f} ms at the card's memory rate), "
                  f"an empty kernel of the same launch {t['empty']:.4f} ms (the "
                  f"launch floor), plain {t['plain']:.4f} ms")
            if batch == REQUESTS:   # the kernels line's shape since it was ported
                out["ms"], out["plain_ms"] = t["kernel"], t["plain"]
                out["floor_ms"] = t["empty"]
            else:
                out["ms_train"], out["floor_ms_train"] = t["kernel"], t["empty"]
                # one 7.1 MB input stays in the 50 MB L2 over the timed
                # calls; eight in turn (57 MB) come from device memory
                sets = [(rows, mask)] + [inputs(batch, slots, k) for _ in range(7)]
                turn = [0]

                def cold():
                    turn[0] += 1
                    fm_k.fm_score_fwd(*sets[turn[0] % len(sets)])

                ms = float(np.mean([_time_ms(cold, iters=56) for _ in range(2)]))
                out["ms_train_cold"] = ms
                print(f"time fm_score {tag}, eight inputs in turn ({8 * nbytes} bytes, "
                      f"past the L2): kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s)")

    rows, mask = inputs(BATCH, 18, K)
    g = torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)).to(dev)
    r = rows.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(fm_k.fm_score(r, mask), [r], g)
    (want,) = torch.autograd.grad(fm_k.fm_score_plain(r, mask), [r], g)
    _check_close(f"fm_score gradient vs autograd through the plain version "
                 f"[{BATCH}, 18, {1 + K}]", got.cpu(), want.cpu(), rtol=FM_TOL,
                 atol=FM_TOL)
    return out


def _reset_counts() -> None:
    from deepctr_torch.ops.kernels import interaction as fm_k
    from deepctr_torch.ops.kernels import mlp as mlp_k
    from deepctr_torch.ops.kernels import sparse as sparse_k
    from deepctr_torch.train import step as step_m

    mlp_k.LAUNCHES = mlp_k.DROPOUT_LAUNCHES = mlp_k.BWD_LAUNCHES = 0
    fm_k.LAUNCHES = sparse_k.LAUNCHES = 0
    step_m.CAPTURES = 0


def _counts() -> dict:
    """The kernels' launch counts (a graph replay adds what its capture
    recorded), and the graphs captured: each capture ran one eager warm-up
    step on its state (then restored), whose launches count too.
    ``adagrad_dense`` is the dense-mode sparse Adagrad's: one a step in
    dense mode, none in sorted mode."""
    from deepctr_torch.ops.kernels import interaction as fm_k
    from deepctr_torch.ops.kernels import mlp as mlp_k
    from deepctr_torch.ops.kernels import sparse as sparse_k
    from deepctr_torch.train import step as step_m

    return {"fwd_dropout": mlp_k.DROPOUT_LAUNCHES, "bwd": mlp_k.BWD_LAUNCHES,
            "fwd_eval": mlp_k.LAUNCHES - mlp_k.DROPOUT_LAUNCHES,
            "fm_score": fm_k.LAUNCHES, "adagrad_dense": sparse_k.LAUNCHES,
            "captures": step_m.CAPTURES}


def _route_steps(cfg, batches: int) -> int:
    """The steps a run of ``batches`` batches takes: on the scan route
    (``train.scan_steps`` K > 1, sharded or not) the last chunk is padded
    to K."""
    k = cfg.train.scan_steps
    return batches if k <= 1 else k * -(-batches // k)


def _graph_launches(launches: dict, steps: int) -> int:
    """The tower's training launches of a CLI run of ``steps`` steps on the
    scan route: one a step (a replay adds its capture's), and one more a
    capture for its warm-up step on the state (then restored). Raises unless the
    run captured a graph."""
    if launches["captures"] < 1:
        raise AssertionError(f"no graph captured on the scan route: {launches}")
    return steps + launches["captures"]


def _cli_train(dev, root, tmp, config, overrides, steps, tag, table_dtype="bf16"):
    """One training run through ``deepctr_torch.cli``'s ``run`` with the
    kernel counts set to 0 just before it and read just after; checks the
    step count (``steps`` batches, padded to whole chunks on the scan
    route), a finite loss and an eval record. Returns (cfg, overrides,
    result, launches, metrics events)."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig

    examples = int(np.ceil(steps * BATCH / (1 - TEST_FRACTION))) + 1
    metrics = os.path.join(tmp, f"{tag}_metrics.jsonl")
    overrides = overrides + [
        f"train.batch_size={BATCH}", f"train.table_dtype={table_dtype}",
        f"data.synthetic_examples={examples}", "train.epochs=1",
        f"train.metrics_path={metrics}"]
    cfg = RunConfig.load(os.path.join(root, config)).apply_overrides(overrides)
    print(f"{tag} train: python -m deepctr_torch.cli --config {config} "
          f"{' '.join(overrides)} --device cuda")
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = cli.run(cfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    rec = result["history"][0]
    state = result["state"]
    print(f"{tag} cli train: {state.step} steps in {wall:.2f} s (data, init, epoch, "
          f"eval, checkpoint); launches {launches}; train_loss "
          f"{rec['train_loss']:.5f}, eval auc {rec['auc']:.5f}, logloss "
          f"{rec['logloss']:.5f}, rmse {rec.get('rmse', float('nan')):.5f}; "
          f"dropped_ids {rec.get('dropped_ids', 0)}; examples_per_s "
          f"{rec['examples_per_s']:.0f} (host clock, the epoch's steps)")
    if state.step != _route_steps(cfg, steps):
        raise AssertionError(f"{tag}: {state.step} steps, expected "
                             f"{_route_steps(cfg, steps)}")
    if not np.isfinite(rec["train_loss"]):
        raise AssertionError(f"{tag}: loss not finite: {rec}")
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    if not any("auc" in e for e in events):
        raise AssertionError(f"{tag}: no eval record in the metrics file")
    return cfg, overrides, result, launches, events


def _check_cli_score(config_path, overrides, state, schema, te_ids, te_labels,
                     tmp, tag) -> None:
    """The run's checkpoint through ``--score`` against the eval step on the
    trained state."""
    from deepctr_torch import cli
    from deepctr_torch.data import synthetic
    from deepctr_torch.train import make_eval_step

    yx = os.path.join(tmp, f"{tag}_test_rows.yx")
    synthetic.write_yx_file(synthetic.SyntheticDataset(
        schema, te_ids, te_labels, np.zeros(len(te_labels), np.float32)), yx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--config", config_path, "--score", yx, *overrides,
                       "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"deepctr_torch.cli --score returned {rc}")
    probs = np.array(out.getvalue().split(), dtype=np.float64)
    eval_step = make_eval_step(schema)
    logits = np.concatenate([
        eval_step(state.model, te_ids[i:i + BATCH]).cpu().numpy()
        for i in range(0, len(te_ids), BATCH)])
    _check_close(f"{tag} train: --score of the checkpoint vs eval step "
                 f"({len(probs)} test rows)", probs,
                 1.0 / (1.0 + np.exp(-np.clip(logits, -30, 30))),
                 rtol=0.0, atol=PROB_ATOL)


def _check_steps(dev, cfg, schema, state, tr_ids, tr_labels, plain_logits, tag):
    """The kernel path against the plain comparator over 5 steps from one
    state, and 3 kernel steps run twice compared bit for bit. Returns
    (kernel step, plain step, batches, seeds)."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.train import make_train_step

    sparse_opt, dense_opt = cli.build_optimizers(cfg)
    kstep = make_train_step(schema, sparse_opt, dense_opt, l2=cfg.optim.l2)
    pstep = _plain_train_step(schema, sparse_opt, dense_opt, plain_logits,
                              l2=cfg.optim.l2)
    batches = []
    for i in range(10):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        batches.append((torch.from_numpy(tr_ids[sl]).to(dev).long(),
                        torch.from_numpy(tr_labels[sl]).to(dev),
                        torch.ones(BATCH, device=dev)))
    seeds = [int(s) for s in np.random.default_rng(SEED + 7).integers(0, 1 << 24, 10)]
    k_state, p_state = state.clone(), state.clone()
    for i in range(5):
        k_state, km = kstep(k_state, *batches[i], seed=seeds[i])
        p_state, pl = pstep(p_state, *batches[i], seed=seeds[i])
        _check_close(f"{tag}, 5 steps, kernel vs plain: loss of step {i}",
                     [float(km.loss)], [float(pl)], rtol=1e-4, atol=1e-6)
    _compare_states(f"{tag}, 5 steps, kernel vs plain", k_state, p_state)

    a, b = state.clone(), state.clone()
    for i in range(3):
        a, _ = kstep(a, *batches[i])
        b, _ = kstep(b, *batches[i])
    same = (torch.equal(a.table, b.table)
            and torch.equal(a.sparse_state.acc, b.sparse_state.acc)
            and all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                      b.model.parameters())))
    print(f"{tag}, 3 steps twice from one state: table, accumulator and dense "
          f"parameters bit-identical: {same}")
    if not same:
        raise AssertionError(f"{tag}: the train step is not bitwise repeatable")
    return kstep, pstep, batches, seeds


def _time_steps(kstep, pstep, state, batches, seeds, tag) -> dict:
    """Step time on the card: batches already on the card, CUDA events over
    10 steps, kernel path and plain comparator in turns."""
    import torch

    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        st = state.clone()
        fn = kstep if which == "kernel" else pstep
        for i in range(2):
            st, _ = fn(st, *batches[i], seed=seeds[i])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(10):
            st, _ = fn(st, *batches[i], seed=seeds[i])
        end.record()
        end.synchronize()
        times[which].append(start.elapsed_time(end) / 10)
        del st
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"{tag} train step on the card ({BATCH} rows, CUDA events over 10 steps, "
          f"in turns): kernel {step_ms['kernel']:.4f} ms, plain "
          f"{step_ms['plain']:.4f} ms; runs {times}")
    return step_ms


def _phase8_fm_training(dev, root, tmp, schema, schema_path) -> dict:
    """FM k=10 (``configs/fm_k10.json``) trained through the CLI at full
    iPinYou width: the path that runs the FM scorer kernel."""
    from deepctr_torch import cli
    from deepctr_torch.utils.checkpoint import load_fm_embeddings

    ckpt = os.path.join(tmp, "fm_train.ckpt")
    overrides = [f"data.schema_path={schema_path}", f"train.checkpoint_path={ckpt}"]
    cfg, overrides, result, launches, _ = _cli_train(dev, root, tmp, FM_CONFIG,
                                                     overrides, TRAIN_STEPS, "fm")
    state = result["state"]
    rec = result["history"][0]
    _, tr_ids, tr_labels, te_ids, te_labels = cli.load_data(cfg)
    if launches["fm_score"] <= state.step:
        raise AssertionError(f"fm: fm_score launched {launches['fm_score']} times in "
                             f"{state.step} steps and an eval")
    if rec["auc"] <= 0.5:
        raise AssertionError(f"fm: training did not learn: {rec}")
    fm_table = load_fm_embeddings(ckpt + ".fm_table")
    if not np.array_equal(fm_table, state.table.float().cpu().numpy()):
        raise AssertionError("fm: the .fm_table file is not the trained table")
    print(f"fm: {ckpt}.fm_table written, {fm_table.shape} = the trained table")
    _check_cli_score(os.path.join(root, FM_CONFIG), overrides, state,
                     schema, te_ids, te_labels, tmp, "fm")
    kstep, pstep, batches, seeds = _check_steps(
        dev, cfg, schema, state, tr_ids, tr_labels, _fm_plain_logits, "fm")
    step_ms = _time_steps(kstep, pstep, state, batches, seeds, "fm")
    _profile_steps(kstep, state.clone(), batches[:5], seeds[:5], "fm")
    return {"launches": launches, "step_ms": step_ms, "fm_table": ckpt + ".fm_table"}


def _phase9_fnn_training(dev, root, tmp, schema, schema_path, fm_table) -> dict:
    """FNN (``configs/fnn_full_ipinyou.json``) seeded from phase 8's FM table
    and trained through the CLI: the FM -> FNN pipeline on the port."""
    from deepctr_torch import cli

    ckpt = os.path.join(tmp, "fnn_train.ckpt")
    overrides = [f"model.init_from={fm_table}", f"data.schema_path={schema_path}",
                 f"train.checkpoint_path={ckpt}"]
    cfg, overrides, result, launches, events = _cli_train(
        dev, root, tmp, FNN_CONFIG, overrides, TRAIN_STEPS, "fnn")
    state = result["state"]
    rec = result["history"][0]
    if not any(e.get("event") == "init_from_fm" and e.get("path") == fm_table
               for e in events):
        raise AssertionError("fnn: the run did not start from the FM table")
    print(f"fnn: started from {fm_table} (init_from_fm in the metrics file)")
    if launches["fwd_dropout"] < state.step or launches["bwd"] < state.step:
        raise AssertionError(f"fnn: training kernels launched {launches} in "
                             f"{state.step} steps")
    # dense mode (auto on 927,658 x 11): one sparse update a step, as the backward
    if launches["adagrad_dense"] != launches["bwd"]:
        raise AssertionError(f"fnn: the dense-mode sparse Adagrad launched "
                             f"{launches['adagrad_dense']} times, not once a step "
                             f"({launches['bwd']})")
    if launches["fwd_eval"] < 1:
        raise AssertionError("fnn: eval launched no dropout-free forward kernel")
    if rec["auc"] <= 0.5:
        raise AssertionError(f"fnn: training did not learn: {rec}")
    _, tr_ids, tr_labels, te_ids, te_labels = cli.load_data(cfg)
    _check_cli_score(os.path.join(root, FNN_CONFIG), overrides, state,
                     schema, te_ids, te_labels, tmp, "fnn")
    kstep, pstep, batches, seeds = _check_steps(
        dev, cfg, schema, state, tr_ids, tr_labels, _fnn_plain_logits, "fnn")
    step_ms = _time_steps(kstep, pstep, state, batches, seeds, "fnn")
    _time_scatter_forms(dev, schema, batches[0][0])
    _profile_steps(kstep, state.clone(), batches[:5], seeds[:5], "fnn")
    return {"launches": launches, "step_ms": step_ms, "cfg": cfg, "ckpt": ckpt,
            "overrides": overrides}


def _phase10_deepfm(dev, root, tmp, schema, schema_path) -> dict:
    """DeepFM at full width, a short training run through the CLI (the FM
    scorer and both tower kernels, relu with dropout), ``--score`` of its
    checkpoint, then 5 steps of the kernel path against the plain
    comparator and 3 steps run twice compared bit for bit."""
    from deepctr_torch import cli

    ckpt = os.path.join(tmp, "deepfm_train.ckpt")
    hidden = ",".join(map(str, DEEPFM_HIDDEN))
    overrides = ["model.name=deepfm", f"model.hidden={hidden}", "model.activation=relu",
                 "model.dropout=0.5", "model.init_from=none",
                 f"data.schema_path={schema_path}", f"train.checkpoint_path={ckpt}"]
    cfg, overrides, result, launches, _ = _cli_train(
        dev, root, tmp, FNN_CONFIG, overrides, DEEPFM_STEPS, "deepfm")
    state = result["state"]
    if (launches["fm_score"] <= state.step or launches["fwd_dropout"] < state.step
            or launches["bwd"] < state.step or launches["fwd_eval"] < 1):
        raise AssertionError(f"deepfm: kernels launched {launches} in {state.step} "
                             f"steps")
    _, tr_ids, tr_labels, te_ids, te_labels = cli.load_data(cfg)
    _check_cli_score(os.path.join(root, FNN_CONFIG), overrides, state,
                     schema, te_ids, te_labels, tmp, "deepfm")
    kstep, _, batches, seeds = _check_steps(dev, cfg, schema, state, tr_ids, tr_labels,
                                            _deepfm_plain_logits, "deepfm")
    _profile_steps(kstep, state.clone(), batches[:5], seeds[:5], "deepfm")
    return {"launches": launches}


def _phase11_lr_ipnn(dev, tmp, schema) -> None:
    """LR and IPNN: ``--score`` of a checkpoint written from seeded
    parameters, against the plain path on the card (IPNN: its products and
    the plain tower) and a float64 numpy forward (LR)."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.models import MlpSpec, make_pnn
    from deepctr_torch.ops.kernels import mlp as mlp_k
    from deepctr_torch.serving import Scorer
    from deepctr_torch.data import synthetic
    from deepctr_torch.utils.checkpoint import save_scoring_params

    n = 2 * BATCH
    ds = synthetic.generate(schema, num_examples=n, k=K, seed=SEED + 3)
    yx = os.path.join(tmp, "lr_ipnn_requests.yx")
    synthetic.write_yx_file(ds, yx)
    prng = np.random.default_rng(SEED + 4)
    mask = ds.ids != schema.pad_id

    def score(name, ckpt, extra):
        out = io.StringIO()
        _reset_counts()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--score", yx, f"train.checkpoint_path={ckpt}",
                           f"model.name={name}", f"model.k={K}",
                           f"train.batch_size={BATCH}", *extra, "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"deepctr_torch.cli --score ({name}) returned {rc}")
        probs = np.array(out.getvalue().split(), dtype=np.float64)
        if probs.shape != (n,):
            raise AssertionError(f"{name}: scored {probs.shape} rows, expected {n}")
        return probs, _counts()

    table = prng.normal(0.0, 0.3, (schema.padded_vocab_size, 1)).astype(np.float32)
    table[schema.pad_id] = 0.0
    bias = np.float32(-0.2)
    ckpt = os.path.join(tmp, "lr.ckpt")
    save_scoring_params(ckpt, table, {"bias": bias}, schema=schema, meta={"model": "lr"})
    probs, _ = score("lr", ckpt, [])
    logits = (table[ds.ids, 0].astype(np.float64) * mask).sum(axis=1) + bias
    _check_close("lr: cli --score vs float64 numpy forward", probs,
                 1.0 / (1.0 + np.exp(-logits)), rtol=0.0, atol=PROB_ATOL)

    table = prng.normal(0.0, 0.3, (schema.padded_vocab_size, 1 + K)).astype(np.float32)
    table[schema.pad_id] = 0.0
    fields = schema.num_fields
    dims = (fields * (1 + K) + fields * (fields - 1) // 2,) + PNN_HIDDEN + (1,)
    ckpt = os.path.join(tmp, "ipnn.ckpt")
    save_scoring_params(ckpt, table, {"mlp": {"layers": _np_layers(prng, dims)}},
                        schema=schema, meta={"model": "ipnn"})
    hidden = ",".join(map(str, PNN_HIDDEN))
    probs, launches = score("ipnn", ckpt, [f"model.hidden={hidden}",
                                           "model.activation=relu"])
    if launches["fwd_eval"] < 1:
        raise AssertionError("ipnn: scoring launched no tower kernel")
    spec = MlpSpec(hidden=PNN_HIDDEN, activation="relu")
    model = Scorer.from_checkpoint(ckpt, make_pnn(schema, k=K, product="inner",
                                                  mlp=spec, device=dev)).model
    with torch.inference_mode():
        plain = []
        for i in range(0, n, BATCH):
            ids = torch.from_numpy(ds.ids[i:i + BATCH]).to(dev).long()
            rows = model.table[ids]
            x = model.tower_input(rows, (ids != schema.pad_id).float())
            plain.append(mlp_k.mlp_tower_plain(x, model.mlp.params(), "relu")
                         .cpu().numpy())
    plain = np.concatenate(plain)
    print(f"ipnn: tower input {dims[0]} ({fields} fields of {1 + K} and "
          f"{fields * (fields - 1) // 2} inner products), {launches['fwd_eval']} "
          f"tower kernel launches")
    _check_close("ipnn: cli --score vs the plain path on the card", probs,
                 1.0 / (1.0 + np.exp(-np.clip(plain, -30, 30))), rtol=0.0,
                 atol=PROB_ATOL)


def _pretrain_steps_on_card(dev, schema, cfg, tr_ids, kind, steps) -> None:
    """``steps`` pretraining steps of ``kind`` at the run's batch size from a
    fresh table: wall time per step (host clock, ending in a synchronize)
    and ``torch.profiler`` around warm steps."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.models import DaePretrainer, RbmPretrainer, init_pretrain_dense
    from deepctr_torch.models.base import init_table
    from deepctr_torch.train import make_pretrain_step

    pre = (DaePretrainer(m=cfg.train.pretrain_m, corruption=cfg.train.pretrain_corruption)
           if kind == "dae" else RbmPretrainer(m=cfg.train.pretrain_m))
    sparse_opt, _ = cli.build_optimizers(cfg)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.zeros(schema.padded_vocab_size, cfg.model.hidden1, device=dev)
    init_table(table, generator, 0.01, schema.pad_id)
    dense = init_pretrain_dense(schema, cfg.model.hidden1, dev)
    sparse_state = sparse_opt.init(table)
    pstep = make_pretrain_step(pre, schema, sparse_opt, cfg.train.pretrain_lr)
    batches = [torch.from_numpy(tr_ids[i * BATCH:(i + 1) * BATCH]).to(dev).long()
               for i in range(steps)]
    losses = []

    def run(i):
        losses.append(pstep(table, sparse_state, dense, generator, batches[i])[-1])

    run(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        run(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    occ = BATCH * (schema.num_slots * (2 if kind == "dae" else 1)
                   + schema.num_fields * cfg.train.pretrain_m)
    print(f"snn {kind} pretrain step on the card ({BATCH} rows, {occ} occurrence rows "
          f"of {cfg.model.hidden1} floats, host clock over {steps} steps): "
          f"{wall_ms:.3f} ms; loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f}")
    if not all(np.isfinite(float(x)) for x in losses):
        raise AssertionError(f"snn {kind} pretraining: loss not finite")
    _profile_loop(run, steps, f"snn {kind} pretrain step")


def _check_scatter_range(dev, schema, cfg, state, tr_ids) -> None:
    """The occurrence scatter's fixed-point prefix sums at a DAE step's size
    (every encoder and candidate occurrence of the batch, rows of hidden1
    floats) against float64 sums of the same rows."""
    import torch

    from deepctr_torch.models import DaePretrainer, field_sampling, init_pretrain_dense
    from deepctr_torch.ops.scatter import dedupe_grads

    pre = DaePretrainer(m=cfg.train.pretrain_m, corruption=cfg.train.pretrain_corruption)
    ids = torch.from_numpy(tr_ids[:BATCH]).to(dev).long()
    _, occ_ids, occ_rows, _ = pre.loss_and_grads(
        state.table, init_pretrain_dense(schema, cfg.model.hidden1, dev), ids,
        schema.pad_id, field_sampling(schema, dev),
        torch.Generator(device=dev).manual_seed(SEED))
    d = dedupe_grads(occ_ids, occ_rows)
    shape = (schema.padded_vocab_size, occ_rows.shape[1])
    got = torch.zeros(shape, dtype=torch.float64, device=dev)
    got[d.ids[d.is_last]] = d.rows[d.is_last].double()
    want = torch.zeros(shape, dtype=torch.float64, device=dev).index_add_(
        0, occ_ids, occ_rows.double())
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    _, exponent = torch.frexp(occ_rows.abs().max().double() * occ_rows.numel())
    print(f"snn: scatter of {occ_ids.shape[0]} occurrence rows of {occ_rows.shape[1]} "
          f"floats ({int(d.is_last.sum())} distinct ids): fixed-point step "
          f"2^{int(exponent) - 61} against max |g| {float(occ_rows.abs().max()):.3e}; "
          f"totals vs float64 sums max |d| {err:.3e}, max |total| {scale:.3e}")
    # an f32 total carries half an ulp, 6e-8 of its magnitude
    if not err <= 1e-6 * scale:
        raise AssertionError("snn: the occurrence scatter lost precision at this size")


def _phase12_snn(dev, root, tmp, schema, schema_path) -> None:
    """SNN (``configs/snn_rbm.json``) at full iPinYou width through the CLI:
    RBM pretraining, the hand-off, fine-tuning through both tower kernels,
    eval, a checkpoint scored by ``--score``; then the same with DAE
    pretraining, shorter."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.optim.sparse import _pick_dense

    torch.cuda.reset_peak_memory_stats()
    ckpt = os.path.join(tmp, "snn_train.ckpt")
    overrides = [f"data.schema_path={schema_path}", f"train.checkpoint_path={ckpt}"]
    print(f"snn: {SNN_CONFIG} cut to {SNN_STEPS} pretraining steps and {SNN_STEPS} "
          f"fine-tune steps of {BATCH} (the config: 1 pretraining epoch and 10 epochs "
          f"over 200,000 examples at batch 4096)")
    cfg, overrides, result, launches, events = _cli_train(
        dev, root, tmp, SNN_CONFIG, overrides, SNN_STEPS, "snn", table_dtype="f32")
    state = result["state"]
    rec = result["history"][0]
    pre = [e for e in events if "pretrain_loss" in e]
    if (len(pre) != cfg.train.pretrain_epochs
            or not all(np.isfinite(e["pretrain_loss"]) for e in pre)):
        raise AssertionError(f"snn: pretraining records {pre}")
    if not any(e.get("event") == "init_from_pretrain" and e.get("kind") == "rbm"
               for e in events):
        raise AssertionError("snn: the run did not start from the pretrained table")
    print(f"snn: rbm pretraining reconstruction error {pre[0]['pretrain_loss']:.5f} "
          f"(mean of the epoch), init_from_pretrain in the metrics file; table "
          f"{tuple(state.table.shape)} {state.table.dtype}, sparse optimizer mode: "
          f"{'dense' if _pick_dense(cfg.optim.sparse_mode, state.table) else 'sorted'}")
    if launches["fwd_dropout"] < state.step or launches["bwd"] < state.step:
        raise AssertionError(f"snn: training kernels launched {launches} in "
                             f"{state.step} steps")
    if launches["fwd_eval"] < 1:
        raise AssertionError("snn: eval launched no dropout-free forward kernel")
    if rec["auc"] <= 0.5:
        raise AssertionError(f"snn: training did not learn: {rec}")
    _, tr_ids, tr_labels, te_ids, te_labels = cli.load_data(cfg)
    _check_cli_score(os.path.join(root, SNN_CONFIG), overrides, state, schema,
                     te_ids, te_labels, tmp, "snn")
    os.remove(ckpt)
    kstep, pstep, batches, seeds = _check_steps(
        dev, cfg, schema, state, tr_ids, tr_labels, _snn_plain_logits, "snn")
    _time_steps(kstep, pstep, state, batches, seeds, "snn")
    _profile_steps(kstep, state.clone(), batches[:5], seeds[:5], "snn")
    _check_scatter_range(dev, schema, cfg, state, tr_ids)
    _pretrain_steps_on_card(dev, schema, cfg, tr_ids, "rbm", 5)
    _pretrain_steps_on_card(dev, schema, cfg, tr_ids, "dae", 5)
    del state, result, kstep, pstep, batches

    print(f"snn-dae: the same run with train.pretrain=dae, cut to {SNN_DAE_STEPS} "
          f"pretraining steps and {SNN_DAE_STEPS} fine-tune steps, no checkpoint")
    _, _, result, dae_launches, events = _cli_train(
        dev, root, tmp, SNN_CONFIG,
        [f"data.schema_path={schema_path}", "train.pretrain=dae"], SNN_DAE_STEPS,
        "snn-dae", table_dtype="f32")
    pre = [e for e in events if "pretrain_loss" in e]
    if not pre or not all(np.isfinite(e["pretrain_loss"]) for e in pre):
        raise AssertionError(f"snn-dae: pretraining records {pre}")
    if not any(e.get("event") == "init_from_pretrain" and e.get("kind") == "dae"
               for e in events):
        raise AssertionError("snn-dae: the run did not start from the pretrained table")
    steps = result["state"].step
    if (dae_launches["fwd_dropout"] < steps or dae_launches["bwd"] < steps
            or dae_launches["fwd_eval"] < 1):
        raise AssertionError(f"snn-dae: kernels launched {dae_launches} in {steps} steps")
    print(f"snn-dae: dae pretraining loss {pre[0]['pretrain_loss']:.5f}, "
          f"init_from_pretrain in the metrics file")
    print(f"snn: peak device memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _retrain_run(dev, root, overrides, tag):
    """One run of ``deepctr_torch.cli``'s ``run`` on ``configs/fnn_full_ipinyou
    .json`` with ``overrides``, the kernel counts set to 0 just before it
    and read just after. Returns (result, launches, wall s)."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig

    cfg = RunConfig.load(os.path.join(root, FNN_CONFIG)).apply_overrides(overrides)
    print(f"{tag}: python -m deepctr_torch.cli --config {FNN_CONFIG} "
          f"{' '.join(overrides)} --device cuda")
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = cli.run(cfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    rates = [round(r["examples_per_s"]) for r in result["history"]
             if "examples_per_s" in r]
    print(f"{tag}: {result['state'].step} steps in {wall:.2f} s; launches {launches}; "
          f"eval auc {[round(r['auc'], 5) for r in result['history']]}; epoch "
          f"examples/s {rates} (host clock)")
    return result, launches, wall


def _ckpt_leaves(path) -> list:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        return manifest, [z[f"leaf_{i}"] for i in range(manifest["n"])]


def _same_state(a, b) -> bool:
    """Two train states hold the same bits: step, table, both optimizers'
    states, the tower and the dropout generator."""
    import torch

    from deepctr_torch.utils.checkpoint import _state_leaves

    def leaves(state):
        table, sparse, dense, dense_state = _state_leaves(state)
        return [table, *sparse, *dense, *dense_state, state.generator.get_state()]

    la, lb = leaves(a), leaves(b)
    return (a.step == b.step and len(la) == len(lb)
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def _check_histogram_auc(dev, state, schema, te_ids, te_labels) -> None:
    """Run A's eval logits, kept on the card, through ``AucState``: the
    finalized AUC against ``exact_auc`` of the same logits, the histograms
    against host bin counts, and the host's waits on the card during update
    (none) and finalize (two: the copies of the two ``[4096]`` vectors),
    counted by torch's sync debug mode, which warns at every synchronizing
    CUDA operation. (A profiler's list of copies proved no gate: one run's
    trace held none of them.)"""
    import warnings

    import torch

    from deepctr_torch.train import make_eval_step
    from deepctr_torch.utils import metrics as M

    eval_step = make_eval_step(schema)
    logits = torch.cat([eval_step(state.model, te_ids[i:i + BATCH])
                        for i in range(0, len(te_ids), BATCH)])
    labels = torch.from_numpy(te_labels).to(dev)
    weights = torch.ones_like(labels)
    torch.cuda.synchronize()

    def host_syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, sum("synchronizing CUDA operation" in str(w.message) for w in caught)

    def update():
        st = M.auc_state_init(4096, device=dev)
        for i in range(0, len(te_ids), BATCH):
            sl = slice(i, i + BATCH)
            M.auc_state_update(st, logits[sl], labels[sl], weights[sl])
        return st

    st, update_syncs = host_syncs(update)
    got, finalize_syncs = host_syncs(lambda: M.auc_state_finalize(st))
    host = logits.cpu().numpy()
    want = M.exact_auc(te_labels, 1.0 / (1.0 + np.exp(-host)))
    bins = torch.clamp((torch.sigmoid(logits) * 4096).int(), 0, 4095).cpu().numpy()
    same = (np.array_equal(st.pos.cpu().numpy(), np.bincount(
        bins, weights=te_labels, minlength=4096).astype(np.float32))
        and np.array_equal(st.neg.cpu().numpy(), np.bincount(
            bins, weights=1.0 - te_labels, minlength=4096).astype(np.float32)))
    print(f"retrain: histogram AUC on the card {got:.6f} vs exact {want:.6f} "
          f"(|d| {abs(got - want):.2e}, at most 2e-3) over {len(te_ids)} eval "
          f"logits; histograms equal to host bin counts: {same}; host syncs in "
          f"update {update_syncs}, in finalize {finalize_syncs}")
    if not abs(got - want) < 2e-3 or not same:
        raise AssertionError("retrain: the histogram AUC disagrees")
    if (update_syncs, finalize_syncs) != (0, 2):
        raise AssertionError(f"retrain: host syncs {update_syncs} in update and "
                             f"{finalize_syncs} in finalize, expected 0 and 2")


def _profile_feeds(dev, root, schema, cfg_overrides, tr_ids, tr_labels) -> dict:
    """Warm train steps of run A's configuration under ``torch.profiler``,
    fed by numpy batches (copied in the step) and by the prefetcher: the
    device's busy share and its time a step, each way."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig
    from deepctr_torch.data import DevicePrefetcher, minibatches
    from deepctr_torch.train import init_state, make_train_step

    cfg = RunConfig.load(os.path.join(root, FNN_CONFIG)).apply_overrides(cfg_overrides)
    model = cli.build_model(cfg, schema, dev)
    sparse_opt, dense_opt = cli.build_optimizers(cfg)
    state = init_state(model, schema, sparse_opt, dense_opt, seed=0,
                       table_dtype="bf16")
    step = make_train_step(schema, sparse_opt, dense_opt, l2=cfg.optim.l2)
    out = {}
    for feed in ("numpy", "prefetcher"):
        it = minibatches(tr_ids, tr_labels, BATCH, schema=schema, seed=1,
                         drop_remainder=True)
        if feed == "prefetcher":
            it = DevicePrefetcher(it, dev)

        def run(i):
            b = next(it)
            step(state, b.ids, b.labels, b.weights)

        out[feed] = _profile_loop(run, 5, f"retrain, batches from {feed}")
        if feed == "prefetcher":
            it.close()
    return out


def _phase13_retrain(dev, root, tmp, schema, schema_path) -> dict:
    """The resumable, streamed retraining job at full width through the CLI:
    shards streamed and prefetched, killed after an epoch and resumed to the
    uninterrupted run's bits; prefetch on and off in RAM; the histogram AUC;
    the profiler and the NaN check; Adam."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.data import minibatches, synthetic
    from deepctr_torch.utils.checkpoint import save_fm_embeddings

    steps = RETRAIN_SHARD_ROWS * RETRAIN_SHARDS // BATCH
    t0 = time.perf_counter()
    ds = synthetic.generate(schema, num_examples=RETRAIN_SHARDS * RETRAIN_SHARD_ROWS
                            + RETRAIN_TEST_ROWS, k=K, seed=3)
    data = os.path.join(tmp, "retrain")
    os.makedirs(data)
    shards = []
    for i in range(RETRAIN_SHARDS + 1):
        sl = slice(i * RETRAIN_SHARD_ROWS, (i + 1) * RETRAIN_SHARD_ROWS)
        path = os.path.join(data, f"shard_{i}.yx" if i < RETRAIN_SHARDS else "test.yx")
        synthetic.write_yx_file(synthetic.SyntheticDataset(
            schema, ds.ids[sl], ds.labels[sl], ds.bayes_logits[sl]), path)
        shards.append(path)
    test_path = shards.pop()
    all_path = os.path.join(data, "all.yx")
    with open(all_path, "wb") as out:
        for path in shards:
            with open(path, "rb") as f:
                shutil.copyfileobj(f, out)
    print(f"retrain: {RETRAIN_SHARDS} yx shards of {RETRAIN_SHARD_ROWS} rows ({steps} "
          f"steps of {BATCH} an epoch), a test file of {RETRAIN_TEST_ROWS} rows and "
          f"the shards joined into one file, made in {time.perf_counter() - t0:.1f} s")

    base = ["model.init_from=none", f"data.schema_path={schema_path}",
            f"train.batch_size={BATCH}", "train.table_dtype=bf16",
            f"data.test_path={test_path}", "train.early_stop_patience=99",
            "train.checkpoint_every=1"]
    stream = base + ["data.stream=true", f"data.train_path={data}/shard_*.yx",
                     "train.prefetch=true"]

    # run A, uninterrupted; run B, one epoch, then B' resumed to two
    a_ckpt, b_ckpt = os.path.join(tmp, "retrain_a.ckpt"), os.path.join(tmp, "retrain_b.ckpt")
    b_metrics = os.path.join(tmp, "retrain_b.jsonl")
    res_a, launches, _ = _retrain_run(
        dev, root, stream + ["train.epochs=2", f"train.checkpoint_path={a_ckpt}"],
        "retrain run A (streamed, prefetched, 2 epochs)")
    if res_a["state"].step != 2 * steps:
        raise AssertionError(f"retrain: run A took {res_a['state'].step} steps")
    evals = 2 * -(-RETRAIN_TEST_ROWS // BATCH)
    trained = 2 * steps + launches["captures"]   # and a warm-up step a capture
    if (launches["fwd_dropout"] != trained or launches["bwd"] != trained
            or launches["fwd_eval"] != evals):
        raise AssertionError(f"retrain: run A launched {launches}; expected "
                             f"{trained} forward-with-dropout and backward, "
                             f"{evals} eval forward")
    print(f"retrain: run A launched the forward with dropout and the backward once "
          f"a step and once a graph capture's warm-up step ({trained}), the eval "
          f"forward once an eval batch ({evals})")
    _retrain_run(dev, root, stream + ["train.epochs=1", f"train.checkpoint_path={b_ckpt}",
                                      f"train.metrics_path={b_metrics}"],
                 "retrain run B (1 epoch)")
    _retrain_run(dev, root, stream + ["train.epochs=2", f"train.checkpoint_path={b_ckpt}",
                                      f"train.metrics_path={b_metrics}",
                                      "train.resume=true"],
                 "retrain run B' (resumed to 2 epochs)")
    with open(b_metrics) as f:
        resumed = [e for e in map(json.loads, f) if e.get("event") == "resumed"]
    if [(e["step"], e["epoch"]) for e in resumed] != [(steps, 1)]:
        raise AssertionError(f"retrain: resumed events {resumed}")
    (ma, la), (mb, lb) = _ckpt_leaves(a_ckpt), _ckpt_leaves(b_ckpt)
    same = (ma["epoch"] == mb["epoch"] == 2 and len(la) == len(lb)
            and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb)))
    print(f"retrain: resumed event at step {steps}, epoch 1; run B' final checkpoint "
          f"vs run A's, {len(la)} leaves (step, bf16 table, accumulator, tower, "
          f"dense accumulators, generator), epoch 2: bit-identical: {same}")
    if not same:
        raise AssertionError("retrain: the resumed run's bits differ from run A's")

    # prefetch on and off, in RAM, in turns
    in_ram = base + ["data.stream=false", f"data.train_path={all_path}", "train.epochs=1"]
    states, rates = {}, {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        res, _, _ = _retrain_run(dev, root, in_ram + [
            f"train.prefetch={'true' if which == 'on' else 'false'}"],
            f"retrain in RAM, prefetch {which}")
        rates[which].append(res["history"][0]["examples_per_s"])
        states.setdefault(which, res["state"])
        del res
    same = _same_state(states["on"], states["off"])
    print(f"retrain: in RAM, prefetch on vs off after {steps} steps: table, "
          f"accumulators, tower and generator bit-identical: {same}")
    if not same:
        raise AssertionError("retrain: prefetch on and off give other bits")
    del states
    epoch_rates = {"in RAM, no prefetch": rates["off"], "in RAM, prefetch": rates["on"],
                   "streamed, prefetch": [res_a["history"][1]["examples_per_s"]]}
    print("retrain: CLI epoch examples/s (host clock, the epoch's steps): " + "; ".join(
        f"{k} {', '.join(f'{r:.0f}' for r in v)}" for k, v in epoch_rates.items()))

    cfg = cli.RunConfig.load(os.path.join(root, FNN_CONFIG)).apply_overrides(in_ram)
    _, tr_ids, tr_labels, te_ids, te_labels = cli.load_data(cfg)
    feeds = _profile_feeds(dev, root, schema, in_ram, tr_ids, tr_labels)

    # the NaN run in its own process, started now and read at the end
    first = next(minibatches(tr_ids, tr_labels, BATCH, schema=schema, shuffle=True,
                             seed=cfg.train.seed, drop_remainder=True))
    row = int(first.ids[0, 0])
    table = np.random.default_rng(SEED + 13).normal(
        0.0, 0.01, (schema.padded_vocab_size, 1 + K)).astype(np.float32)
    table[schema.pad_id] = 0.0
    table[row, 1] = np.nan
    nan_table = os.path.join(tmp, "nan.fm_table")
    save_fm_embeddings(nan_table, table)
    nan_argv = [sys.executable, "-m", "deepctr_torch.cli", "--config", FNN_CONFIG,
                f"model.init_from={nan_table}", *base[1:], "data.stream=false",
                f"data.train_path={all_path}", "train.epochs=1",
                "train.debug_nans=true", "--device", "cuda"]
    nan_proc = subprocess.Popen(nan_argv, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _check_histogram_auc(dev, res_a["state"], schema, te_ids, te_labels)
        del res_a

        prof_dir = os.path.join(tmp, "retrain_prof")
        _, _, result, _, _ = _cli_train(
            dev, root, tmp, FNN_CONFIG,
            ["model.init_from=none", f"data.schema_path={schema_path}",
             f"train.profile_dir={prof_dir}"],
            RETRAIN_SHORT_STEPS, "retrain profiled")
        written = sorted(os.listdir(prof_dir))
        traces = [f for f in written if f.startswith("trace_")]
        with open(os.path.join(prof_dir, traces[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        kernels = sorted({m.group(1) for n in names
                          for m in [re.search(r"(tower_\w+?_kernel)", n)] if m})
        print(f"retrain: train.profile_dir wrote {written} ({len(names)} event names) "
              f"over {result['state'].step} steps on the graph route, naming {kernels}")
        if len(traces) != 1 or not {"tower_fwd_kernel", "tower_bwd_rows_kernel"} <= set(kernels):
            raise AssertionError("retrain: the trace does not name the tower kernels")
        with open(os.path.join(prof_dir, written[0])) as f:
            graphs = json.load(f)["phases"]
        print(f"retrain: {written[0]}: the graphs' device ms a step by phase {graphs}")
        if len(written) != 2 or not graphs or set(graphs[0]["ms_a_step"]) != {
                "lookup", "tower", "sparse", "dense"}:
            raise AssertionError("retrain: the spans file holds no graph's phases")
        _, _, result, _, _ = _cli_train(
            dev, root, tmp, FNN_CONFIG,
            ["model.init_from=none", f"data.schema_path={schema_path}",
             "train.debug_nans=true"], RETRAIN_SHORT_STEPS, "retrain debug_nans")
        print(f"retrain: train.debug_nans ran {result['state'].step} steps (eager, "
              f"a chunk at a time) and found every loss finite")
        _, _, result, _, _ = _cli_train(
            dev, root, tmp, FNN_CONFIG,
            ["model.init_from=none", f"data.schema_path={schema_path}",
             "optim.dense=adam"], RETRAIN_SHORT_STEPS, "retrain adam")
        print(f"retrain: optim.dense=adam, count {int(result['state'].dense_state.count)}, "
              f"train loss {result['history'][0]['train_loss']:.5f}")
        out, err = nan_proc.communicate(timeout=300)
    finally:
        if nan_proc.poll() is None:
            nan_proc.kill()
            nan_proc.wait()
    tail = err.strip().splitlines()[-1] if err.strip() else ""
    print(f"retrain: a NaN in table row {row}, which the first batch uses, with "
          f"train.debug_nans=true: exit {nan_proc.returncode}, '{tail}'")
    if nan_proc.returncode == 0 or "FloatingPointError: train step 1:" not in tail:
        raise AssertionError(f"retrain: the NaN run was not refused at step 1: {err[-2000:]}")
    return {"epoch_rates": epoch_rates, "feeds": feeds, "a_ckpt": a_ckpt,
            "stream": stream, "steps": steps}


def _phase14_quantized_scoring(dev, root, schema, fnn) -> dict:
    """Phase 9's trained FNN checkpoint served by the f32, bf16 and int8
    ``Scorer``s: AUC against f32's, the int8 logits against a plain
    quantise, dequantise and f32 path on the card (its own int8 rows from
    the f32 scorer's table, by the reference's rule), the tables' bytes,
    and host and device ms a batch."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.ops.kernels import mlp as mlp_k
    from deepctr_torch.serving import Scorer
    from deepctr_torch.utils.metrics import exact_auc

    cfg = fnn["cfg"]
    _, tr_ids, tr_labels, te_ids, te_labels = cli.load_data(cfg)
    ids = np.concatenate([tr_ids, te_ids])[-REQUESTS:]
    labels = np.concatenate([tr_labels, te_labels])[-REQUESTS:]
    print(f"quantised scoring: {fnn['ckpt']} (phase 9's FNN), {REQUESTS} rows: the "
          f"run's {len(te_ids)} held-out rows and the last "
          f"{REQUESTS - len(te_ids)} of its training rows")
    n_batches = REQUESTS // BATCH
    ids_dev = torch.from_numpy(ids[:BATCH]).to(dev).long()
    mask_dev = (ids_dev != schema.pad_id).float()
    out, auc = {}, {}
    for q in (None, "bf16", "int8"):
        tag = q or "f32"
        scorer = Scorer.from_checkpoint(fnn["ckpt"], cli.build_model(cfg, schema, dev),
                                        batch_size=BATCH, quantize=q)
        v, d = schema.padded_vocab_size, 1 + cfg.model.k
        want_bytes = {"f32": v * d * 4, "bf16": v * d * 2, "int8": v * (d + 4)}[tag]
        if scorer.table_bytes != want_bytes or (q and scorer.model.table.numel()):
            raise AssertionError(f"{tag} scorer: table {scorer.table_bytes} B (expected "
                                 f"{want_bytes}), model table {scorer.model.table.shape}")
        _reset_counts()
        logits = scorer.logits(ids)
        launches = _counts()["fwd_eval"]
        if launches != n_batches:
            raise AssertionError(f"{tag} scorer: {launches} tower launches for "
                                 f"{n_batches} batches")
        auc[tag] = exact_auc(labels, 1.0 / (1.0 + np.exp(-np.clip(logits, -30, 30))))
        if q is None:
            table32 = scorer.model.table.detach().clone()
        if q == "int8":
            # the reference's rule, written here apart from the scorer's:
            # scale = max(|row|, 1e-12) / 127, q = clip(round(x / scale), ±127)
            scale = torch.clamp(table32.abs().amax(dim=1), min=1e-12) / 127.0
            q8 = torch.clamp(torch.round(table32 / scale[:, None]), -127, 127)
            del table32
            model = scorer.model
            with torch.inference_mode():
                plain = np.concatenate([mlp_k.mlp_tower_plain(
                    model.tower_input(q8[b] * scale[b][..., None],
                                      (b != schema.pad_id).float()),
                    model.mlp.params(), model.mlp.spec.activation).cpu().numpy()
                    for b in (torch.from_numpy(ids[i:i + BATCH]).to(dev).long()
                              for i in range(0, REQUESTS, BATCH))])
            del q8
            _check_close("int8 scorer: kernel logits vs plain quantise, dequantise "
                         "and f32 path on the card", logits, plain, atol=1e-5)
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            scorer.logits(ids)
            host.append((time.perf_counter() - t0) * 1e3 / n_batches)
        with torch.inference_mode():
            device_ms = _time_ms(lambda: scorer.model.apply_rows(scorer.rows(ids_dev),
                                                                 mask_dev))
        out[tag] = {"auc": auc[tag], "table_bytes": scorer.table_bytes,
                    "host_ms": host, "device_ms": device_ms}
        print(f"{tag} scorer: AUC {auc[tag]:.6f}, table {scorer.table_bytes} B, "
              f"{launches} tower launches; host {', '.join(f'{h:.3f}' for h in host)} "
              f"ms a batch (batching, H2D, forward, D2H); device {device_ms:.4f} ms a "
              f"batch (gather or dequantise, pool, tower; CUDA events)")
        del scorer
    for tag in ("bf16", "int8"):
        if abs(auc[tag] - auc["f32"]) > AUC_BAND:
            raise AssertionError(f"{tag} scorer: AUC {auc[tag]} vs f32 {auc['f32']}")
        print(f"{tag} scorer: |AUC - f32 AUC| {abs(auc[tag] - auc['f32']):.2e} "
              f"(at most {AUC_BAND})")
    return out


def _sharded_world_one(dev, root, schema, schema_path, tag, config, extra) -> None:
    """From one state, 3 steps of the sharded step in a world of one (NCCL)
    against 3 unsharded steps, bit for bit; the world-1 eval logits against
    the unsharded eval's; and 3 steps with the bf16 wire against the f32
    wire, within the reference's band."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch import parallel as par
    from deepctr_torch.config import RunConfig
    from deepctr_torch.data import synthetic
    from deepctr_torch.train import init_state, make_eval_step, make_train_step

    cfg = RunConfig.load(os.path.join(root, config)).apply_overrides(
        [f"data.schema_path={schema_path}", *extra])
    ds = synthetic.generate(schema, num_examples=4 * BATCH, k=K, seed=SEED + 11)
    batches = [(torch.from_numpy(ds.ids[i * BATCH:(i + 1) * BATCH]).to(dev).long(),
                torch.from_numpy(ds.labels[i * BATCH:(i + 1) * BATCH]).to(dev),
                torch.ones(BATCH, device=dev)) for i in range(4)]
    sopt, dopt = cli.build_optimizers(cfg)
    base = init_state(cli.build_model(cfg, schema, dev), schema, sopt, dopt, seed=SEED,
                      table_dtype="bf16")
    single = base.clone()
    step1 = make_train_step(schema, sopt, dopt, l2=cfg.optim.l2)
    losses1 = [step1(single, *batches[i])[1].loss for i in range(3)]
    with par.process_group(dev) as group:
        tables = {}
        for wire in ("f32", "bf16"):
            sst = par.sharded_state_from_state(base.clone(), group)
            step_n = par.make_sharded_train_step(
                schema, sopt, dopt, group, l2=cfg.optim.l2,
                capacity_factor=cfg.train.capacity_factor, exchange_dtype=wire)
            losses, drops = zip(*(step_n(sst, *batches[i])[1] for i in range(3)))
            host = par.host_state_from_sharded(sst, group)
            tables[wire] = host.table
            if sum(int(d) for d in drops):
                raise AssertionError(f"{tag} world 1, {wire} wire: dropped {drops}")
            if wire == "bf16":
                continue
            same = {
                "loss": all(torch.equal(a, b) for a, b in zip(losses, losses1)),
                "table": torch.equal(host.table, single.table),
                "accumulator": torch.equal(host.sparse_state.acc,
                                           single.sparse_state.acc),
                "dense": all(torch.equal(p, q) for p, q in
                             zip(host.model.parameters(), single.model.parameters())),
                "step": host.step == single.step == 3,
            }
            print(f"{tag} world 1 (NCCL), 3 sharded steps vs 3 unsharded steps from one "
                  f"state, bit for bit: {same}")
            if not all(same.values()):
                raise AssertionError(f"{tag}: the world-1 sharded step is not the "
                                     f"unsharded step")
            eval_n = par.make_sharded_eval_step(schema, group)(sst.model, batches[3][0])
            eval_1 = make_eval_step(schema)(single.model, batches[3][0])
            print(f"{tag} world 1: eval logits equal the unsharded eval's bit for bit: "
                  f"{torch.equal(eval_n, eval_1)}")
            if not torch.equal(eval_n, eval_1):
                raise AssertionError(f"{tag}: world-1 eval differs")
    f32, b16 = tables["f32"].float(), tables["bf16"].float()
    err = (b16 - f32).abs()
    outside = int((err > WIRE_ATOL + WIRE_RTOL * f32.abs()).sum())
    changed = int((f32 != base.table.float()).sum())
    print(f"{tag} world 1: 3 steps, bf16 wire vs f32 wire: table max |d| "
          f"{float(err.max()):.3e}, {int((err > 0).sum())} elements differ, {outside} "
          f"beyond rtol {WIRE_RTOL:g} atol {WIRE_ATOL:g} (allowed: {WIRE_SHARE:g} of "
          f"the {changed} elements the steps changed)")
    if outside > WIRE_SHARE * changed or torch.equal(b16, f32):
        raise AssertionError(f"{tag}: the bf16 wire's table is off the f32 wire's")


def _exchange_pieces(schema, cfg, state, ids) -> dict:
    """Device ms of the sharded step's own pieces at a step's shape (CUDA
    events behind a sleep kernel): the owner bucketing, the lookup exchange
    (ids and rows all-to-all, the shard's gather, the unsort), the gradient
    exchange, and the sorted-mode scatter (``ops/scatter.py::
    dedupe_grads``) that the sparse optimizer runs on the received ids."""
    import torch

    from deepctr_torch import parallel as par
    from deepctr_torch.ops.scatter import dedupe_grads
    from deepctr_torch.parallel import sharded

    flat = ids.reshape(-1)
    n = state.num_shards
    cap = par.exchange_capacity(flat.numel(), n, cfg.train.capacity_factor)
    sentinel = par.shard_rows(schema.padded_vocab_size, n)
    b = par.bucket_by_owner(flat, n, sentinel, cap)
    table = state.model.table.detach()
    _, recv = sharded.exchange_lookup(table, b, cap)
    g = torch.randn(flat.numel(), table.shape[1], device=table.device) * 1e-3
    g_recv = sharded.exchange_scatter_grads(g, b)
    pieces = {
        "bucketing": lambda: par.bucket_by_owner(flat, n, sentinel, cap),
        "lookup exchange": lambda: sharded.exchange_lookup(table, b, cap),
        "gradient exchange": lambda: sharded.exchange_scatter_grads(g, b),
        "sorted-mode scatter": lambda: dedupe_grads(recv, g_recv),
    }
    out = {name: _time_ms(fn, iters=20) for name, fn in pieces.items()}
    print(f"criteo sharded step's pieces on the card ({flat.numel()} occurrences "
          f"of {table.shape[1]} floats, capacity {cap}, CUDA events): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in out.items()))
    return out


def _phase15_sharded(dev, root, tmp, schema, schema_path, fnn, fm_table) -> dict:
    """Row-sharded training in a world of one (one card; NCCL refuses two
    ranks on one GPU): the exchange path with no peer. (a, b) FNN and FM
    steps against unsharded steps; (c) FNN through the CLI with
    ``train.sharded=true``, bit-identical to phase 9's unsharded run; (d)
    ``configs/criteo_sharded_stretch.json`` at full width."""
    import copy
    import types

    import torch

    from deepctr_torch import cli
    from deepctr_torch import parallel as par
    from deepctr_torch.data import Schema

    print("sharded: a world of one NCCL rank on cuda:0 (one card; NCCL refuses two "
          "ranks on one GPU, so the multi-rank checks run on the CPU with gloo)")
    _sharded_world_one(dev, root, schema, schema_path, "fnn", FNN_CONFIG,
                       ["model.init_from=none", "optim.sparse_mode=dense"])
    _sharded_world_one(dev, root, schema, schema_path, "fm", FM_CONFIG,
                       ["optim.sparse_mode=dense"])

    # (c) the FNN run of phase 9 again, sharded
    ckpt = os.path.join(tmp, "fnn_sharded.ckpt")
    overrides = [*fnn["overrides"][:2], f"train.checkpoint_path={ckpt}",
                 "train.sharded=true"]
    _, overrides, result, launches, _ = _cli_train(
        dev, root, tmp, FNN_CONFIG, overrides, TRAIN_STEPS, "fnn-sharded")
    rec, state = result["history"][0], result["state"]
    want = _graph_launches(launches, TRAIN_STEPS)
    # the owner's update in dense mode: one a step, as the backward
    if (launches["fwd_dropout"], launches["bwd"], launches["adagrad_dense"]) != (
            want, want, want):
        raise AssertionError(f"fnn sharded: launches {launches} in {TRAIN_STEPS} steps")
    if rec["dropped_ids"] or rec["auc"] <= 0.5:
        raise AssertionError(f"fnn sharded: {rec}")
    (_, got), (_, want) = _ckpt_leaves(ckpt), _ckpt_leaves(fnn["ckpt"])
    same = [np.array_equal(a, b) for a, b in zip(got, want, strict=True)]
    print(f"fnn sharded: checkpoint leaves equal phase 9's unsharded run's: {same}")
    if not all(same):
        raise AssertionError("fnn sharded: the world-1 run is not the unsharded run")
    host = copy.deepcopy(state.model)
    host.table.data = par.unpack_table(state.model.table.data, state.vocab_padded, 1)
    _, _, _, te_ids, te_labels = cli.load_data(fnn["cfg"])
    _check_cli_score(os.path.join(root, FNN_CONFIG), overrides,
                     types.SimpleNamespace(model=host), schema, te_ids, te_labels,
                     tmp, "fnn-sharded")
    del host, state, result

    # (d) the Criteo config at full width
    torch.cuda.reset_peak_memory_stats()
    cfg, _, result, c_launches, _ = _cli_train(dev, root, tmp, CRITEO_CONFIG, [],
                                               TRAIN_STEPS, "criteo-sharded",
                                               table_dtype="f32")
    rec, state = result["history"][0], result["state"]
    peak = torch.cuda.max_memory_allocated()
    shard = state.model.table
    print(f"criteo sharded: table shard {tuple(shard.shape)} {shard.dtype} "
          f"({shard.numel() * shard.element_size() / 1e9:.3f} GB, and as much again "
          f"for the Adagrad accumulator), vocabulary {state.vocab_padded} rows; peak "
          f"device memory {peak / 2**30:.2f} GiB")
    want = _graph_launches(c_launches, TRAIN_STEPS)
    # the sorted mode (the config's sparse_mode) launches no dense update
    if (c_launches["fwd_dropout"], c_launches["bwd"], c_launches["adagrad_dense"]) != (
            want, want, 0):
        raise AssertionError(f"criteo sharded: launches {c_launches}")
    if rec["dropped_ids"] or rec["auc"] <= 0.5:
        raise AssertionError(f"criteo sharded: {rec}")
    schema_c, tr_ids, tr_labels, _, _ = cli.load_data(cfg)
    assert isinstance(schema_c, Schema)
    sopt, dopt = cli.build_optimizers(cfg)
    batches = [(torch.from_numpy(tr_ids[i * BATCH:(i + 1) * BATCH]).to(dev).long(),
                torch.from_numpy(tr_labels[i * BATCH:(i + 1) * BATCH]).to(dev),
                torch.ones(BATCH, device=dev))
               for i in range(min(10, len(tr_ids) // BATCH))]
    with par.process_group(dev) as group:
        step = par.make_sharded_train_step(schema_c, sopt, dopt, group,
                                           capacity_factor=cfg.train.capacity_factor)
        for i in range(2):
            step(state, *batches[i])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches:
            step(state, *b)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / len(batches)
        print(f"criteo sharded train step on the card ({BATCH} rows, 39 slots, CUDA "
              f"events over {len(batches)} steps): {step_ms:.4f} ms; CLI epoch "
              f"{rec['examples_per_s']:.0f} examples/s (host clock)")
        prof = _profile_loop(lambda i: step(state, *batches[i]), min(5, len(batches)),
                             "criteo sharded train step")
        pieces = _exchange_pieces(schema_c, cfg, state, batches[0][0])
    return {"launches": launches, "criteo_launches": c_launches, "step_ms": step_ms,
            "examples_per_s": rec["examples_per_s"], "peak_bytes": peak,
            "auc": rec["auc"], "pieces": pieces, "criteo": (cfg, schema_c, state),
            **prof}


class _PeakRss:
    """The process's largest resident set while the block runs, sampled
    from ``/proc/self/statm`` every 5 ms on a thread."""

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def rss():
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * page

        self.start = self.peak = rss()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _host_shard_trip(dev, state, like, dirpath, tag) -> dict:
    """``save_host_shards`` of ``state`` and ``load_host_shards`` into
    ``like`` (a freshly packed state) in a world of one, timed on the host
    clock with the card synchronised, and the two compared leaf for leaf,
    bit for bit (step, table, sparse state, tower, dense state, generator).
    Returns the bytes, seconds, GB/s and peak host RSS each way."""
    import torch

    from deepctr_torch import parallel as par

    group = par.Group(rank=0, world=1, device=dev)
    torch.cuda.synchronize()
    with _PeakRss() as rss_save:
        t0 = time.perf_counter()
        path = par.save_host_shards(dirpath, state, group, epoch=7)
        save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    with _PeakRss() as rss_load:
        t0 = time.perf_counter()
        like, epoch = par.load_host_shards(dirpath, like, group)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    same = epoch == 7 and _same_state(state, like)
    out = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
           "save_gb_s": nbytes / save_s / 1e9, "load_gb_s": nbytes / load_s / 1e9,
           "rss_save": rss_save.peak, "rss_load": rss_load.peak}
    gib = [x / 2**30 for x in (rss_save.peak, rss_save.peak - rss_save.start,
                               rss_load.peak, rss_load.peak - rss_load.start)]
    print(f"{tag}: {os.path.basename(path)} {nbytes} bytes; save {save_s:.3f} s "
          f"({out['save_gb_s']:.3f} GB/s), load into a fresh packed state "
          f"{load_s:.3f} s ({out['load_gb_s']:.3f} GB/s), host clock with the card "
          f"synchronised; peak host RSS {gib[0]:.2f} GiB saving ({gib[1]:.2f} above "
          f"its start), {gib[2]:.2f} GiB loading ({gib[3]:.2f} above); every leaf "
          f"equal bit for bit: {same}")
    if not same:
        raise AssertionError(f"{tag}: the loaded state differs from the saved one")
    return out


def _phase16_distributed(dev, root, tmp, retrain, criteo) -> dict:
    """``train.distributed=true`` in a world of one NCCL rank: (a) phase 13's
    streamed FNN job with rank-local streaming and per-rank shard
    checkpoints, 2 epochs straight (A) and 1 then a host-shard resume to 2
    (B, B'), against phase 13's run A; (b) phase 15 (d)'s Criteo state
    through ``save_host_shards`` and ``load_host_shards``."""
    import resource

    import torch

    from deepctr_torch import cli
    from deepctr_torch import parallel as par

    t_phase = time.perf_counter()
    steps = retrain["steps"]
    base = retrain["stream"] + ["train.sharded=true", "train.distributed=true"]
    print("distributed: train.sharded=true train.distributed=true in a world of one "
          "NCCL rank on cuda:0 (NCCL refuses two ranks on one GPU; the multi-rank "
          "gates run on the CPU with gloo in the tests)")

    # (a) run A, 2 epochs; run B, 1 epoch; B' resumes from B's host shards to 2
    a_ckpt, b_ckpt = (os.path.join(tmp, f"dist_{x}.ckpt") for x in "ab")
    a_metrics, b_metrics = (os.path.join(tmp, f"dist_{x}.jsonl") for x in "ab")
    res_a, launches, _ = _retrain_run(
        dev, root, base + ["train.epochs=2", f"train.checkpoint_path={a_ckpt}",
                           f"train.metrics_path={a_metrics}"],
        "distributed run A (rank-local stream, prefetched, 2 epochs)")
    _retrain_run(dev, root, base + ["train.epochs=1", f"train.checkpoint_path={b_ckpt}",
                                    f"train.metrics_path={b_metrics}"],
                 "distributed run B (1 epoch)")
    _retrain_run(dev, root, base + ["train.epochs=2", f"train.checkpoint_path={b_ckpt}",
                                    f"train.metrics_path={b_metrics}"],
                 "distributed run B' (resumed from B's host shards to 2 epochs)")
    with open(a_metrics) as f:
        a_events = [json.loads(line) for line in f]
    with open(b_metrics) as f:
        b_events = [json.loads(line) for line in f]
    agreed = [(e["epoch"], e["steps"], e["rows_skipped"]) for e in a_events
              if e.get("event") == "epoch_steps"]
    resumed = [(e["step"], e["epoch"]) for e in b_events
               if e.get("event") == "resumed_hostshards"]
    print(f"distributed: run A's epochs (epoch, steps, rows_skipped) {agreed}; run "
          f"B''s resumed_hostshards (step, epoch) {resumed}")
    if agreed != [(0, steps, 0), (1, steps, 0)]:
        raise AssertionError(f"distributed: agreed steps {agreed}, expected {steps} "
                             f"an epoch and no row skipped")
    if resumed != [(steps, 1)]:
        raise AssertionError(f"distributed: resumed events {resumed}")
    evals = 2 * -(-RETRAIN_TEST_ROWS // BATCH)
    want = _graph_launches(launches, 2 * steps)
    if (launches["fwd_dropout"], launches["bwd"], launches["fwd_eval"]) != (
            want, want, evals):
        raise AssertionError(f"distributed: run A launched {launches}; expected "
                             f"{want} / {want} / {evals}")
    print(f"distributed: run A launched the forward with dropout and the backward "
          f"once a step and once a capture's warm-up step ({want} / {want}: "
          f"{launches['captures']} capture(s), the sharded scan route), the eval "
          f"forward once an eval batch ({evals})")
    portable = [p for c in (a_ckpt, b_ckpt) for p in (c, c + ".fm_table")
                if os.path.exists(p)]
    if portable:
        raise AssertionError(f"distributed: portable files written: {portable}")
    with np.load(os.path.join(a_ckpt + ".hostshards", "proc0.npz")) as za, \
            np.load(os.path.join(b_ckpt + ".hostshards", "proc0.npz")) as zb:
        a_file = {k: za[k] for k in za.files}
        b_file = {k: zb[k] for k in zb.files}
    same_b = sorted(a_file) == sorted(b_file) and all(
        a_file[k].dtype == b_file[k].dtype and np.array_equal(a_file[k], b_file[k])
        for k in a_file)
    print(f"distributed: run B''s proc0.npz vs run A's, {len(a_file)} entries "
          f"({int(a_file['__nleaves'])} leaves), bit for bit: {same_b}")
    if not same_b:
        raise AssertionError("distributed: the resumed run's shard file differs")
    # against phase 13's run A: the same stream, seeds and dropout seeds, and
    # a world-1 step is the unsharded step (phase 15 (a))
    manifest, leaves = _ckpt_leaves(retrain["a_ckpt"])
    n = int(a_file["__nleaves"])
    mine = [a_file[f"s{i}__0_0"][:-1] if f"s{i}__0_0" in a_file else a_file[f"r{i}"]
            for i in range(n)]     # the shards without their sentinel row
    equal = [x.dtype == y.dtype and np.array_equal(x, y)
             for x, y in zip(mine, leaves, strict=True)]
    print(f"distributed: run A's shard file vs phase 13's run A checkpoint, leaf for "
          f"leaf (step, bf16 table bits and accumulator without the sentinel row, "
          f"tower, dense accumulators, generator): {equal}")
    if not all(equal) or list(a_file["__bf16_leaves"]) != [1]:
        raise AssertionError("distributed: run A is not phase 13's run A")
    rates = [round(r["examples_per_s"]) for r in res_a["history"]]
    a_bytes = os.path.getsize(os.path.join(a_ckpt + ".hostshards", "proc0.npz"))
    print(f"distributed: run A's CLI epochs {rates} examples/s (host clock); its "
          f"shard file {a_bytes} bytes")

    # the row count alone, on the 4 shards, and the FNN state's round trip
    cfg = cli.RunConfig.load(os.path.join(root, FNN_CONFIG)).apply_overrides(base)
    group1 = par.Group(rank=0, world=1, device=dev)
    schema_f, source, *_ = cli.load_data(cfg, group1)
    t0 = time.perf_counter()
    rows = par.count_shard_rows(source, group1)
    count_s = time.perf_counter() - t0
    total = sum(rows.values())
    print(f"distributed: row count of the {len(rows)} shards ({total} rows, "
          f"{sum(os.path.getsize(p) for p in rows) / 1e6:.1f} MB) in {count_s:.4f} s: "
          f"{total / count_s:.0f} rows/s (host clock)")
    if total != RETRAIN_SHARDS * RETRAIN_SHARD_ROWS:
        raise AssertionError(f"distributed: counted {total} rows")
    sopt, dopt = cli.build_optimizers(cfg)
    fresh = par.init_sharded_state(cli.build_model(cfg, schema_f, dev), schema_f, sopt,
                                   dopt, group1, seed=SEED + 16, table_dtype="bf16")
    fnn_trip = _host_shard_trip(dev, res_a["state"], fresh,
                                os.path.join(tmp, "dist_fnn.hostshards"),
                                "distributed fnn host shards")
    del res_a, fresh

    # (b) Criteo at full width: phase 15 (d)'s final sharded state
    c_cfg, c_schema, c_state = criteo
    free = shutil.disk_usage(tmp).free
    held = sum(t.numel() * t.element_size()
               for t in (c_state.model.table, *c_state.sparse_state))
    print(f"distributed criteo: {tmp} has {free} bytes free; the state holds "
          f"{held} bytes of table and accumulator shards")
    c_sopt, c_dopt = cli.build_optimizers(c_cfg)
    c_fresh = par.init_sharded_state(cli.build_model(c_cfg, c_schema, dev), c_schema,
                                     c_sopt, c_dopt, group1, seed=SEED + 16,
                                     table_dtype="f32")
    c_dir = os.path.join(tmp, "dist_criteo.hostshards")
    criteo_trip = _host_shard_trip(dev, c_state, c_fresh, c_dir,
                                   "distributed criteo host shards")
    shutil.rmtree(c_dir)
    del c_fresh, c_state
    print(f"distributed: process peak host RSS so far "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB "
          f"(ru_maxrss); phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "examples_per_s": rates, "fnn": fnn_trip,
            "criteo": criteo_trip, "count_rows_per_s": total / count_s}


def _restore_state(dst, src) -> None:
    """``src``'s bits into ``dst``'s tensors, in place (the addresses a
    captured graph holds stay valid), with its generator and step."""
    import torch

    from deepctr_torch.train.step import _state_tensors

    with torch.no_grad():
        for a, b in zip(_state_tensors(dst), _state_tensors(src), strict=True):
            a.copy_(b)
    dst.generator.set_state(src.generator.get_state())
    dst.step = src.step


def _scan_case(dev, root, schema, schema_path, config, overrides):
    """(state, scan step, eager step, table dtype) of one config, initialised
    from a seed: the states a chunk's graph and eager steps start from."""
    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig
    from deepctr_torch.train import init_state, make_scan_train_step, make_train_step

    cfg = RunConfig.load(os.path.join(root, config)).apply_overrides(
        [f"data.schema_path={schema_path}", *overrides])
    sopt, dopt = cli.build_optimizers(cfg)
    state = init_state(cli.build_model(cfg, schema, dev), schema, sopt, dopt,
                       seed=SEED + 17, table_dtype=cfg.train.table_dtype)
    return (state, make_scan_train_step(schema, sopt, dopt, l2=cfg.optim.l2),
            make_train_step(schema, sopt, dopt, l2=cfg.optim.l2))


def _graph_vs_eager(tag, state, scan, step, chunk) -> None:
    """From one state: one replay of the chunk's graph (captured on this
    call) against the chunk's steps run eagerly on a clone, bit for bit:
    the losses, the table, both optimizers' states, the tower, ``step``
    and the generator. Then the graph state is put back in place and the
    same graph replayed again: the same bits (no capture this time)."""
    import torch

    from deepctr_torch.ops.kernels import tower_launches

    g, e = state.clone(), state.clone()
    _reset_counts()
    t0 = time.perf_counter()
    g, g_losses = scan(g, *chunk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _counts()
    graph = scan.graph[0]
    e_losses = torch.stack([step(e, *(t[i] for t in chunk))[1].loss
                            for i in range(chunk[0].shape[0])])
    same = torch.equal(g_losses, e_losses) and _same_state(g, e)
    print(f"scan {tag}: one replay of a {chunk[0].shape[0]}-step graph vs as many eager "
          f"steps from one state: losses, table, optimizer states, tower, step "
          f"({g.step}) and generator bit-identical: {same}; capture {graph.capture_s:.2f} s "
          f"(one warm-up step on the state, which keeps "
          f"{graph.snapshot_bytes / 2**20:.2f} MiB of it and puts it back, then the "
          f"capture), first call "
          f"{first_s:.2f} s; launches of that call {launches} (the warm-up step's and "
          f"the replay's), per replay {tower_launches(graph.launches)}")
    if not same:
        raise AssertionError(f"scan {tag}: the graph replay differs from eager steps")
    _restore_state(g, state)
    g, again = scan(g, *chunk)
    same = (scan.graph[0] is graph and torch.equal(again, e_losses)
            and _same_state(g, e))
    print(f"scan {tag}: the state put back in place and the same graph replayed "
          f"again: bit-identical: {same}")
    if not same:
        raise AssertionError(f"scan {tag}: a second replay differs")


def _time_routes(tag, state, scan, step, chunks) -> dict:
    """Eager steps and graph replays over the same chunks, in turns (eager,
    graph, graph, eager), each from a clone of the state: after one warm-up
    chunk (the graph's capture), SCAN_TIMED_CHUNKS chunks timed on the host
    clock to a synchronize (wall) and between CUDA events (the device's
    span, idle gaps included); the peak device memory of the turn, the
    graph's at most ``GRAPH_PEAK_GAP_GIB`` over the eager route's (the
    capture holds no copy of the state); then ``torch.profiler`` over warm
    chunks of each route for the busy share."""
    import torch

    steps = SCAN_TIMED_CHUNKS * SCAN_K

    def run(which, st, n):
        for c in range(n):
            chunk = chunks[c % len(chunks)]
            if which == "graph":
                scan(st, *chunk)
            else:
                for i in range(SCAN_K):
                    step(st, *(t[i] for t in chunk))

    out = {"eager": [], "graph": []}
    for which in ("eager", "graph", "graph", "eager"):
        st = state.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run(which, st, 1)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run(which, st, SCAN_TIMED_CHUNKS)
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        out[which].append({
            "wall_ms": wall, "span_ms": start.elapsed_time(end) / steps,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "capture_s": scan.graph[0].capture_s if which == "graph" else None,
            "snapshot_mib": (scan.graph[0].snapshot_bytes / 2**20 if which == "graph"
                             else None)})
        del st
    for which in ("eager", "graph"):
        st = state.clone()
        prof = _profile_loop(lambda i: run(which, st, 1), SCAN_TIMED_CHUNKS,
                             f"scan {tag}, {which}", per=f"chunk of {SCAN_K} steps")
        out[which + "_busy"] = prof["busy"]
        out[which + "_device_ms"] = prof["device_us"] / SCAN_K / 1e3
        out[which + "_named"] = sorted(prof["kernels"])
        out[which + "_nccl"] = sorted(prof["nccl"])
        out[which + "_ops"] = prof["ops_per_call"]
        del st
    res = {}
    for which in ("eager", "graph"):
        runs = out[which]
        res[which] = {key: float(np.mean([r[key] for r in runs]))
                      for key in ("wall_ms", "span_ms", "peak_gib")}
        res[which].update(busy=out[which + "_busy"], device_ms=out[which + "_device_ms"],
                          nccl=out[which + "_nccl"], ops=out[which + "_ops"])
    for key in ("capture_s", "snapshot_mib"):
        res["graph"][key] = float(np.mean([r[key] for r in out["graph"]]))
    gap = res["graph"]["peak_gib"] - res["eager"]["peak_gib"]
    print(f"scan {tag} timed ({SCAN_TIMED_CHUNKS} chunks of {SCAN_K} steps of {BATCH} "
          f"after one warm-up chunk, in turns): " + "; ".join(
              f"{w}: wall {res[w]['wall_ms']:.4f} ms a step (host clock), span "
              f"{res[w]['span_ms']:.4f} ms a step (CUDA events), device busy "
              f"{res[w]['device_ms']:.4f} ms a step and {100 * res[w]['busy']:.1f}% "
              f"of the wall (profiler), peak {res[w]['peak_gib']:.2f} GiB"
              for w in ("eager", "graph"))
          + f"; capture {res['graph']['capture_s']:.2f} s, its warm-up keeping "
            f"{res['graph']['snapshot_mib']:.2f} MiB of the state; graph peak - eager "
            f"peak {gap:.3f} GiB (gate {GRAPH_PEAK_GAP_GIB}); runs {out['eager']} "
            f"{out['graph']}; kernels the profiler names under replay: "
            f"{out['graph_named']}")
    if gap > GRAPH_PEAK_GAP_GIB:
        raise AssertionError(f"scan {tag}: the graph route's peak is {gap:.3f} GiB over "
                             f"the eager route's (gate {GRAPH_PEAK_GAP_GIB} GiB)")
    return res


def _old_sorted_update(opt, table, acc, ids, rows):
    """The sorted-mode Adagrad update before the static-shape form: the
    unique ids by a boolean mask (a nonzero, a host sync)."""
    from deepctr_torch.ops.scatter import dedupe_grads

    d = dedupe_grads(ids, rows.float())
    uids = d.ids[d.is_last]
    g = d.rows[d.is_last]
    acc[uids] += g * g
    delta = -opt.learning_rate * g / (acc[uids].sqrt() + opt.eps)
    table[uids] = (table[uids].float() + delta.to(table.dtype).float()).to(table.dtype)


def _time_sorted_update(dev, schema, snn_ids) -> dict:
    """The sorted-mode sparse Adagrad update, the static-shape form against
    the boolean-mask form it replaced, bit for bit after one update and
    timed in turns (CUDA events), at the Criteo stretch config's shape
    (26,000,833 x 17 f32, 8192 x 39 occurrences: a quarter of the ids from
    1,000 hot rows, the rest uniform, 5% the pad id) and SNN's fine-tune
    (927,658 x 200 f32, a synthetic batch's 8192 x 18 ids)."""
    import torch

    from deepctr_torch.optim.sparse import SparseAdagrad

    out = {}
    rng = np.random.default_rng(SEED + 19)
    for tag, rows, width, slots in (("criteo", 26_000_833, 17, 39),
                                    ("snn", schema.padded_vocab_size, 200, None)):
        opt = SparseAdagrad(0.05, mode="sorted")
        if slots is None:
            ids = snn_ids.reshape(-1).long()
        else:
            ids_np = rng.integers(0, rows - 1, BATCH * slots)
            hot = rng.random(ids_np.size) < 0.25
            ids_np[hot] = rng.integers(0, 1000, int(hot.sum()))
            ids_np[rng.random(ids_np.size) < 0.05] = rows - 1      # the pad id
            ids = torch.from_numpy(ids_np).to(dev)
        n = ids.numel()
        g = torch.randn(n, width, device=dev) * 1e-2
        g[ids == rows - 1] = 0.0
        table = torch.randn(rows, width, device=dev) * 1e-2
        tables = {"static": table, "mask": table.clone()}
        accs = {"static": opt.init(table), "mask": opt.init(table)}
        opt.update(tables["static"], accs["static"], ids, g)
        _old_sorted_update(opt, tables["mask"], accs["mask"].acc, ids, g)
        same = (torch.equal(tables["static"], tables["mask"])
                and torch.equal(accs["static"].acc, accs["mask"].acc))
        times = _in_turns({
            "mask": lambda: _old_sorted_update(opt, tables["mask"], accs["mask"].acc,
                                               ids, g),
            "static": lambda: opt.update(tables["static"], accs["static"], ids, g)},
            iters=20)
        print(f"sorted-mode Adagrad update, {tag} ({rows} x {width} f32, {n} "
              f"occurrences): static-shape form {times['static']:.4f} ms, boolean-mask "
              f"form {times['mask']:.4f} ms (CUDA events, in turns); one update "
              f"bit-identical: {same}")
        if not same:
            raise AssertionError(f"{tag}: the static-shape update differs from the "
                                 f"mask form")
        out[tag] = times
        del table, tables, accs, g
    return out


def _phase17_scan(dev, root, tmp, schema, schema_path) -> dict:
    """The scan route: K = 8 steps as one CUDA graph replayed once a chunk.
    (a) graph against eager, bit for bit, for FNN (bf16, dense mode,
    dropout 0.5), FNN with Adam, FM k=10, DeepFM and SNN's fine-tune (f32
    927,658 x 200, sorted mode), each replayed twice (c); (b) a chunk of 3
    real steps and 5 pad steps; (d) the two routes timed, and gated: the
    graph route's peak device memory at most ``GRAPH_PEAK_GAP_GIB`` over
    the eager route's for FNN, FM, DeepFM and SNN (the capture's warm-up
    runs on the state and restores it, keeping only the batch's rows);
    (e) the CLI with ``train.scan_steps=8`` and ``=0`` in turns; (f) no
    host sync in a replay, nor in a warm eager step."""
    import torch

    from deepctr_torch.data import synthetic

    t_phase = time.perf_counter()
    ds = synthetic.generate(schema, num_examples=2 * SCAN_K * BATCH, k=K, seed=SEED + 17)
    ids = torch.from_numpy(ds.ids).to(dev).view(2, SCAN_K, BATCH, -1)
    labels = torch.from_numpy(ds.labels).to(dev).view(2, SCAN_K, BATCH)
    weights = torch.ones(2, SCAN_K, BATCH, device=dev)
    chunks = [(ids[c], labels[c], weights[c]) for c in range(2)]
    deepfm = ["model.name=deepfm", "model.hidden=" + ",".join(map(str, DEEPFM_HIDDEN)),
              "model.activation=relu", "model.dropout=0.5"]
    cases = {
        "fnn": (FNN_CONFIG, ["model.init_from=none", "train.table_dtype=bf16"]),
        "fnn-adam": (FNN_CONFIG, ["model.init_from=none", "train.table_dtype=bf16",
                                  "optim.dense=adam"]),
        "fm": (FM_CONFIG, ["train.table_dtype=bf16"]),
        "deepfm": (FNN_CONFIG, ["model.init_from=none", "train.table_dtype=bf16",
                                *deepfm]),
        "snn": (SNN_CONFIG, ["train.table_dtype=f32"]),
    }
    timed = {}
    for tag, (config, overrides) in cases.items():
        state, scan, step = _scan_case(dev, root, schema, schema_path, config, overrides)
        _graph_vs_eager(tag, state, scan, step, chunks[0])
        if tag == "fnn-adam":
            # (b) 3 real steps, then 5 pad steps: pad ids, label 0, weight 0
            pad = tuple(t.clone() for t in chunks[1])
            pad[0][3:] = schema.pad_id
            pad[1][3:] = 0.0
            pad[2][3:] = 0.0
            _graph_vs_eager(f"{tag}, a chunk of 3 steps padded with 5", state, scan,
                            step, pad)
        if tag == "fnn":
            # (f) no host sync in a replay of a captured graph, nor in an
            # eager step, under the sync debug mode's "error"
            st = state.clone()
            scan(st, *chunks[0])
            step(st, *(t[0] for t in chunks[0]))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                scan(st, *chunks[1])
                step(st, *(t[1] for t in chunks[1]))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print(f"scan {tag}: a replay and an eager step under "
                  f"torch.cuda.set_sync_debug_mode('error'): no host sync")
            del st
        if tag in ("fnn", "fm", "deepfm", "snn"):
            timed[tag] = _time_routes(tag, state, scan, step, chunks)
        del state, scan, step
    sorted_update = _time_sorted_update(dev, schema, ids[0, 0])

    # (e) the CLI on the config's default route (scan_steps=8) and per step
    examples = int(np.ceil(TRAIN_STEPS * BATCH / (1 - TEST_FRACTION))) + 1
    base = ["model.init_from=none", f"data.schema_path={schema_path}",
            f"train.batch_size={BATCH}", "train.table_dtype=bf16",
            f"data.synthetic_examples={examples}", "train.epochs=2",
            "train.early_stop_patience=99"]
    rates, ckpts = {8: [], 0: []}, {}
    for k in (8, 0, 0, 8):
        ckpt = os.path.join(tmp, f"scan_{k}_{len(rates[k])}.ckpt")
        res, launches, _ = _retrain_run(
            dev, root, base + [f"train.scan_steps={k}", f"train.checkpoint_path={ckpt}"],
            f"scan cli, train.scan_steps={k}")
        steps = res["state"].step
        want = 2 * TRAIN_STEPS + (launches["captures"] if k else 0)
        if steps != 2 * TRAIN_STEPS or (launches["fwd_dropout"], launches["bwd"]) != (
                want, want):
            raise AssertionError(f"scan cli {k}: {steps} steps, launches {launches}")
        rates[k].append([round(r["examples_per_s"]) for r in res["history"]])
        ckpts.setdefault(k, ckpt)
        del res
    (ma, la), (mb, lb) = _ckpt_leaves(ckpts[8]), _ckpt_leaves(ckpts[0])
    same = (len(la) == len(lb)
            and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb)))
    print(f"scan cli: {FNN_CONFIG}, 2 epochs of {TRAIN_STEPS} steps: checkpoints of "
          f"train.scan_steps=8 (graph) and =0 (per step), {len(la)} leaves: "
          f"bit-identical: {same}; epoch examples/s (host clock) scan_steps=8 "
          f"{rates[8]}, scan_steps=0 {rates[0]}")
    if not same:
        raise AssertionError("scan cli: the graph route's checkpoint differs")
    print(f"scan: phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return {"timed": timed, "cli_rates": rates, "sorted_update": sorted_update}


def _sharded_scan_case(dev, root, config, overrides, group):
    """One config from a seed, for the sharded scan route in a world of one:
    (cfg, schema, the unsharded state, the same state packed into this
    rank's shard, the sharded scan step, the sharded eager step, the
    unsharded scan step)."""
    from deepctr_torch import cli
    from deepctr_torch import parallel as par
    from deepctr_torch.config import RunConfig
    from deepctr_torch.train import init_state, make_scan_train_step

    cfg = RunConfig.load(os.path.join(root, config)).apply_overrides(overrides)
    schema = cli._load_schema_only(cfg)
    sopt, dopt = cli.build_optimizers(cfg)
    single = init_state(cli.build_model(cfg, schema, dev), schema, sopt, dopt,
                        seed=SEED + 18, table_dtype=cfg.train.table_dtype)
    sst = par.sharded_state_from_state(single.clone(), group)
    kw = dict(l2=cfg.optim.l2, capacity_factor=cfg.train.capacity_factor,
              exchange_dtype=cfg.train.exchange_dtype)
    return (cfg, schema, single, sst,
            par.make_sharded_scan_train_step(schema, sopt, dopt, group, **kw),
            par.make_sharded_train_step(schema, sopt, dopt, group, **kw),
            make_scan_train_step(schema, sopt, dopt, l2=cfg.optim.l2))


def _sharded_graph_vs_eager(tag, sst, scan, step, chunk):
    """From one sharded state: one replay of the sharded scan graph
    (captured on this call) against the chunk's sharded steps run eagerly
    on a clone, bit for bit: the losses, the dropped counts, the table
    shard, both optimizers' states, the tower, ``step`` and the generator.
    Returns (the graph's state, its metrics, the launches of the call)."""
    import torch

    from deepctr_torch.ops.kernels import tower_launches

    g, e = sst.clone(), sst.clone()
    _reset_counts()
    t0 = time.perf_counter()
    g, gm = scan(g, *chunk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _counts()
    graph = scan.graph[0]
    em = [step(e, *(t[i] for t in chunk))[1] for i in range(chunk[0].shape[0])]
    same = {"losses": torch.equal(gm.losses, torch.stack([m.loss for m in em])),
            "dropped": torch.equal(gm.dropped, torch.stack([m.dropped for m in em])),
            "state": _same_state(g, e)}
    print(f"sharded scan {tag}: one replay of a {chunk[0].shape[0]}-step sharded graph "
          f"(NCCL exchanges and all-reduces inside) vs as many eager sharded steps "
          f"from one state, bit for bit (losses, dropped {gm.dropped.tolist()}, table "
          f"shard, optimizer states, tower, step {g.step}, generator): {same}; capture "
          f"{graph.capture_s:.2f} s (its warm-up keeping "
          f"{graph.snapshot_bytes / 2**20:.2f} MiB of the state), first call "
          f"{first_s:.2f} s; launches of that call "
          f"{launches}, per replay "
          f"{tower_launches(graph.launches)}")
    if not all(same.values()):
        raise AssertionError(f"sharded scan {tag}: the graph replay differs from eager "
                             f"sharded steps")
    return g, gm, launches


def _no_host_sync(tag, sst, scan, chunks) -> None:
    """A replay of a captured sharded graph under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync."""
    import torch

    st = sst.clone()
    scan(st, *chunks[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scan(st, *chunks[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"sharded scan {tag}: a replay under torch.cuda.set_sync_debug_mode('error'): "
          f"no host sync")


def _nccl_capture_probe(dev) -> None:
    """``all_to_all_single`` captured alone in a CUDA graph in a world of one
    (after one eager call, which sets up the communicator): replayed after
    its input is rewritten, its output must be the new input, so the
    exchange runs inside the replay and not at capture. Prints the device
    ops the profiler records in one replay."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 16, dtype=torch.long, device=dev)
    out = torch.empty_like(x)
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        dist.all_to_all_single(out, x)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        dist.all_to_all_single(out, x)
    x.copy_(torch.arange(x.numel(), device=dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    ops = [(key, count) for _, count, key in _device_ops(prof)]
    same = torch.equal(out, x)
    print(f"sharded scan: all_to_all_single captured alone in a CUDA graph (world of "
          f"one NCCL rank): the replay's output is the input written after the "
          f"capture: {same}; device ops of one replay (profiler): {ops}")
    if not same:
        raise AssertionError("all_to_all_single was not captured in the CUDA graph")


def _phase18_sharded_scan(dev, root, tmp, schema_path) -> dict:
    """The sharded scan route in a world of one NCCL rank: K = 8 sharded
    steps as one CUDA graph with their NCCL collectives captured inside.
    (a) a replay against 8 eager sharded steps, bit for bit, for FNN, FM
    and the Criteo stretch config at full width, (a') for FNN and FM
    against the unsharded graph of phase 17 from the same state; (b) a
    chunk of 3 real and 5 pad steps with Adam; (c) the Criteo CLI with
    ``train.scan_steps=8`` and ``=0`` in turns, checkpoints equal, and both
    routes timed for FNN and Criteo, gated: the graph route's peak device
    memory at most ``GRAPH_PEAK_GAP_GIB`` over the eager route's (the
    capture's warm-up restores the shard's rows that every rank's ids
    reach, gathered by one ``all_gather``, and copies no shard); (d) no
    host sync in a replay; (e) the tower launches."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch import parallel as par
    from deepctr_torch.data import synthetic

    t_phase = time.perf_counter()
    print("sharded scan: a world of one NCCL rank on cuda:0 (one card; NCCL refuses "
          "two ranks on one GPU, so the multi-rank checks run on the CPU with gloo)")
    out = {}
    with par.process_group(dev) as group:
        _nccl_capture_probe(dev)
        cases = {
            "fnn": (FNN_CONFIG, ["model.init_from=none", "train.table_dtype=bf16",
                                 f"data.schema_path={schema_path}"]),
            "fnn-adam": (FNN_CONFIG, ["model.init_from=none", "train.table_dtype=bf16",
                                      "optim.dense=adam", f"data.schema_path={schema_path}"]),
            "fm": (FM_CONFIG, ["train.table_dtype=bf16", f"data.schema_path={schema_path}"]),
            "criteo": (CRITEO_CONFIG, ["train.table_dtype=f32"]),
        }
        for tag, (config, overrides) in cases.items():
            cfg, schema, single, sst, scan, step, uscan = _sharded_scan_case(
                dev, root, config, overrides, group)
            ds = synthetic.generate(schema, num_examples=2 * SCAN_K * BATCH, k=K,
                                    seed=SEED + 18)
            ids = torch.from_numpy(ds.ids).to(dev).long().view(2, SCAN_K, BATCH, -1)
            labels = torch.from_numpy(ds.labels).to(dev).view(2, SCAN_K, BATCH)
            weights = torch.ones(2, SCAN_K, BATCH, device=dev)
            chunks = [(ids[c], labels[c], weights[c]) for c in range(2)]
            del ds
            if tag == "fnn-adam":
                # (b) 3 real steps, then 5 pad steps: pad ids, label 0, weight 0
                pad = tuple(t.clone() for t in chunks[1])
                pad[0][3:] = schema.pad_id
                pad[1][3:] = 0.0
                pad[2][3:] = 0.0
                _sharded_graph_vs_eager(f"{tag}, a chunk of 3 steps padded with 5", sst,
                                        scan, step, pad)
                continue
            g, gm, launches = _sharded_graph_vs_eager(tag, sst, scan, step, chunks[0])
            if tag == "fm":
                out["fm_launches"] = launches
            if tag in ("fnn", "fm"):
                # (a') the unsharded graph of phase 17 from the same state
                u, u_losses = uscan(single.clone(), *chunks[0])
                host = par.host_state_from_sharded(g, group)
                same = torch.equal(gm.losses, u_losses) and _same_state(host, u)
                print(f"sharded scan {tag}: the world-1 sharded replay vs the unsharded "
                      f"graph's replay from the same state, losses and state bit for "
                      f"bit: {same}")
                if not same:
                    raise AssertionError(f"sharded scan {tag}: the world-1 sharded graph "
                                         f"is not the unsharded graph")
                del u, host
            del g
            if tag in ("fnn", "criteo"):
                _no_host_sync(tag, sst, scan, chunks)     # (d)
                single = None     # only the sharded state while timed
                shard = sst.model.table
                print(f"sharded scan {tag}: table shard {tuple(shard.shape)} "
                      f"{shard.dtype}, capacity {cfg.train.capacity_factor}")
                timed = _time_routes(f"{tag} sharded", sst, scan, step, chunks)
                print(f"sharded scan {tag}: device ops a chunk of 8 steps (profiler): "
                      f"graph {timed['graph']['ops']:.0f} (the replay's captured "
                      f"kernels and copies, and the chunk's input and seed copies), "
                      f"eager {timed['eager']['ops']:.0f}; names with nccl: graph "
                      f"{timed['graph']['nccl']}, eager {timed['eager']['nccl']}")
                out.setdefault("timed", {})[tag] = timed
            del single, sst, scan, step, uscan, chunks, ids, labels, weights
    torch.cuda.empty_cache()

    # (c) the Criteo config through the CLI, on the graph route and per step
    rates, ckpts, launches, peaks = {8: [], 0: []}, {}, {}, {8: [], 0: []}
    for k in (8, 0, 0, 8):
        ckpt = os.path.join(tmp, f"sharded_scan_{k}_{len(rates[k])}.ckpt")
        torch.cuda.reset_peak_memory_stats()
        _, _, result, c_launches, _ = _cli_train(
            dev, root, tmp, CRITEO_CONFIG,
            [f"train.scan_steps={k}", f"train.checkpoint_path={ckpt}"], TRAIN_STEPS,
            f"criteo sharded, train.scan_steps={k}", table_dtype="f32")
        rec = result["history"][0]
        # (e) the tower's launches: 8 a replay and a capture's warm-up step
        want = _graph_launches(c_launches, TRAIN_STEPS) if k else TRAIN_STEPS
        if (c_launches["fwd_dropout"], c_launches["bwd"]) != (want, want) or (
                rec["dropped_ids"] or rec["auc"] <= 0.5):
            raise AssertionError(f"criteo sharded scan_steps={k}: launches {c_launches}, "
                                 f"{rec}")
        rates[k].append(round(rec["examples_per_s"]))
        peaks[k].append(round(torch.cuda.max_memory_allocated() / 2**30, 2))
        launches.setdefault(k, c_launches)
        if k in ckpts:
            os.remove(ckpt)
        else:
            ckpts[k] = ckpt
        del result
    (_, la), (_, lb) = _ckpt_leaves(ckpts[8]), _ckpt_leaves(ckpts[0])
    same = (len(la) == len(lb)
            and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb)))
    del la, lb
    for path in ckpts.values():
        os.remove(path)
    print(f"sharded scan cli: {CRITEO_CONFIG}, {TRAIN_STEPS} steps of {BATCH}: "
          f"checkpoints of train.scan_steps=8 (graph) and =0 (per step) bit-identical: "
          f"{same}; CLI epoch examples/s (host clock) scan_steps=8 {rates[8]}, "
          f"scan_steps=0 {rates[0]}; peak device memory GiB scan_steps=8 {peaks[8]}, "
          f"=0 {peaks[0]}; tower launches scan_steps=8 {launches[8]} (40 steps and a "
          f"warm-up step), =0 {launches[0]}")
    if not same:
        raise AssertionError("sharded scan cli: the graph route's checkpoint differs")
    print(f"sharded scan: phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return {**out, "cli_rates": rates, "cli_peaks": peaks,
            "criteo_launches": launches[8]}


REPRODUCE_ARGV = ["--models", "lr,fm,fnn,snn_rbm,deepfm,ipnn", "--epochs", "2",
                  "--no-tuned", "--no-convergence-study"]
REPRODUCE_TOWER = ("fnn", "snn_rbm", "deepfm", "ipnn")   # runs with the tower kernels
REPRODUCE_FM = ("fm", "deepfm")                          # runs with the FM scorer
EVAL_BATCH = 8192                                        # train.loop.evaluate's batch
# device memory after the suite may exceed what it was before by this much,
# read as held (cuBLAS workspaces and all) and with the workspaces cleared:
# what the runs keep (a capture's pool: 0.6 MiB once the capture stream has
# its workspaces, on an NVIDIA H100 80GB HBM3 at 700 W) and, as held, at most
# two new workspaces of 32 MiB. A new side stream for each of the suite's six
# captures would hold 192 MiB more
MEMORY_SLACK_MIB = 64


def _reproduce_fnn_graph(dev, args) -> dict:
    """The suite's FNN step at its batch, 512 (ipinyou_like, k=10, tower
    200-300-100 tanh, dropout 0, Adagrad 0.1/0.05, K = 8), from a seeded
    state on the suite's data: the memory one capture keeps (its graph pool
    and static buffers), wall and device ms a step over 5 replays after the
    capturing one, and the device's busy share of a replay
    (``torch.profiler``). Releases the graph before it returns."""
    import gc

    import torch

    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig
    from deepctr_torch.data import ipinyou_like_schema, synthetic
    from deepctr_torch.tools import reproduce
    from deepctr_torch.train import init_state, make_scan_train_step

    raw = reproduce.model_config("fnn", args, "unused")
    raw["model"]["init_from"] = None
    cfg = RunConfig.from_dict(raw)
    schema = ipinyou_like_schema()
    b, k = cfg.train.batch_size, cfg.train.scan_steps
    ds = synthetic.generate(schema, num_examples=(SCAN_TIMED_CHUNKS + 1) * k * b,
                            seed=7, teacher=args.teacher)
    chunks = [(torch.from_numpy(ds.ids[c * k * b:(c + 1) * k * b]).to(dev).long()
               .reshape(k, b, -1),
               torch.from_numpy(ds.labels[c * k * b:(c + 1) * k * b]).to(dev).reshape(k, b),
               torch.ones(k, b, device=dev)) for c in range(SCAN_TIMED_CHUNKS + 1)]
    sopt, dopt = cli.build_optimizers(cfg)
    state = init_state(cli.build_model(cfg, schema, dev), schema, sopt, dopt, seed=SEED)
    scan = make_scan_train_step(schema, sopt, dopt)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    scan(state, *chunks[0])
    torch.cuda.synchronize()
    pool = torch.cuda.memory_allocated() - before
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for c in range(1, SCAN_TIMED_CHUNKS + 1):
        scan(state, *chunks[c])
    end.record()
    end.synchronize()
    steps = SCAN_TIMED_CHUNKS * k
    wall = (time.perf_counter() - t0) * 1e3 / steps
    span = start.elapsed_time(end) / steps
    prof = _profile_loop(lambda i: scan(state, *chunks[1 + i]), SCAN_TIMED_CHUNKS,
                         f"reproduce fnn graph at batch {b}", per=f"chunk of {k} steps")
    out = {"pool_mib": pool / 2**20, "wall_ms": wall, "span_ms": span,
           "device_ms": prof["device_us"] / k / 1e3, "busy": prof["busy"],
           "capture_s": scan.graph[0].capture_s,
           "examples_per_s": b / (wall / 1e3)}
    print(f"reproduce fnn graph at batch {b}: the capture keeps {out['pool_mib']:.1f} "
          f"MiB (graph pool and static buffers), capture {out['capture_s']:.2f} s; wall "
          f"{wall:.4f} ms a step (host clock), span {span:.4f} ms a step (CUDA events), "
          f"device busy {out['device_ms']:.4f} ms a step, {100 * prof['busy']:.1f}% of "
          f"the wall (profiler), {out['examples_per_s']:.0f} examples/s; kernels named "
          f"{sorted(prof['kernels'])}")
    del scan, state
    gc.collect()
    return out


def _live_graphs() -> int:
    """The scan route's graphs still alive in this process."""
    import gc

    from deepctr_torch.train.step import _ChunkGraph

    return sum(isinstance(o, _ChunkGraph) for o in gc.get_objects())


def _private_pool_mib() -> float:
    """Device memory still held in private (CUDA graph) pools, after
    ``empty_cache`` has returned the pools of released graphs."""
    import torch

    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) != (0, 0)) / 2**20


def _allocated_without_workspaces() -> tuple[int, int]:
    """(device bytes allocated, bytes of them that were cuBLAS workspaces).
    cuBLAS keeps a workspace (32 MiB on the H100) for each stream it has run
    on, and each capture's warm-up runs on a side stream from torch's pool
    (up to 32 a device): they are cleared here, so that what is compared is
    what the runs kept."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    return allocated, held - allocated


def _phase19_reproduce(dev, tmp) -> dict:
    """The model-family suite of ``deepctr_torch.tools.reproduce`` (the
    counterpart of ``tools/reproduce.py``) at a cut budget, on the card:
    a well-formed table in MODELS order with every AUC finite and above
    0.5; the kernels' launches as the scan route predicts them (one a step,
    a replay adding its capture's, one warm-up step a capture, one graph a
    run, and the eval forward once an eval batch); and every run's graph
    and pool released: no live graph, no private pool, and the device
    memory after the last run within ``MEMORY_SLACK_MIB`` of before the
    first, read as held and with cuBLAS's workspaces cleared on both
    sides."""
    import torch

    from deepctr_torch.tools import reproduce
    from deepctr_torch.utils.artifacts import float_or_none, parse_md_table

    args = reproduce.parse_args(REPRODUCE_ARGV)
    fnn = _reproduce_fnn_graph(dev, args)
    if _live_graphs():
        raise AssertionError("reproduce: the FNN graph outlived its step")
    out = os.path.join(tmp, "RESULTS_TORCH.md")
    argv = REPRODUCE_ARGV + ["--device", "cuda", "--out", out]
    before, before_ws = _allocated_without_workspaces()
    print("reproduce: python -m deepctr_torch.tools.reproduce " + " ".join(argv))
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = reproduce.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    after, workspaces = _allocated_without_workspaces()
    held, before_held = after + workspaces, before + before_ws
    live, pools = _live_graphs(), _private_pool_mib()
    with open(out) as f:
        text = f.read()
    start = text.index("### Model family (shared dataset")
    rows = parse_md_table(text[start:])   # the last table of this cut
    names = REPRODUCE_ARGV[1].split(",")
    for r in rows:
        print(f"  {r['run']}: AUC {r['AUC']}, logloss {r['logloss']}, wall {r['wall s']} s, "
              f"peak {r['peak MiB']} MiB, {r['examples/s']} examples/s (RESULTS.md "
              f"{r['RESULTS.md AUC']})")
    labels = [r["run"] for r in rows]
    if labels != [m for m in reproduce.MODELS if m in names]:
        raise AssertionError(f"reproduce: rows {labels}, not {names} in MODELS order")
    aucs = [float_or_none(r["AUC"]) for r in rows]
    if not all(a is not None and np.isfinite(a) and a > 0.5 for a in aucs):
        raise AssertionError(f"reproduce: an AUC not finite or not above 0.5: {aucs}")

    # the launches the scan route predicts: data of 120,000 rows, 85% trained
    n_train = int(args.examples * (1 - TEST_FRACTION))
    steps = args.epochs * SCAN_K * -(-(n_train // args.batch) // SCAN_K)
    evals = args.epochs * -(-(args.examples - n_train) // EVAL_BATCH)
    want = {"fwd_eval": len(REPRODUCE_TOWER) * (steps + 1 + evals), "fwd_dropout": 0,
            "bwd": len(REPRODUCE_TOWER) * (steps + 1),
            "fm_score": len(REPRODUCE_FM) * (steps + 1 + evals), "captures": len(names)}
    # every run's sparse Adagrad is in dense mode (a small table): one update a
    # step and a warm-up step at least (a pretraining adds its own)
    dense_least = len(names) * (steps + 1)
    print(f"reproduce: {len(names)} runs in {seconds:.1f} s ({res['seconds']:.1f} s in "
          f"main), {steps} steps a run; launches {launches}, predicted {want} (a "
          f"run's steps, one warm-up step for its one capture, {evals} eval batches "
          f"of the forward) and adagrad_dense {dense_least} at least; device memory "
          f"as held {before_held / 2**20:.1f} MiB before the first run and "
          f"{held / 2**20:.1f} MiB after the last with its state released "
          f"({launches['captures']} captures); with cuBLAS's workspaces cleared "
          f"{before / 2**20:.1f} MiB before and {after / 2**20:.1f} MiB after "
          f"({workspaces / 2**20:.1f} MiB of workspaces freed; one capture keeps "
          f"{fnn['pool_mib']:.1f} MiB); live graphs {live}; private pools {pools} MiB")
    if {k: n for k, n in launches.items() if k != "adagrad_dense"} != want or (
            launches["adagrad_dense"] < dense_least):
        raise AssertionError(f"reproduce: launches {launches}, predicted {want}")
    if live or pools:
        raise AssertionError(f"reproduce: {live} graphs and {pools} MiB of graph pools "
                             f"outlived their runs")
    if held - before_held > MEMORY_SLACK_MIB * 2**20:
        raise AssertionError(f"reproduce: {(held - before_held) / 2**20:.1f} MiB more "
                             f"device memory held after the suite than before it")
    if after - before > MEMORY_SLACK_MIB * 2**20:
        raise AssertionError(f"reproduce: {(after - before) / 2**20:.1f} MiB more device "
                             f"memory after the suite than before it")
    return {"launches": launches, "seconds": seconds, "fnn": fnn}


BENCH_SECTIONS = "parser,models,lookup,serving"
# the suite's launches a replay of SCAN_K steps, by model: the tower's forward
# with dropout and its backward once a step where there is a tower (dropout
# 0.5), the FM scorer once a step in FM and DeepFM
BENCH_MODEL_LAUNCHES = {
    "lr": {"fwd": 0, "fwd_dropout": 0, "bwd": 0, "fm_score": 0},
    "fm": {"fwd": 0, "fwd_dropout": 0, "bwd": 0, "fm_score": SCAN_K},
    "fnn": {"fwd": SCAN_K, "fwd_dropout": SCAN_K, "bwd": SCAN_K, "fm_score": 0},
    "deepfm": {"fwd": SCAN_K, "fwd_dropout": SCAN_K, "bwd": SCAN_K, "fm_score": SCAN_K},
}


def _run_tool(argv, cwd, root, tag) -> list:
    """One of the benchmark entry points in a subprocess (``root`` on its
    path): its stdout's lines, each printed; raises unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *argv], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    for line in lines:
        print(f"  {tag}: {line[:400]}")
    if res.returncode != 0:
        raise AssertionError(f"{tag} exited {res.returncode}: {res.stderr[-3000:]}")
    print(f"{tag}: {time.perf_counter() - t0:.1f} s")
    return lines


def _phase20_bench(root, tmp, card) -> None:
    """``deepctr_torch.tools.bench_suite`` on the card, in a subprocess: the
    suite's rates, launches and peak memory by section."""
    suite_dir = os.path.join(tmp, "bench_suite")
    os.makedirs(suite_dir)
    _run_tool(["-m", "deepctr_torch.tools.bench_suite", "--sections", BENCH_SECTIONS],
              suite_dir, root, "bench_suite")
    with open(os.path.join(suite_dir, "BENCH_TORCH.json")) as f:
        results = json.load(f)
    with open(os.path.join(suite_dir, "BENCH_TORCH.md")) as f:
        if card not in f.read():
            raise AssertionError(f"bench_suite: BENCH_TORCH.md does not name {card!r}")
    for model, want in BENCH_MODEL_LAUNCHES.items():
        rate = results[f"train_examples_per_s/{model}"]
        if not (np.isfinite(rate) and rate > 0):
            raise AssertionError(f"bench_suite: {model} at {rate} examples/s")
        if results[f"launches_per_replay/{model}"] != want:
            raise AssertionError(f"bench_suite: {model}'s launches a replay "
                                 f"{results[f'launches_per_replay/{model}']}, predicted "
                                 f"{want}")
    for mode in ("f32", "bf16", "int8"):
        if results[f"launches_per_batch/{mode}"] != 1:
            raise AssertionError(f"bench_suite: serving {mode}: "
                                 f"{results[f'launches_per_batch/{mode}']} tower "
                                 f"launches a batch, predicted 1")
    for section in BENCH_SECTIONS.split(","):
        peak = results[f"device_peak_mib/{section}"]
        print(f"bench_suite: {section}: peak device memory {peak:.1f} MiB")
        if section != "parser" and not peak > 0:
            raise AssertionError(f"bench_suite: {section} used no device memory")
    print("bench_suite: examples/s " + ", ".join(
        f"{m} {results[f'train_examples_per_s/{m}']:,.0f}" for m in BENCH_MODEL_LAUNCHES)
        + "; launches a replay as predicted; one tower forward a scored batch")


# phase 21 (a): the executed-bytes cases in a world of one NCCL rank, as
# (model, capacity factor, wire, table) of scaling_report's grid
EXECUTED_CASES = [("fnn", 2.0, "f32", "bf16"), ("fnn", 1.25, "bf16", "f32"),
                  ("fm", 2.0, "f32", "bf16")]


def _phase21_scaling_and_substrate(dev) -> dict:
    """(a) the sharded train step, eval step and scan capture of full-width
    FNN and FM in a world of one NCCL rank under ``record_collectives``:
    every collective's bytes and calls equal ``sent_volume``'s (the rows
    ``deepctr_torch.tools.scaling_report`` writes; a mismatch raises); (b)
    ``deepctr_torch.tools.substrate_lab --exp rank2`` at its defaults, with
    the counts set to 0 just before it and read just after: its gate (SNN
    and FNN above LR by more than 0.02 AUC), each AUC, and the tower
    forward, backward and FM scorer launched."""
    import torch

    from deepctr_torch import parallel as par
    from deepctr_torch.tools import scaling_report, substrate_lab

    t_phase = time.perf_counter()
    with par.process_group(dev) as group:
        cases = scaling_report.executed_cases(group, small=False, grid=EXECUTED_CASES)
    bad = []
    for case in cases:
        for r in scaling_report.case_rows(case):
            print(f"  executed bytes: {r['label']}, {r['collective']}: {r['calls']} calls, "
                  f"accounted {r['accounted']:,} B, executed {r['executed']:,} B, "
                  f"match {r['match']}")
            if not r["match"]:
                bad.append(r)
    if bad:
        raise AssertionError(f"executed bytes differ from sent_volume's: {bad}")
    t_exec = time.perf_counter() - t_phase
    print(f"scaling report: {len(cases)} cases in a world of one NCCL rank, every "
          f"collective as sent_volume accounts it ({t_exec:.1f} s)")

    _reset_counts()
    t0 = time.perf_counter()
    aucs = substrate_lab.main(["--exp", "rank2"])["rank2"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    print(f"substrate lab rank2: AUC {aucs} (gate: snn and fnn above lr by more than "
          f"{substrate_lab.GATE}) in {seconds:.1f} s; launches {launches}")
    if not all(launches[k] for k in ("fwd_eval", "fwd_dropout", "bwd", "fm_score")):
        raise AssertionError(f"substrate lab: a kernel was not launched: {launches}")
    print(f"phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "aucs": aucs, "seconds": seconds}


def _capacity_schema(total_bytes: int):
    """``ipinyou_full_schema``'s 16 fields (18 slots, FNN's tower input 176)
    with the url field grown until the f32 table of 1+k and its f32 Adagrad
    accumulator take ``CAPACITY_SHARE`` of ``total_bytes``."""
    from deepctr_torch.data import ipinyou_full_schema, make_schema

    base = ipinyou_full_schema()
    rows = int(CAPACITY_SHARE * total_bytes) // (2 * 4 * (1 + K))
    grow = rows - base.padded_vocab_size
    return make_schema([(f.name, f.vocab_size + (grow if f.name == "url" else 0),
                         f.max_len) for f in base.fields])


def _phase22_capacity(dev) -> dict:
    """The scan route at a single-card state of ``CAPACITY_SHARE`` of the
    card's memory (FNN at ``bench.py``'s widths, sorted mode): 8 eager
    steps, then the state filled again in place from the same seeds and one
    graph chunk of 8 from it, losses bit for bit, the graph's peak at most
    ``GRAPH_PEAK_GAP_GIB`` over the eager steps'. ``models/base.py::
    init_table`` draws a full f32 temporary, so the table is filled in
    place here."""
    import torch

    from deepctr_torch.models import MlpSpec, make_fnn
    from deepctr_torch.models.base import init_mlp
    from deepctr_torch.optim import SparseAdagrad, make_dense_optimizer
    from deepctr_torch.train import (TrainState, dense_params, make_scan_train_step,
                                     make_train_step)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    schema = _capacity_schema(total)
    sopt = SparseAdagrad(0.05, mode="sorted")
    dopt = make_dense_optimizer("adagrad", 0.02)
    model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=FNN_HIDDEN, activation="tanh",
                                             dropout=DROPOUT), device=dev)
    model.table.requires_grad_(False)
    state = TrainState(step=0, model=model, sparse_state=sopt.init(model.table),
                       dense_state=dopt.init(dense_params(model)),
                       generator=torch.Generator())

    def fill():
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        with torch.no_grad():
            model.table.normal_(0.0, model.init_sigma, generator=gen)
            model.table[schema.pad_id] = 0.0
            init_mlp(model.mlp, gen)
            state.sparse_state.acc.fill_(sopt.initial_accumulator)
            for acc in state.dense_state:
                acc.fill_(dopt.initial_accumulator_value)
        state.step = 0
        state.generator.manual_seed(SEED + 22)

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    offsets = schema.offsets
    ids = torch.cat([torch.randint(int(o), int(o) + f.vocab_size, (SCAN_K, BATCH, f.max_len),
                                   generator=gen, device=dev)
                     for o, f in zip(offsets, schema.fields)], dim=-1)
    labels = (torch.rand(SCAN_K, BATCH, generator=gen, device=dev) < 0.25).float()
    weights = torch.ones(SCAN_K, BATCH, device=dev)
    state_bytes = sum(t.numel() * t.element_size() for t in (
        model.table, state.sparse_state.acc, *dense_params(model), *state.dense_state))
    print(f"capacity: {schema.padded_vocab_size:,} rows x {1 + K} f32 table and "
          f"accumulator, {state_bytes / 2**30:.2f} GiB of state, "
          f"{state_bytes / total:.3f} of the card's {total / 2**30:.2f} GiB "
          f"({free / 2**30:.2f} GiB free before it)")

    step = make_train_step(schema, sopt, dopt)
    scan = make_scan_train_step(schema, sopt, dopt)
    peaks = {}
    fill()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eager = torch.stack([step(state, ids[i], labels[i], weights[i])[1].loss
                         for i in range(SCAN_K)])
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    peaks["eager"] = torch.cuda.max_memory_allocated() / 2**30

    fill()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    state, losses = scan(state, ids, labels, weights)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _counts()
    peaks["graph"] = torch.cuda.max_memory_allocated() / 2**30
    graph = scan.graph[0]
    same = torch.equal(losses, eager)
    replays = 3
    t0 = time.perf_counter()
    for _ in range(replays):
        scan(state, ids, labels, weights)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (replays * SCAN_K)
    gap = peaks["graph"] - peaks["eager"]
    print(f"capacity: 8 eager steps ({eager_s:.2f} s) and one graph chunk of 8 "
          f"from the same state (first call {first_s:.2f} s: capture "
          f"{graph.capture_s:.2f} s, its warm-up keeping "
          f"{graph.snapshot_bytes / 2**20:.2f} MiB of the state): losses bit-identical "
          f"{same} {losses.tolist()}; peak device memory eager {peaks['eager']:.3f} GiB, "
          f"graph {peaks['graph']:.3f} GiB, gap {gap:.3f} GiB (gate "
          f"{GRAPH_PEAK_GAP_GIB}); graph wall {wall_ms:.4f} ms a step over {replays} "
          f"replays (host clock); launches of the first call {launches}")
    ok = (same and bool(torch.isfinite(losses).all()) and gap <= GRAPH_PEAK_GAP_GIB
          and launches["fwd_dropout"] == launches["bwd"] == SCAN_K + 1)
    result = {"rows": schema.padded_vocab_size, "state_gib": state_bytes / 2**30,
              "share": state_bytes / total, "peaks_gib": peaks,
              "capture_s": graph.capture_s, "snapshot_mib": graph.snapshot_bytes / 2**20,
              "wall_ms": wall_ms, "launches": launches}
    scan.graph.clear()
    del graph, state, model, step, scan, ids, labels, weights, eager, losses
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"capacity: {result}, losses equal {same}")
    print(f"phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return result


def _phase23_parity(dev) -> dict:
    """``parallel/parity.py``'s checks at both sizes in a world of one NCCL
    rank, with the kernel counts set to 0 just before and read just after;
    any miss raises, and so does a tower kernel that was not launched."""
    from deepctr_torch import parallel as par
    from deepctr_torch.parallel import parity

    t_phase = time.perf_counter()
    _reset_counts()
    with par.process_group(dev) as group:
        results = [parity.run_parity(group, size) for size in parity.SIZES]
    launches = _counts()
    for res in results:
        for line in parity.report_lines(res):
            print(f"  {line}")
        bits = {c["check"]: all(x["bitwise"] for x in c["leaves"])
                for c in res["checks"] if c["check"] in (1, 3)}
        print(f"parity {res['size']}: {len(res['checks'])} checks in {res['seconds']:.2f} "
              f"s; checks 1 and 3 bit-identical to the single-device step in a world "
              f"of one: {bits}")
    parity.raise_misses(results)
    print(f"parity: tower launches {launches}; phase 23 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not all(launches[k] for k in ("fwd_eval", "fwd_dropout", "bwd")):
        raise AssertionError(f"parity: a tower kernel was not launched: {launches}")
    return {"launches": launches}


# phase 24: the audit's variants and their tower launches a replay of
# SCAN_K steps (forward with dropout, forward without, backward)
ROOFLINE_LAUNCHES = {"full": (SCAN_K, 0, SCAN_K), "no_sparse": (SCAN_K, 0, SCAN_K),
                     "fwd_bwd_no_update": (SCAN_K, 0, SCAN_K),
                     "fwd_only": (SCAN_K, 0, 0), "full_plain_tower": (0, 0, 0)}


def _phase24_roofline(root, tmp, card) -> dict:
    """``python -m deepctr_torch.tools.step_breakdown`` (the speed-of-light
    audit of the full-vocab FNN step) in a subprocess at full width, every
    part but ``--quality``: exit 0 (the tool raises on its own gates), each
    gate passed for both tables, the first-step losses of ``full``,
    ``no_sparse``, ``fwd_bwd_no_update`` and ``fwd_only`` equal bit for bit,
    the state kept where no update runs, the tower launches a replay as
    predicted, and its ``ROOFLINE_TORCH.md`` naming phase 1's card. The
    component tables are among the tool's printed lines."""
    t_phase = time.perf_counter()
    out_md = os.path.join(tmp, "ROOFLINE_TORCH.md")
    _run_tool(["-m", "deepctr_torch.tools.step_breakdown", "--out", out_md], tmp, root,
              "step_breakdown")
    with open(os.path.join(tmp, "ROOFLINE_TORCH.json")) as f:
        res = json.load(f)
    with open(out_md) as f:
        if card not in f.read().split("\n|", 1)[0]:
            raise AssertionError(f"step_breakdown: ROOFLINE_TORCH.md does not name {card!r}")
    for dtype in ("f32", "bf16"):
        variants, gates = res["variants"][dtype], res["gates"][dtype]
        failed = [g for g in gates if not g["ok"]]
        if failed or len(gates) != 11:
            raise AssertionError(f"step_breakdown {dtype}: gates {gates}")
        losses = {variants[n]["first_loss"] for n in ROOFLINE_LAUNCHES
                  if n != "full_plain_tower"}
        if len(losses) != 1:
            raise AssertionError(f"step_breakdown {dtype}: first-step losses {losses}")
        for name in ("fwd_only", "fwd_bwd_no_update"):
            if not all(variants[name]["kept_after_replays"].values()):
                raise AssertionError(f"step_breakdown {dtype}: {name} changed the state: "
                                     f"{variants[name]['kept_after_replays']}")
        for name, want in ROOFLINE_LAUNCHES.items():
            got = variants[name]["launches"]
            if (got["fwd_dropout"], got["fwd"], got["bwd"]) != want:
                raise AssertionError(f"step_breakdown {dtype}: {name} launched {got} a "
                                     f"replay, predicted {want}")
        roof = res["roofline"][dtype]
        print(f"step_breakdown {dtype}: {len(gates)} gates passed; first-step loss "
              f"{losses.pop()!r} bit for bit in 4 variants; full {roof['full_device_ms']:.4f} "
              f"ms a step against a composite bound of {roof['composite_bound_ms']:.4f} ms; "
              f"launches a replay as predicted")
    total = res["launches_total"]
    print(f"step_breakdown: tower launches over the run {total}; phase 24 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"fwd_dropout": total["fwd_dropout"], "bwd": total["bwd"]}}


def _tracing_case(dev, schema, chunks, seed):
    """FNN at ``bench.py``'s widths (bf16 table, dense-mode Adagrad) from
    ``seed`` and its scan step; the graph is captured at the first chunk."""
    from deepctr_torch.models import MlpSpec, make_fnn
    from deepctr_torch.optim import SparseAdagrad, make_dense_optimizer
    from deepctr_torch.train import init_state, make_scan_train_step

    model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=FNN_HIDDEN, activation="tanh",
                                             dropout=DROPOUT), device=dev)
    sopt, dopt = SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)
    state = init_state(model, schema, sopt, dopt, seed=seed, table_dtype="bf16")
    scan = make_scan_train_step(schema, sopt, dopt)
    scan(state, *chunks[0])
    return state, scan


def _timed_replays(scan, state, chunks, n) -> list:
    """CUDA-event ms of each of ``n`` chunks through ``scan``."""
    import torch

    pairs = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scan(state, *chunks[i % len(chunks)])
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def _phase25_tracing(dev, rng=None) -> dict:
    """The program's tracing (``deepctr_torch/utils/prof.py``) on the card,
    FNN at ``bench.py``'s widths, full iPinYou, batch 8192, K = 8: (a) a
    graph captured with tracing off launches no stamp; (b) one captured with
    it on holds 33 stamps a replay, named ``start`` and ``lookup, tower,
    sparse, dense`` 8 times, and over 20 replays its phases' device ms sum
    to within 2% of the replays' CUDA-event time; the stamp kernel's ring
    against ``phase_stamp_plain`` on a CPU buffer stamped in the capture's
    slot order as often, with a clock that only rises (the same count of
    replays, the same cells written, the stamps rising along every row);
    the stamps' device ms a step by phase; ``%globaltimer``'s smallest nonzero step and the greatest
    common step of the stamps; the spans of each replay, numbered as the
    ring numbers its rows; (c) the stamps' cost, replays of the two graphs in
    turns; (d) under ``torch.profiler`` a span starts within 100 µs of its
    ``record_function``: both on the same host clock; (e) in a world of one
    NCCL rank the sharded graph's 41 stamps a replay, named ``start`` and
    ``lookup, tower, dense, grads, sparse`` 8 times."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepctr_torch import parallel as par
    from deepctr_torch.data import ipinyou_full_schema, synthetic
    from deepctr_torch.models import MlpSpec, make_fnn
    from deepctr_torch.ops.kernels import stamp as stamp_k
    from deepctr_torch.optim import SparseAdagrad, make_dense_optimizer
    from deepctr_torch.train import init_state
    from deepctr_torch.utils import prof

    t_phase = time.perf_counter()
    schema = ipinyou_full_schema()
    ds = synthetic.generate(schema, num_examples=2 * SCAN_K * BATCH, k=K, seed=SEED + 25)
    ids = torch.from_numpy(ds.ids).to(dev).long().view(2, SCAN_K, BATCH, -1)
    labels = torch.from_numpy(ds.labels).to(dev).view(2, SCAN_K, BATCH)
    chunks = [(ids[c], labels[c], torch.ones(SCAN_K, BATCH, device=dev)) for c in range(2)]
    del ds
    replays = 20
    step_phases = ["lookup", "tower", "sparse", "dense"]

    # (a) captured with tracing off
    prof.enable(False)
    stamp_k.LAUNCHES = 0
    state_off, scan_off = _tracing_case(dev, schema, chunks, SEED + 25)
    _timed_replays(scan_off, state_off, chunks, 3)
    if stamp_k.LAUNCHES != 0 or scan_off.graph[0].ring is not None:
        raise AssertionError(f"tracing: a graph captured with tracing off launched "
                             f"{stamp_k.LAUNCHES} stamps")
    print("tracing: a graph captured with tracing off: 4 replays, 0 stamps launched")

    # (b) captured with tracing on
    prof.enable(True)
    prof.drain()
    stamp_k.LAUNCHES = 0
    state_on, scan_on = _tracing_case(dev, schema, chunks, SEED + 25)
    graph = scan_on.graph[0]
    event_ms = _timed_replays(scan_on, state_on, chunks, replays)
    out = prof.drain()
    (reading,) = [r for r in out["phases"] if r.graph == graph.ring.id]
    want = [prof.START] + step_phases * SCAN_K
    if reading.names != want or reading.lost or len(reading.stamps) != 1 + replays:
        raise AssertionError(f"tracing: the ring holds {reading.names} over "
                             f"{len(reading.stamps)} replays ({reading.lost} lost)")
    if stamp_k.LAUNCHES != len(want) * (1 + replays):
        raise AssertionError(f"tracing: {stamp_k.LAUNCHES} stamps launched, not "
                             f"{len(want)} a replay")
    # the kernel against its plain version on a CPU buffer of the same shape
    ring = graph.ring
    on_card = ring.buf.cpu()
    plain = torch.zeros_like(on_card)
    clock = 0
    for _ in range(1 + replays):
        for slot in range(len(want)):
            clock += 1
            stamp_k.phase_stamp_plain(plain, slot, clock)
    written = on_card != 0
    rows = on_card[:ring.replays][written[:ring.replays].any(dim=1)][:, :len(want)]
    rising = bool((rows.diff(dim=1) > 0).all())
    print(f"tracing: the stamp kernel against phase_stamp_plain: replays counted "
          f"{int(on_card[ring.replays, 0])} and {int(plain[ring.replays, 0])}, "
          f"{int(written.sum())} and {int((plain != 0).sum())} cells written "
          f"({'the same' if torch.equal(written, plain != 0) else 'not the same'}), "
          f"stamps rising along each of {len(rows)} rows: {rising}")
    if (on_card[ring.replays, 0] != plain[ring.replays, 0]
            or not torch.equal(written, plain != 0) or not rising):
        raise AssertionError("tracing: the stamp kernel's ring is not its plain version's")
    stamps = reading.stamps[1:]
    phase_ms = [(row[-1] - row[0]) / 1e6 for row in stamps]
    worst = max(abs(p - e) / e for p, e in zip(phase_ms, event_ms))
    share = abs(sum(phase_ms) - sum(event_ms)) / sum(event_ms)
    steps = replays * SCAN_K
    by_phase = prof.reading_ms(reading._replace(stamps=stamps))
    print(f"tracing: {len(want)} stamps a replay; over {replays} replays the phases "
          f"sum to {sum(phase_ms):.4f} ms against {sum(event_ms):.4f} ms of CUDA events "
          f"({100 * share:.2f}% apart, the worst replay {100 * worst:.2f}%); device ms a "
          f"step by phase: " + ", ".join(f"{k} {v / steps:.4f}" for k, v in by_phase.items()))
    if share > 0.02:
        raise AssertionError("tracing: the phases do not sum to the replays' time")
    diffs = np.diff(reading.stamps, axis=1).ravel()
    quantum = int(np.gcd.reduce(np.concatenate([diffs, np.diff(reading.stamps[:, 0])])))
    print(f"tracing: %globaltimer's smallest nonzero step between stamps "
          f"{int(diffs[diffs > 0].min())} ns, every stamp a multiple of {quantum} ns "
          f"apart; the shortest phase {int(diffs.min())} ns")
    chunk_spans = [s for s in out["spans"] if s.name == "chunk"]
    numbers = [s.attrs["replay"] for s in chunk_spans]
    inside = collections.Counter(s.name for s in out["spans"]
                                 if s.unit in {c.id for c in chunk_spans} and s.name != "chunk")
    if numbers != list(range(1 + replays)):
        raise AssertionError(f"tracing: chunk spans numbered {numbers}")
    print(f"tracing: {len(chunk_spans)} chunk spans, numbered as the ring's rows; "
          f"inside them {dict(inside)}; capture spans "
          f"{[s.name for s in out['spans'] if s.name.startswith('graph.')]}")

    # (c) the stamps' cost: replays of the two graphs in turns
    turns = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        scan, state = (scan_off, state_off) if which == "off" else (scan_on, state_on)
        turns[which] += _timed_replays(scan, state, chunks, replays)
    prof.drain()
    off_ms = float(np.median(turns["off"]))
    on_ms = float(np.median(turns["on"]))
    print(f"tracing: a replay of {SCAN_K} steps {off_ms:.4f} ms captured without stamps, "
          f"{on_ms:.4f} ms with {len(want)} (median of {2 * replays} each, in turns): "
          f"the stamps' share {100 * (on_ms - off_ms) / off_ms:.2f}%")

    # (d) the host clock: a span against its record_function under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        scan_on(state_on, *chunks[0])
        torch.cuda.synchronize()
    spans = {s.name: s for s in prof.drain()["spans"]}
    events = {e.name(): e for e in p.profiler.kineto_results.events()
              if e.is_user_annotation()
              and e.device_type() != torch.autograd.DeviceType.CUDA}   # the host's
    gaps = {n: spans[n].start_ns - events[n].start_ns() for n in spans if n in events}
    wall = time.time_ns() - events["chunk"].start_ns()
    print(f"tracing: span start minus its record_function's kineto start (ns): {gaps}; "
          f"time.time_ns() {wall / 1e6:.1f} ms after the chunk's kineto start")
    if not gaps or max(abs(g) for g in gaps.values()) > 100_000:
        raise AssertionError("tracing: the spans are not on the profiler's clock")
    del scan_off, state_off, scan_on, state_on, graph

    # (e) the sharded graph in a world of one NCCL rank
    with par.process_group(dev) as group:
        model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=FNN_HIDDEN, activation="tanh",
                                                 dropout=DROPOUT), device=dev)
        sopt, dopt = SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)
        sst = par.sharded_state_from_state(
            init_state(model, schema, sopt, dopt, seed=SEED + 25, table_dtype="bf16"), group)
        scan = par.make_sharded_scan_train_step(schema, sopt, dopt, group)
        scan(sst, *chunks[0])
        event_ms = _timed_replays(scan, sst, chunks, 5)
        ring = scan.graph[0].ring
        (reading,) = [r for r in prof.drain()["phases"] if r.graph == ring.id]
        scan.graph.clear()
        del scan, sst
    prof.enable(False)
    want = [prof.START] + ["lookup", "tower", "dense", "grads", "sparse"] * SCAN_K
    phase_ms = [(row[-1] - row[0]) / 1e6 for row in reading.stamps[1:]]
    by_phase = prof.reading_ms(reading._replace(stamps=reading.stamps[1:]))
    print(f"tracing: sharded, a world of one: {len(reading.names)} stamps a replay; "
          f"phases {sum(phase_ms):.4f} ms against {sum(event_ms):.4f} ms of CUDA events "
          f"over 5 replays; device ms a step by phase: "
          + ", ".join(f"{k} {v / (5 * SCAN_K):.4f}" for k, v in by_phase.items()))
    if reading.names != want or not math.isclose(sum(phase_ms), sum(event_ms), rel_tol=0.02):
        raise AssertionError(f"tracing: the sharded ring holds {reading.names}")
    print(f"tracing: {time.perf_counter() - t_phase:.1f} s")
    return {"stamp_share": (on_ms - off_ms) / off_ms, "sum_share": share}


# phase 26: ids as the benchmark's iPinYou cell draws them (each field's
# values Zipf(1.05) over a seeded permutation of its vocabulary, a
# multi-slot field's later slots filled with probability 0.6, else pad) and
# occurrence gradients N(0, SPARSE_SIGMA), 0 on pad slots as the models make
# them; three batches, the kernel against the plain version after each
SPARSE_ALPHA = 1.05
SPARSE_SIGMA = 1e-3
SPARSE_UPDATES = 3


def _zipf_ids(schema, batch, gen, dev, filled=False):
    """int64 ``[batch, S]`` ids of ``schema``'s fields, Zipf(SPARSE_ALPHA),
    each field's ranks permuted; a field of several slots holds 1 +
    Binomial(slots - 1, 0.6) ids and pad ids after them, or ids in every
    slot where ``filled`` (MLPerf's multi-hot data)."""
    import torch

    cols = []
    for f, off in zip(schema.fields, schema.offsets):
        p = torch.arange(1, f.vocab_size + 1, dtype=torch.float64, device=dev) ** -SPARSE_ALPHA
        cdf = torch.cumsum(p, 0)
        cdf = cdf / cdf[-1]
        perm = torch.randperm(f.vocab_size, generator=gen, device=dev)
        count = f.max_len if filled else 1 + (
            torch.rand((batch, f.max_len - 1), generator=gen, device=dev) < 0.6).sum(1)
        for j in range(f.max_len):
            u = torch.rand(batch, generator=gen, device=dev, dtype=torch.float64)
            gid = perm[torch.searchsorted(cdf, u).clamp_(max=f.vocab_size - 1)] + int(off)
            cols.append(gid if j == 0 or filled else torch.where(count > j, gid, schema.pad_id))
    return torch.stack(cols, 1)


def _same_bits(a, b) -> bool:
    import torch

    kind = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(kind), b.view(kind))


def _sparse_clean(ws) -> bool:
    """The dense-mode update's workspace as each call leaves it: the owner
    slots INT_MAX; the counts, the split rows' sums and finished chunks, and
    the scratch's counts (elect blocks done, owners, occurrences placed,
    rows split, later chunks, reduce blocks done) 0."""
    return (bool((ws.owner == 2**31 - 1).all()) and not bool(ws.counts.any())
            and not bool(ws.split_sums.any()) and not bool(ws.split_done.any())
            and not bool(ws.scratch[1:4].any()))


def _split_rows(ids, v, d) -> int:
    """The rows of ``ids`` in [0, V) with more occurrences than the kernel's
    chunk at width ``d``: what ``sparse.ROWS_SPLIT`` adds for the batch."""
    import torch

    from deepctr_torch.ops.kernels import sparse as sparse_k

    _, counts = torch.unique(ids[ids < v], return_counts=True)
    return int((counts > sparse_k.chunk(ids.shape[0], d, ids.device)).sum())


def _phase26_sparse_adagrad(dev, rng=None) -> dict:
    """The dense-mode sparse Adagrad kernel (``ops/kernels/sparse.py``,
    ``csrc/sparse_adagrad.cu``) at iPinYou's shape: a 927,658 x 11 table in
    bf16 and in f32 with its f32 accumulator, ``SPARSE_UPDATES`` batches of
    8192 x 18 Zipf ids. For each dtype: (a) table and accumulator equal to
    ``adagrad_dense_plain``'s bit for bit after the first update and after
    the third (the workspace comes back clean: ``_sparse_clean``); (b) the
    rows no id touched keep their bits; (c) the same
    three updates run again from the same state, bit for bit; (d) one
    eager update, then the update captured in a CUDA graph and replayed on
    the second and third batches, equal to the eager updates; (e)
    ``LAUNCHES`` one an eager update and one the capture, none a replay,
    ``ROWS_WRITTEN`` the distinct ids of each batch and ``ROWS_SPLIT`` its
    rows of more than a chunk, replays included; (f) the kernel's ms (CUDA
    events, in turns with the plain version) beside its byte bound: ids and
    gradient rows read once, each touched row's accumulator and table row
    read and written once; (g) FNN's scan route
    (``_tracing_case``, dense mode): two replays of 8 steps count one launch
    a step and the capture's warm-up step, and rows written on the device by
    every step, the replays' included."""
    import torch

    from deepctr_torch.data import ipinyou_full_schema
    from deepctr_torch.ops.kernels import sparse as sparse_k

    t_phase = time.perf_counter()
    schema = ipinyou_full_schema()
    v, d, lr, eps = schema.padded_vocab_size, 1 + K, 0.05, 1e-6
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    batches = []
    for _ in range(SPARSE_UPDATES):
        ids = _zipf_ids(schema, BATCH, gen, dev).reshape(-1)
        rows = torch.randn(ids.shape[0], d, generator=gen, device=dev) * SPARSE_SIGMA
        rows[ids == schema.pad_id] = 0.0
        batches.append((ids, rows))
    table0 = torch.randn(v, d, generator=gen, device=dev) * 0.01
    table0[schema.pad_id] = 0.0
    touched = [torch.unique(ids) for ids, _ in batches]
    every = torch.unique(torch.cat(touched))
    untouched = torch.ones(v, dtype=torch.bool, device=dev)
    untouched[every] = False
    out = {"touched": [int(t.numel()) for t in touched], "occurrences": int(batches[0][0].numel()),
           "split": [_split_rows(ids, v, d) for ids, _ in batches]}
    print(f"sparse adagrad: table {v} x {d}, {out['occurrences']} occurrences a batch; "
          f"distinct ids {out['touched']} ({100 * out['touched'][0] / v:.2f}% of the rows "
          f"the first); {int(every.numel())} rows touched by the {SPARSE_UPDATES} batches; "
          f"rows of more than a chunk of {sparse_k.chunk(out['occurrences'], d, dev)} "
          f"{out['split']}")

    def fresh(dtype):
        return table0.to(dtype), torch.zeros(v, d, device=dev)

    def run(fn, table, acc, which):
        for i in which:
            fn(table, acc, *batches[i], lr, eps)
        torch.cuda.synchronize()
        return table, acc

    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        plain = fresh(dtype)
        kern = fresh(dtype)
        launches, written = sparse_k.LAUNCHES, sparse_k.rows_written(dev)
        split = sparse_k.rows_split(dev)
        run(sparse_k.adagrad_dense_plain, *plain, [0])
        run(sparse_k.adagrad_dense_update, *kern, [0])
        first = [_same_bits(a, b) for a, b in zip(kern, plain)]
        run(sparse_k.adagrad_dense_plain, *plain, range(1, SPARSE_UPDATES))
        run(sparse_k.adagrad_dense_update, *kern, range(1, SPARSE_UPDATES))
        third = [_same_bits(a, b) for a, b in zip(kern, plain)]
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(kern, plain))
        out["max_abs_err"] = max(out.get("max_abs_err", 0.0), err)
        clean = _sparse_clean(sparse_k._WORKSPACES[id(kern[1])])
        kept = _same_bits(kern[0][untouched], table0.to(dtype)[untouched])
        counted = (sparse_k.LAUNCHES - launches, sparse_k.rows_written(dev) - written,
                   sparse_k.rows_split(dev) - split)
        again = run(sparse_k.adagrad_dense_update, *fresh(dtype), range(SPARSE_UPDATES))
        repeat = [_same_bits(a, b) for a, b in zip(again, kern)]
        print(f"sparse adagrad {name}: kernel vs plain bit for bit after 1 update "
              f"(table, acc) {first}, after {SPARSE_UPDATES} {third} (max |kernel - "
              f"plain| {err}); workspace clean "
              f"{clean}; untouched rows kept {kept}; a second run bit for bit {repeat}; "
              f"launches {counted[0]}, rows written {counted[1]}, rows split {counted[2]} "
              f"(predicted {SPARSE_UPDATES}, {sum(out['touched'])} and {sum(out['split'])})")
        if not (all(first) and all(third) and clean and kept and all(repeat)):
            raise AssertionError(f"sparse adagrad {name}: the kernel's bits")
        if counted != (SPARSE_UPDATES, sum(out["touched"]), sum(out["split"])):
            raise AssertionError(f"sparse adagrad {name}: counted {counted}")

        # (d) under a CUDA graph: one eager update makes the workspace
        table, acc = fresh(dtype)
        static_ids, static_rows = batches[0][0].clone(), batches[0][1].clone()
        launches, written = sparse_k.LAUNCHES, sparse_k.rows_written(dev)
        split = sparse_k.rows_split(dev)
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            sparse_k.adagrad_dense_update(table, acc, static_ids, static_rows, lr, eps)
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            sparse_k.adagrad_dense_update(table, acc, static_ids, static_rows, lr, eps)
        for ids, rows in batches[1:]:
            static_ids.copy_(ids)
            static_rows.copy_(rows)
            graph.replay()
        torch.cuda.synchronize()
        replayed = [_same_bits(a, b) for a, b in zip((table, acc), kern)]
        counted = (sparse_k.LAUNCHES - launches, sparse_k.rows_written(dev) - written,
                   sparse_k.rows_split(dev) - split)
        print(f"sparse adagrad {name}: an eager update and {SPARSE_UPDATES - 1} graph "
              f"replays against eager updates, bit for bit {replayed}; launches "
              f"{counted[0]}, rows written {counted[1]}, rows split {counted[2]} (predicted "
              f"2, {sum(out['touched'])} and {sum(out['split'])})")
        if not all(replayed) or counted != (2, sum(out["touched"]), sum(out["split"])):
            raise AssertionError(f"sparse adagrad {name}: the graph's update")
        del graph
        out[f"equal_{name}"] = True

        # (f) the kernel and the plain version in turns, on the first batch
        ids, rows = batches[0]
        times = _in_turns({
            "kernel": lambda: sparse_k.adagrad_dense_update(*kern, ids, rows, lr, eps),
            "plain": lambda: sparse_k.adagrad_dense_plain(*plain, ids, rows, lr, eps)})
        elem = table0.to(dtype).element_size()
        nbytes = ids.numel() * 8 + rows.numel() * 4 + out["touched"][0] * d * 2 * (4 + elem)
        bound = _bound(0, nbytes)
        out[f"ms_{name}"], out[f"plain_ms_{name}"] = times["kernel"], times["plain"]
        out[f"bound_ms_{name}"], out[f"bytes_{name}"] = bound["bound_ms"], nbytes
        print(f"sparse adagrad {name}: kernel {times['kernel']:.4f} ms, plain "
              f"{times['plain']:.4f} ms a call (CUDA events, in turns); bound "
              f"{bound['bound_ms']:.4f} ms ({nbytes:,} B at 3.35 TB/s), "
              f"{100 * bound['bound_ms'] / times['kernel']:.1f}% of it; rows split "
              f"{out['split'][0]} a call")

    # (g) the scan route: one warm-up step, then each replay adds its 8
    chunk_ids = _zipf_ids(schema, 2 * SCAN_K * BATCH, gen, dev).view(2, SCAN_K, BATCH, -1)
    chunks = [(chunk_ids[c], torch.zeros(SCAN_K, BATCH, device=dev),
               torch.ones(SCAN_K, BATCH, device=dev)) for c in range(2)]
    sparse_k.LAUNCHES, written = 0, sparse_k.rows_written(dev)
    state, scan = _tracing_case(dev, schema, chunks, SEED + 26)
    scan(state, *chunks[1])
    torch.cuda.synchronize()
    counted = (sparse_k.LAUNCHES, sparse_k.rows_written(dev) - written)
    want = (1 + 2 * SCAN_K, sum(int(torch.unique(chunk_ids[c, i]).numel())
                                for c in range(2) for i in range(SCAN_K))
            + int(torch.unique(chunk_ids[0, 0]).numel()))
    print(f"sparse adagrad: the scan route's two replays of {SCAN_K} steps, launches "
          f"{counted[0]}, rows written {counted[1]} (predicted {want[0]} and {want[1]}: "
          f"the capture's warm-up step and each step)")
    if counted != want:
        raise AssertionError(f"sparse adagrad: the scan route counted {counted}")
    out["launches_scan"], out["rows_written_scan"] = counted
    del state, scan
    print(f"sparse adagrad: {time.perf_counter() - t_phase:.1f} s")
    return out


DLRM_ROWS_CAP = 100_000     # phase 27 (c): the graph check's tables, capped
DLRM_CLI_CAP = 1_000_000    # phase 27 (b): the CLI run's tables, capped (the config's)


def _dlrm_slice_ids(schema, batch, gen, dev):
    """``[batch, S]`` ids of ``schema``, every slot filled, log-uniform over
    each field's rows."""
    import torch

    cols = []
    for f, off in zip(schema.fields, schema.offsets):
        u = torch.rand((batch, f.max_len), generator=gen, device=dev, dtype=torch.float64)
        rank = torch.floor((f.vocab_size + 1.0) ** u).long() - 1
        cols.append(rank.clamp_(max=f.vocab_size - 1) + int(off))
    return torch.cat(cols, 1)


def _phase27_dlrm(dev, root, rng=None) -> dict:
    """DLRM-DCNv2 (``models/dlrm.py``) at MLPerf's widths. (a) The dense-mode
    sparse Adagrad kernel at the benchmark cell's scale: the table of one
    GPU's share (26,500,128 x 128 f32, 13.6 GB, and its accumulator), three
    batches of 8192 x 214 ids drawn as the cell draws them (Zipf(1.05) in
    each table, ranks permuted, every slot filled: M = 1,753,088
    occurrences, 224 M gradient elements), table and accumulator bit for
    bit against ``adagrad_dense_plain`` (run on the touched rows alone,
    which gives the same bits: a row's update reads its own sums and the
    scale, which depends on M, D and the largest gradient), every untouched
    row kept, the workspace clean and the rows written and split as
    predicted; then the update's device ms (CUDA events over 10 calls on
    the first batch) beside its byte bound (ids and gradient rows read once,
    each distinct row's accumulator and table row read and written once),
    and the rows it split a call. (b) The CLI's
    loop (``configs/dlrm_dcnv2_criteo.json``: tables capped at 1,000,000
    rows, batch 8192, chunks of 8 on the graph route) for 3 chunks: losses
    finite. (c) One replay of the 8-step graph, the dense features staged
    with the ids, against 8 eager steps from one state, bit for bit (tables
    capped at 100,000 rows), and the step's device ms by phase from the
    graph's stamps. Each part counts the dense-mode kernel's launches from 0
    (``sparse.LAUNCHES``) and requires the predicted count: one an update,
    a step or a capture's warm-up step, graph replays included; their sum
    is ``launches`` in the result."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig
    from deepctr_torch.data import FieldSpec, Schema, synthetic_dlrm
    from deepctr_torch.ops.kernels import sparse as sparse_k
    from deepctr_torch.train import init_state, make_scan_train_step, make_train_step
    from deepctr_torch.train.step import _state_tensors
    from deepctr_torch.utils import prof

    t_phase = time.perf_counter()
    out = {}
    # (a) the update at the cell's scale
    rows_cap = [(r + 7) // 8 if r > 1_000_000 else r for r in synthetic_dlrm.MLPERF_ROWS]
    schema = Schema(tuple(
        FieldSpec(f"C{i + 1}", r, h)
        for i, (r, h) in enumerate(zip(rows_cap, synthetic_dlrm.MLPERF_HOTNESS))))
    v, d, lr, eps = schema.padded_vocab_size, 128, 0.004, 1e-8
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    block = 1 << 22

    def initial(start):   # rows [start, start + block) of the initial table
        gen_b = torch.Generator(device=dev).manual_seed(SEED + 27 + start)
        rows = torch.randn(min(block, v - start), d, generator=gen_b, device=dev) * 1e-3
        if start <= schema.pad_id < start + block:
            rows[schema.pad_id - start] = 0.0
        return rows

    table = torch.empty(v, d, device=dev)
    for start in range(0, v, block):
        table[start:start + block] = initial(start)
    acc = torch.zeros(v, d, device=dev)
    batches = []
    for _ in range(3):
        ids = _zipf_ids(schema, BATCH, gen, dev, filled=True).reshape(-1)
        batches.append((ids, torch.randn(ids.shape[0], d, generator=gen, device=dev) * 1e-5))
    m = batches[0][0].numel()
    every = torch.unique(torch.cat([b[0] for b in batches]))
    p_table, p_acc = table[every].clone(), torch.zeros(every.numel(), d, device=dev)
    split_want = [_split_rows(b[0], v, d) for b in batches]
    written, split = sparse_k.rows_written(dev), sparse_k.rows_split(dev)
    sparse_k.LAUNCHES = 0
    t0 = time.perf_counter()
    for ids, rows in batches:
        sparse_k.adagrad_dense_update(table, acc, ids, rows, lr, eps)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {"a": sparse_k.LAUNCHES}
    for ids, rows in batches:
        sparse_k.adagrad_dense_plain(p_table, p_acc, torch.searchsorted(every, ids), rows,
                                     lr, eps)
    equal = _same_bits(table[every], p_table) and _same_bits(acc[every], p_acc)
    untouched = torch.ones(v, dtype=torch.bool, device=dev)
    untouched[every] = False
    kept = True
    for start in range(0, v, block):
        here = untouched[start:start + block]
        kept &= _same_bits(table[start:start + block][here], initial(start)[here])
        kept &= not bool(acc[start:start + block][here].any())
    ws = sparse_k._WORKSPACES[id(acc)]
    clean = _sparse_clean(ws)
    counted = (sparse_k.rows_written(dev) - written, sparse_k.rows_split(dev) - split)
    distinct = [int(torch.unique(b[0]).numel()) for b in batches]
    ws_bytes = sum(t.numel() * t.element_size()
                   for t in (ws.counts, ws.lists, ws.split_sums, ws.split_done))
    print(f"dlrm sparse adagrad: table {v:,} x {d} f32 ({table.numel() * 4 / 1e9:.2f} GB, "
          f"{table.numel():,} elements), {m:,} occurrences a batch ({m * d:,} gradient "
          f"elements), distinct ids {distinct}: "
          f"kernel vs plain on the touched rows bit for bit after 3 updates {equal}; "
          f"untouched rows and their accumulator kept {kept}; workspace clean {clean} "
          f"({ws_bytes / 1e6:.1f} MB for M; split sums {tuple(ws.split_sums.shape)} int64); "
          f"rows written {counted[0]} (predicted {sum(distinct)}), rows split {counted[1]} "
          f"(predicted {split_want}, chunk {sparse_k.chunk(m, d, dev)}); launches {launches['a']} "
          f"(predicted 3); 3 updates {kernel_s * 1e3:.1f} ms eager")
    if not (equal and kept and clean and counted == (sum(distinct), sum(split_want))
            and launches["a"] == 3):
        raise AssertionError("dlrm sparse adagrad: the kernel at the cell's scale")
    ids, rows = batches[0]
    split = sparse_k.rows_split(dev)
    ms = _time_ms(lambda: sparse_k.adagrad_dense_update(table, acc, ids, rows, lr, eps),
                  iters=10, warmup=2)
    split_a_call = (sparse_k.rows_split(dev) - split) / 12
    nbytes = m * 8 + m * d * 4 + distinct[0] * d * 2 * (4 + 4)
    bound = _bound(0, nbytes)
    print(f"dlrm sparse adagrad: {ms:.4f} ms a call (CUDA events, 10 calls on the first "
          f"batch); bound {bound['bound_ms']:.4f} ms ({nbytes:,} B at 3.35 TB/s), "
          f"{100 * bound['bound_ms'] / ms:.1f}% of it; rows split {split_a_call:g} a call "
          f"(predicted {split_want[0]})")
    if split_a_call != split_want[0] or split_want[0] == 0:
        raise AssertionError(f"dlrm sparse adagrad: {split_a_call} rows split a call")
    out.update(occurrences=m, rows_touched=sum(distinct), equal=equal, update_ms=ms,
               update_bound_ms=bound["bound_ms"], rows_split=split_want[0])
    del table, acc, p_table, p_acc, batches, every, untouched, ws, ids, rows
    sparse_k._WORKSPACES.clear()
    torch.cuda.empty_cache()

    # (b) the CLI's loop at full widths
    cfg = RunConfig.load(os.path.join(root, "configs", "dlrm_dcnv2_criteo.json"))
    cfg = cfg.apply_overrides([f"data.criteo_cat_buckets={DLRM_CLI_CAP}",
                               f"data.synthetic_examples={3 * SCAN_K * BATCH * 100 // 85 + 1}",
                               "train.epochs=1"])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    sparse_k.LAUNCHES = 0
    res = cli.run(cfg, dev)
    launches["b"] = sparse_k.LAUNCHES
    rec = res["history"][0]
    print(f"dlrm cli: {res['state'].step} steps of {BATCH} at MLPerf's widths, tables "
          f"capped at {DLRM_CLI_CAP:,} rows ({res['state'].model.table.shape[0]:,} rows): "
          f"train loss {rec['train_loss']:.5f}, held-out AUC {rec['auc']:.4f}, "
          f"{rec['examples_per_s']:,.0f} examples/s (the first chunk captures), "
          f"{time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; dense-mode updates "
          f"launched {launches['b']} (predicted {res['state'].step + 1}: the capture's "
          f"warm-up step and each step)")
    if not all(np.isfinite(r["train_loss"]) for r in res["history"]):
        raise AssertionError(f"dlrm cli: a loss is not finite: {res['history']}")
    if launches["b"] != res["state"].step + 1:
        raise AssertionError(f"dlrm cli: {launches['b']} dense-mode updates launched")
    out["cli_examples_per_s"] = rec["examples_per_s"]
    del res
    torch.cuda.empty_cache()

    # (c) a replay against eager steps, and the phases
    small = synthetic_dlrm.mlperf_dlrm_schema(DLRM_ROWS_CAP)
    cfg = RunConfig.load(os.path.join(root, "configs", "dlrm_dcnv2_criteo.json"))
    sopt, dopt = cli.build_optimizers(cfg)

    def fresh():
        return init_state(cli.build_model(cfg, small, dev), small, sopt, dopt, seed=SEED)

    gen = torch.Generator(device=dev).manual_seed(SEED + 270)
    chunk = (_dlrm_slice_ids(small, SCAN_K * BATCH, gen, dev).view(SCAN_K, BATCH, -1),
             (torch.rand(SCAN_K, BATCH, generator=gen, device=dev) < 0.03).float(),
             torch.ones(SCAN_K, BATCH, device=dev))
    dense = torch.floor(torch.exp(torch.randn(SCAN_K, BATCH, 13, generator=gen, device=dev)
                                  * 1.5 + 1.0))
    g, e = fresh(), fresh()
    sparse_k.LAUNCHES = 0
    prof.enable(True)
    try:
        scan = make_scan_train_step(small, sopt, dopt)
        g, g_losses = scan(g, *chunk, dense=dense)
        prof.drain()
        for _ in range(5):
            scan(g, *chunk, dense=dense)
        torch.cuda.synchronize()
        reading = [r for r in prof.drain()["phases"] if len(r.stamps)]
        ms = {k: v / (5 * SCAN_K) for k, v in prof.reading_ms(reading[0]).items()}
    finally:
        prof.enable(False)
        prof.drain()
    step = make_train_step(small, sopt, dopt)
    e_losses = torch.stack([step(e, *(t[i] for t in chunk), dense=dense[i])[1].loss
                            for i in range(SCAN_K)])
    g2 = fresh()
    scan2 = make_scan_train_step(small, sopt, dopt)
    g2, g2_losses = scan2(g2, *chunk, dense=dense)
    launches["c"] = sparse_k.LAUNCHES
    same = (torch.equal(g2_losses, e_losses) and g2.step == e.step
            and all(torch.equal(a, b) for a, b in zip(_state_tensors(g2), _state_tensors(e))))
    print(f"dlrm scan: one replay of an {SCAN_K}-step graph (dense features staged) vs "
          f"{SCAN_K} eager steps from one state at MLPerf's widths, tables capped at "
          f"{DLRM_ROWS_CAP:,}: losses and every state tensor bit-identical: {same}; "
          f"losses {[round(float(x), 5) for x in e_losses]}; dense-mode updates launched "
          f"{launches['c']} (predicted {2 + 8 * SCAN_K}: two graphs' warm-up steps, "
          f"{6 * SCAN_K} steps in 6 replays of the first, {SCAN_K} of the second and "
          f"{SCAN_K} eager)")
    print(f"dlrm scan: device ms a step by phase over 5 replays of {SCAN_K} steps "
          f"(stamps): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; total {sum(ms.values()):.3f}")
    if not same:
        raise AssertionError("dlrm scan: the graph replay differs from eager steps")
    if launches["c"] != 2 + 8 * SCAN_K:
        raise AssertionError(f"dlrm scan: {launches['c']} dense-mode updates launched")
    if list(ms) != ["lookup", "pool", "bottom", "cross", "top", "backward", "sparse",
                    "dense"]:
        raise AssertionError(f"dlrm scan: phases {list(ms)}")
    out["phase_ms"] = ms
    out["launches"] = sum(launches.values())
    print(f"dlrm: {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 28: the products of a DLRM step the dense kernel takes, (form, m, n,
# k): count a step ("gx" g [B, out] . w [in, out]^T, "gw" x [B, in]^T . g
# [B, out]); the kernel's error over cuBLAS f32's against float64 at most
DENSE_PRODUCTS = {
    ("gx", BATCH, 512, 256): 2, ("gx", BATCH, 256, 128): 1, ("gx", BATCH, 3456, 512): 3,
    ("gx", BATCH, 512, 3456): 3, ("gx", BATCH, 3456, 1024): 1, ("gx", BATCH, 1024, 1024): 1,
    ("gx", BATCH, 1024, 512): 1,
    ("gw", 512, 256, BATCH): 2, ("gw", 256, 128, BATCH): 1, ("gw", 3456, 512, BATCH): 3,
    ("gw", 512, 3456, BATCH): 3, ("gw", 3456, 1024, BATCH): 1, ("gw", 1024, 1024, BATCH): 1,
    ("gw", 1024, 512, BATCH): 1,
}
DENSE_F32_MULTIPLE = 2.0


def _phase28_dense_bwd(dev, rng=None) -> dict:
    """The dense layers' backward kernel at the shapes of DLRM's step, then
    the graph route's repeatability and counts (docstring, phase 28)."""
    import math

    import torch

    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig
    from deepctr_torch.data import synthetic_dlrm
    from deepctr_torch.ops.kernels import dense as dense_k
    from deepctr_torch.train import init_state, make_scan_train_step
    from deepctr_torch.train.step import _state_tensors

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    rows, worst, total = [], 0.0, {"kernel": 0.0, "cublas": 0.0, "bound": 0.0}
    for (form, m, n, k), count in DENSE_PRODUCTS.items():
        if form == "gx":   # g [B, out], w [in, out]
            a = torch.randn(m, k, generator=gen, device=dev) * 1e-4
            b = torch.randn(n, k, generator=gen, device=dev) * math.sqrt(2.0 / (n + k))
            fn, library = dense_k.input_grad, dense_k.input_grad_plain
            want = a.double() @ b.double().t()
        else:              # x [B, in] (ReLU'd), g [B, out]
            a = torch.relu(torch.randn(k, m, generator=gen, device=dev))
            b = torch.randn(k, n, generator=gen, device=dev) * 1e-4
            fn, library = dense_k.weight_grad, dense_k.weight_grad_plain
            want = a.double().t() @ b.double()
        got, again, lib = fn(a, b), fn(a, b), library(a, b)
        norm = want.norm()
        err = float((got.double() - want).norm() / norm)
        lib_err = float((lib.double() - want).norm() / norm)
        same = torch.equal(got, again)
        ms, lib_ms = _time_ms(lambda: fn(a, b)), _time_ms(lambda: library(a, b))
        flop = 2.0 * m * n * k
        bound_ms = flop / (TF32_FLOPS / 3) * 1e3
        s = dense_k.slices(m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"dense bwd {form} [{m}, {n}] over {k} (x{count} a step, {s} slices): kernel "
              f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the "
              f"3xTF32 bound {bound_ms:.4f}), cuBLAS f32 {lib_ms:.4f} ms; error against "
              f"float64 {err:.3e} (cuBLAS f32 {lib_err:.3e}); the same bits twice {same}")
        rows.append({"form": form, "m": m, "n": n, "k": k, "count": count, "slices": s,
                     "ms": ms, "cublas_ms": lib_ms, "bound_ms": bound_ms, "err": err,
                     "cublas_err": lib_err})
        total["kernel"] += count * ms
        total["cublas"] += count * lib_ms
        total["bound"] += count * bound_ms
        worst = max(worst, err / lib_err)
        if not same or err > DENSE_F32_MULTIPLE * lib_err:
            raise AssertionError(f"dense bwd {form} [{m}, {n}] over {k}: error {err:.3e} "
                                 f"against cuBLAS f32's {lib_err:.3e}, same bits {same}")
        del a, b, want, got, again, lib
    # the three products the shape rule leaves to cuBLAS: the bottom's first
    # weight gradient and both of the top's last layer
    lib_ms = {}
    for what, (x_shape, g_shape, fn) in {
            "gw [13, 512] over 8192": ((BATCH, 13), (BATCH, 512), dense_k.weight_grad_plain),
            "gx [8192, 256] over 1": ((BATCH, 1), (256, 1), dense_k.input_grad_plain),
            "gw [256, 1] over 8192": ((BATCH, 256), (BATCH, 1), dense_k.weight_grad_plain)}.items():
        a = torch.randn(*x_shape, generator=gen, device=dev)
        b = torch.randn(*g_shape, generator=gen, device=dev)
        lib_ms[what] = _time_ms(lambda: fn(a, b))
    print("dense bwd: cuBLAS f32 on the shapes the kernel does not take: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in lib_ms.items()))
    print(f"dense bwd: the 24 products of a step {total['kernel']:.3f} ms on the kernel "
          f"against {total['cublas']:.3f} ms on cuBLAS f32 and a 3xTF32 bound of "
          f"{total['bound']:.3f} ms ({100 * total['bound'] / total['kernel']:.1f}% of it); "
          f"the worst error over cuBLAS f32's {worst:.2f} (at most {DENSE_F32_MULTIPLE})")

    # two fresh states through one replay each, and a second replay's counts
    small = synthetic_dlrm.mlperf_dlrm_schema(DLRM_ROWS_CAP)
    cfg = RunConfig.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                      "dlrm_dcnv2_criteo.json"))
    sopt, dopt = cli.build_optimizers(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 280)
    chunk = (_dlrm_slice_ids(small, SCAN_K * BATCH, gen, dev).view(SCAN_K, BATCH, -1),
             (torch.rand(SCAN_K, BATCH, generator=gen, device=dev) < 0.03).float(),
             torch.ones(SCAN_K, BATCH, device=dev))
    dense = torch.floor(torch.exp(torch.randn(SCAN_K, BATCH, 13, generator=gen, device=dev)
                                  * 1.5 + 1.0))
    states = []
    for _ in range(2):
        st = init_state(cli.build_model(cfg, small, dev), small, sopt, dopt, seed=SEED)
        scan = make_scan_train_step(small, sopt, dopt)
        st, _ = scan(st, *chunk, dense=dense)
        launches, library = dense_k.BWD_LAUNCHES, dense_k.BWD_LIBRARY
        st, losses = scan(st, *chunk, dense=dense)
        torch.cuda.synchronize()
        replay = (dense_k.BWD_LAUNCHES - launches, dense_k.BWD_LIBRARY - library)
        states.append(([t.clone() for t in _state_tensors(st)], losses.clone()))
        del st, scan
    same = (torch.equal(states[0][1], states[1][1])
            and all(torch.equal(a, b) for a, b in zip(states[0][0], states[1][0])))
    print(f"dense bwd: two fresh DLRM states (tables capped at {DLRM_ROWS_CAP:,}) through two "
          f"replays each of an {SCAN_K}-step graph: every state tensor and loss bit-identical "
          f"{same}; a replay's kernel products {replay[0]} and cuBLAS products {replay[1]} "
          f"(predicted {24 * SCAN_K} and {3 * SCAN_K})")
    if not same or replay != (24 * SCAN_K, 3 * SCAN_K):
        raise AssertionError("dense bwd: the graph route's repeatability or counts")
    print(f"dense bwd: {time.perf_counter() - t_phase:.1f} s")
    return {"products": rows, "ms_step": total["kernel"], "cublas_ms_step": total["cublas"],
            "bound_ms_step": total["bound"], "worst_err_ratio": worst, "library_ms": lib_ms,
            "launches_replay": replay[0], "library_replay": replay[1]}


def _template_args(mangled) -> str:
    """``<64, true>`` for a mangled ``ILi64ELb1EE``; '' for none."""
    if not mangled:
        return ""
    args = [v if k == "i" else ("true" if v == "1" else "false")
            for k, v in re.findall(r"L([ib])(\d+)E", mangled)]
    return f"<{', '.join(args)}>"


def _sass_hmma(lib_path) -> dict:
    """``{kernel: (count of tensor-core instructions, HGMMA or HMMA, one such
    instruction)}`` from ``cuobjdump -sass`` of the built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        entry = re.search(r"\d+((?:tower|fm|dense)_\w+?_kernel)(I(?:L[ib]\d+E)+E)?",
                          part.split()[0])
        if not entry:
            continue
        ops = re.findall(r"(H(?:G)?MMA\.\S+)", part)
        out[entry.group(1) + _template_args(entry.group(2))] = (
            len(ops), ops[0] if ops else "")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one GPU.")
    ap.add_argument("--phases", help="run phases 1-3 (device, build, the tower "
                    "forward) and then only these phases (a comma list of 3, 6, 7, "
                    "25, 26, 27, 28), and print no report")
    args = ap.parse_args(argv)
    phases = None
    if args.phases:
        phases = {int(p) for p in args.phases.split(",")}
        if not phases <= {3, 6, 7, 25, 26, 27, 28}:
            ap.error(f"--phases {args.phases}: the phases alone are 3, 6, 7, 25, 26, "
                     f"27 and 28")

    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: torch.cuda.is_available() is false")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "deepctr_torch", "csrc")):
        _fail("deepctr_torch/csrc not found beside chip_smoke.py: run it "
              "from the root of a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(subprocess.run(["nvidia-smi", "-L"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 2. build
    from deepctr_torch.ops.kernels import _build
    from deepctr_torch.ops.kernels import mlp as mlp_k

    t0 = time.perf_counter()
    lib_path = _build.compile_library()
    _build.load_library()
    print(f"build: {os.path.relpath(lib_path, root)} from "
          f"{os.path.relpath(_build.CSRC_DIR, root)} in "
          f"{time.perf_counter() - t0:.1f} s")
    name = "?"
    with open(lib_path + ".log") as f:
        for line in f:
            if line.startswith("== "):   # the next source's log
                name = line[3:].strip()
            entry = re.search(r"entry function '.*?\d+((?:tower|fm|dense)_\w+?_kernel)"
                              r"(I(?:L[ib]\d+E)+E)?", line)
            if entry:
                name = entry.group(1) + _template_args(entry.group(2))
            elif re.search(r"Used \d+ registers|spill|serialized", line):
                print(f"  ptxas, {name}: {line.strip()}")
    lib = _build.load_library()
    rows, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t()
    lib.mlp_tower_block_shape.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t)]
    lib.mlp_tower_wgrad_smem_bytes.restype = ctypes.c_size_t
    for what, dims in (("FNN 176-200-300-100-1", (176,) + FNN_HIDDEN + (1,)),
                       ("DeepFM 176-200-200-1", (176,) + DEEPFM_HIDDEN + (1,)),
                       ("Criteo 663-512-256-128-1", (CRITEO_IN,) + CRITEO_HIDDEN + (1,))):
        for back, kernel in ((0, "tower_fwd_kernel"), (1, "tower_bwd_rows_kernel")):
            lib.mlp_tower_block_shape(len(dims) - 1, (ctypes.c_int * len(dims))(*dims), back,
                                      ctypes.byref(rows), ctypes.byref(stages),
                                      ctypes.byref(smem))
            print(f"  {kernel}, {what}: {rows.value} rows a block, {stages.value} "
                  f"image slots a ring, {smem.value} B of dynamic shared memory")
    print(f"  tower_wgrad_kernel: {lib.mlp_tower_wgrad_smem_bytes()} B of dynamic "
          f"shared memory")
    hmma = _sass_hmma(lib_path)
    for kernel, (count, example) in sorted(hmma.items()):
        print(f"  cuobjdump -sass, {kernel}: {count} tensor-core instructions"
              + (f" (e.g. {example})" if example else ""))
    for kernel in ("tower_fwd_kernel", "tower_bwd_rows_kernel", "tower_wgrad_kernel",
                   "dense_bwd_kernel"):
        if not any(k.startswith(kernel) and c for k, (c, _) in hmma.items()):
            raise AssertionError(f"{kernel}: no tensor-core instructions in its SASS")
    # the FM scorer stays in full f32 on the CUDA cores
    if "fm_score_kernel" not in hmma or hmma["fm_score_kernel"][0]:
        raise AssertionError(f"fm_score_kernel: {hmma.get('fm_score_kernel')} in its SASS")

    # 3. kernel vs plain on the card; timed at three batch sizes
    rng = np.random.default_rng(SEED)
    tower_times, main_err = _phase3_tower_fwd(dev, rng)
    if phases is not None:
        for phase in sorted(phases - {3}):
            {6: _phase6_training_kernels, 7: _phase7_fm_kernel,
             25: _phase25_tracing, 26: _phase26_sparse_adagrad,
             27: lambda dev, rng: _phase27_dlrm(dev, root),
             28: _phase28_dense_bwd}[phase](dev, rng)
        print(f"chip_smoke: phases 1-3 and {sorted(phases - {3})} only (--phases): "
              f"no report")
        return 0
    kernel_ms, plain_ms = tower_times["fnn tanh"]
    in_dim = 16 * (1 + K)   # ipinyou_full_schema: 16 fields of 1+k
    fnn_dims = (in_dim,) + FNN_HIDDEN + (1,)

    # 4. the slice end to end, through the CLI
    from deepctr_torch import cli
    from deepctr_torch.models import MlpSpec, apply_model, make_fnn
    from deepctr_torch.serving import Scorer
    from deepctr_torch.data import ipinyou_full_schema, synthetic
    from deepctr_torch.utils.checkpoint import save_scoring_params

    schema = ipinyou_full_schema()
    prng = np.random.default_rng(SEED + 1)
    table = prng.normal(0.0, 0.3, (schema.padded_vocab_size, 1 + K)).astype(np.float32)
    table[schema.pad_id] = 0.0
    dims = (schema.num_fields * (1 + K),) + FNN_HIDDEN + (1,)
    assert dims[0] == in_dim
    dense_layers = _np_layers(prng, dims)
    spec = MlpSpec(hidden=FNN_HIDDEN, activation="tanh")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "fnn.ckpt")
        save_scoring_params(ckpt, table, {"mlp": {"layers": dense_layers}},
                            schema=schema, meta={"model": "fnn"})
        t0 = time.perf_counter()
        ds = synthetic.generate(schema, num_examples=REQUESTS, k=K, seed=SEED)
        yx = os.path.join(tmp, "requests.yx")
        synthetic.write_yx_file(ds, yx)
        print(f"requests: {REQUESTS} rows, {os.path.getsize(yx)} bytes of yx, "
              f"made in {time.perf_counter() - t0:.1f} s")

        argv = ["--score", yx, f"train.checkpoint_path={ckpt}", "model.name=fnn",
                f"model.k={K}", "model.hidden=" + ",".join(map(str, FNN_HIDDEN)),
                "model.activation=tanh", f"train.batch_size={BATCH}",
                "--device", "cuda"]
        out = io.StringIO()
        mlp_k.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = mlp_k.LAUNCHES
        if rc != 0:
            raise AssertionError(f"deepctr_torch.cli --score returned {rc}")
        if launches == 0:
            raise AssertionError("the scoring run launched the tower kernel 0 times")
        probs = np.array(out.getvalue().split(), dtype=np.float64)
        if probs.shape != (REQUESTS,):
            raise AssertionError(f"scored {probs.shape} rows, expected {REQUESTS}")
        if not (np.all(np.isfinite(probs)) and probs.min() >= 0 and probs.max() <= 1):
            raise AssertionError("probabilities not finite or outside [0, 1]")
        print(f"cli --score: {probs.size} rows in {cli_s:.2f} s (checkpoint "
              f"load, parse and scoring), {launches} kernel launches, "
              f"probabilities in [{probs.min():.4f}, {probs.max():.4f}]")

        scorer = Scorer.from_checkpoint(
            ckpt, make_fnn(schema, k=K, mlp=spec, device=dev), batch_size=BATCH)
    model = scorer.model

    def plain_forward(ids_dev):
        """The model's gather and pooling, then the plain tower on the card."""
        rows = model.table[ids_dev]
        mask = (ids_dev != schema.pad_id).to(rows.dtype)
        return mlp_k.mlp_tower_plain(model.tower_input(rows, mask),
                                     model.mlp.params(), spec.activation)

    kernel_logits = scorer.logits(ds.ids)
    with torch.inference_mode():
        plain_logits = np.concatenate([
            plain_forward(torch.from_numpy(ds.ids[i:i + BATCH]).to(dev).long())
            .cpu().numpy() for i in range(0, REQUESTS, BATCH)])
    _check_close("slice: kernel scorer vs plain forward logits", kernel_logits,
                 plain_logits)
    _check_close("slice: cli probabilities vs plain forward", probs,
                 1.0 / (1.0 + np.exp(-np.clip(plain_logits, -30, 30))),
                 rtol=0.0, atol=PROB_ATOL)
    n_ref = 512
    _check_close(f"slice: kernel scorer vs float64 numpy forward ({n_ref} rows)",
                 kernel_logits[:n_ref],
                 _numpy_fnn(table, dense_layers, schema, ds.ids[:n_ref]))

    n_batches = REQUESTS // BATCH
    for _ in range(3):
        t0 = time.perf_counter()
        scorer.logits(ds.ids)
        dt = time.perf_counter() - t0
        print(f"scorer: {dt * 1e3 / n_batches:.3f} ms per {BATCH}-row batch "
              f"(host clock: batching, H2D, forward, D2H)")
    ids_dev = torch.from_numpy(ds.ids[:BATCH]).to(dev).long()
    with torch.inference_mode():
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = ((lambda: plain_forward(ids_dev)) if which == "plain" else
                  (lambda: apply_model(model, ids_dev, schema.pad_id)))
            print(f"forward on the card, {which} tower: {_time_ms(fn):.4f} ms "
                  f"per {BATCH}-row batch (gather, pool, tower; CUDA events)")

    # 5. where the scorer's time goes: torch.profiler around one warm call
    _profile_scorer(scorer, ds.ids, n_batches)

    # 6. the training kernels against their plain versions
    train_k = _phase6_training_kernels(dev, rng)

    # 7. the FM scorer kernel against its plain version
    fm_kernel = _phase7_fm_kernel(dev, rng)

    # 8-12. the FM family and SNN through the CLI, at full iPinYou width
    with tempfile.TemporaryDirectory() as tmp:
        schema_path = os.path.join(tmp, "ipinyou_full.json")
        with open(schema_path, "w") as f:
            f.write(schema.to_json())
        fm = _phase8_fm_training(dev, root, tmp, schema, schema_path)
        train = _phase9_fnn_training(dev, root, tmp, schema, schema_path,
                                     fm["fm_table"])
        _phase10_deepfm(dev, root, tmp, schema, schema_path)
        _phase11_lr_ipnn(dev, tmp, schema)
        _phase12_snn(dev, root, tmp, schema, schema_path)
        retrain = _phase13_retrain(dev, root, tmp, schema, schema_path)
        _phase14_quantized_scoring(dev, root, schema, train)
        sharded = _phase15_sharded(dev, root, tmp, schema, schema_path, train,
                                   fm["fm_table"])
        distributed = _phase16_distributed(dev, root, tmp, retrain,
                                           sharded.pop("criteo"))
        _phase17_scan(dev, root, tmp, schema, schema_path)
        sharded_scan = _phase18_sharded_scan(dev, root, tmp, schema_path)
        reproduced = _phase19_reproduce(dev, tmp)
        _phase20_bench(root, tmp, card)
        substrate = _phase21_scaling_and_substrate(dev)
    capacity = _phase22_capacity(dev)
    parity = _phase23_parity(dev)
    with tempfile.TemporaryDirectory() as tmp:
        roofline = _phase24_roofline(root, tmp, card)
    _phase25_tracing(dev)
    sparse = _phase26_sparse_adagrad(dev)
    dlrm = _phase27_dlrm(dev, root)
    dense_bwd = _phase28_dense_bwd(dev)

    work = _tower_work(BATCH, fnn_dims)
    criteo = _tower_work(BATCH, (CRITEO_IN,) + CRITEO_HIDDEN + (1,))
    fm_rows = REQUESTS * 18 * (1 + K)   # the timed fm_score shape [65536, 18, 11]
    fm_bound = _bound(4 * fm_rows, 4 * (fm_rows + REQUESTS * 18 + REQUESTS))
    report = {"kernels": [{
        "name": "mlp_tower_fwd",
        "route": "cuda",
        "source": "deepctr_torch/csrc/mlp_tower_fwd.cu",
        "replaces": "deepctr_tpu/ops/pallas/mlp.py:190",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        **_bound(*work["fwd"]),
        "library_ms": None,
        "launches_distributed": distributed["launches"]["fwd_eval"],
        "launches_sharded_scan": sharded_scan["criteo_launches"]["fwd_eval"],
        "launches_reproduce": reproduced["launches"]["fwd_eval"],
        "launches_substrate": substrate["launches"]["fwd_eval"],
        "launches_parity": parity["launches"]["fwd_eval"],
        "ms_criteo": tower_times["criteo tanh"][0],
        "plain_ms_criteo": tower_times["criteo tanh"][1],
        "bound_ms_criteo": _bound(*criteo["fwd"])["bound_ms"],
    }, {
        "name": "mlp_tower_fwd (dropout branch)",
        "route": "cuda",
        "source": "deepctr_torch/csrc/mlp_tower_fwd.cu",
        "replaces": "deepctr_tpu/ops/pallas/mlp.py:110",
        "launches": train["launches"]["fwd_dropout"],
        "max_abs_err": train_k["fwd_drop_err"],
        "ms": train_k["fwd_drop_ms"],
        "plain_ms": train_k["fwd_drop_plain_ms"],
        **_bound(*work["fwd"]),
        "library_ms": None,
        "launches_sharded": sharded["launches"]["fwd_dropout"],
        "launches_criteo": sharded["criteo_launches"]["fwd_dropout"],
        "launches_distributed": distributed["launches"]["fwd_dropout"],
        "launches_sharded_scan": sharded_scan["criteo_launches"]["fwd_dropout"],
        "launches_substrate": substrate["launches"]["fwd_dropout"],
        "launches_capacity": capacity["launches"]["fwd_dropout"],
        "launches_parity": parity["launches"]["fwd_dropout"],
        "launches_roofline": roofline["launches"]["fwd_dropout"],
        "ms_criteo": train_k["criteo_fwd_drop_ms"],
        "plain_ms_criteo": train_k["criteo_fwd_drop_plain_ms"],
        "bound_ms_criteo": _bound(*criteo["fwd"])["bound_ms"],
    }, {
        "name": "mlp_tower_bwd",
        "route": "cuda",
        "source": "deepctr_torch/csrc/mlp_tower_bwd.cu",
        "replaces": "deepctr_tpu/ops/pallas/mlp.py:373",
        "launches": train["launches"]["bwd"],
        "max_abs_err": train_k["bwd_err"],
        "ms": train_k["bwd_ms"],
        "plain_ms": train_k["bwd_plain_ms"],
        **_bound(*work["bwd"]),
        "library_ms": None,
        "launches_sharded": sharded["launches"]["bwd"],
        "launches_criteo": sharded["criteo_launches"]["bwd"],
        "launches_distributed": distributed["launches"]["bwd"],
        "launches_sharded_scan": sharded_scan["criteo_launches"]["bwd"],
        "launches_reproduce": reproduced["launches"]["bwd"],
        "launches_substrate": substrate["launches"]["bwd"],
        "launches_capacity": capacity["launches"]["bwd"],
        "launches_parity": parity["launches"]["bwd"],
        "launches_roofline": roofline["launches"]["bwd"],
        "ms_criteo": train_k["criteo_bwd_ms"],
        "plain_ms_criteo": train_k["criteo_bwd_plain_ms"],
        "bound_ms_criteo": _bound(*criteo["bwd"])["bound_ms"],
    }, {
        "name": "fm_score",
        "route": "cuda",
        "source": "deepctr_torch/csrc/fm_score.cu",
        "replaces": "deepctr_tpu/ops/pallas/interaction.py:66",
        "launches": fm["launches"]["fm_score"],
        "max_abs_err": fm_kernel["err"],
        "ms": fm_kernel["ms"],
        "plain_ms": fm_kernel["plain_ms"],
        **fm_bound,
        "library_ms": None,
        "launches_sharded_scan": sharded_scan["fm_launches"]["fm_score"],
        "launches_reproduce": reproduced["launches"]["fm_score"],
        "launches_substrate": substrate["launches"]["fm_score"],
        "launch_floor_ms": fm_kernel["floor_ms"],
        "ms_8192": fm_kernel["ms_train"],
        "ms_8192_past_l2": fm_kernel["ms_train_cold"],
    }, {
        "name": "adagrad_dense_update",
        "route": "cuda",
        "source": "deepctr_torch/csrc/sparse_adagrad.cu",
        "replaces": None,
        "launches": train["launches"]["adagrad_dense"],
        "max_abs_err": sparse["max_abs_err"],
        "ms": sparse["ms_bf16"],
        "plain_ms": sparse["plain_ms_bf16"],
        **_bound(0, sparse["bytes_bf16"]),
        "library_ms": None,
        "launches_sharded": sharded["launches"]["adagrad_dense"],
        "launches_criteo": sharded["criteo_launches"]["adagrad_dense"],
        "launches_distributed": distributed["launches"]["adagrad_dense"],
        "launches_sharded_scan": sharded_scan["criteo_launches"]["adagrad_dense"],
        "launches_reproduce": reproduced["launches"]["adagrad_dense"],
        "launches_substrate": substrate["launches"]["adagrad_dense"],
        "launches_capacity": capacity["launches"]["adagrad_dense"],
        "launches_parity": parity["launches"]["adagrad_dense"],
        "launches_scan": sparse["launches_scan"],
        "rows_written_scan": sparse["rows_written_scan"],
        "launches_dlrm": dlrm["launches"],
        "ms_f32": sparse["ms_f32"],
        "plain_ms_f32": sparse["plain_ms_f32"],
        "bound_ms_f32": sparse["bound_ms_f32"],
        "rows_touched": sparse["touched"][0],
        "rows_split": sparse["split"][0],
        "ms_dlrm": dlrm["update_ms"],
        "bound_ms_dlrm": dlrm["update_bound_ms"],
        "rows_split_dlrm": dlrm["rows_split"],
    }, {
        "name": "dense_bwd_product",
        "route": "cuda",
        "source": "deepctr_torch/csrc/dense_bwd.cu",
        "replaces": None,
        "launches_replay": dense_bwd["launches_replay"],
        "library_replay": dense_bwd["library_replay"],
        "worst_err_ratio": dense_bwd["worst_err_ratio"],
        "ms_step": dense_bwd["ms_step"],
        "bound_3xtf32_ms_step": dense_bwd["bound_ms_step"],
        "library_ms_step": dense_bwd["cublas_ms_step"],
        "products": dense_bwd["products"],
    }]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
