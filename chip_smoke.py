#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels_only]

Phases, each of which raises (and the script exits non-zero) on failure:

1. ``require_cuda()``; print the card's name and power limit.
2. Build the port's CUDA kernels from ``pointsecguard_tpu_torch/csrc``;
   fail if ptxas reports spill bytes for the any-D kNN kernel
   (``knn_tiled_kernel``) at any of its list sizes (1, 16, 48).
3. FPS and bottom-k against their plain PyTorch versions on the card, at
   the shapes one ``build_geometry`` of a batch of 8 × 4096-point blocks
   gives them: FPS indices equal at all four levels; bottom-k values and
   indices equal on the ball-query and 3-NN inputs, on the C&W smooth
   term's colour distances ([8, 4096, 4096], k = 10 and 5) and on
   tie-heavy rounded values; the contracts' edges (FPS: N = 1, 33, 500,
   1000, 4097 and 8192, npoint > N, the start at N − 1, identical and
   rounded points, a start outside the cloud; bottom-k: k == N up to
   8192, k = 1, 48, 129) and the orders that stress the selection
   (descending and constant rows, ±inf, widths off 4 and off 128);
   refusal past the limit. Times of kernel and plain, per level, and the
   time of one dependent FPS step.
4. kNN and wide-row bottom-k against their plain versions on the card:
   kNN at every ``build_pyramid`` shape of a batch of 4 × 40960-point
   RandLA clouds (k=16 and k=1), at [1, 4096, 64] k=16 and k=48, on
   tie-heavy [2, 2048, 4] k=8 and on the orders and shapes that stress its
   deferred insertion (points sorted far → near and near → far from
   huddled queries, a constant and a duplicated cloud, S and N off the
   block, tile and group sizes, k == N == 16, one query, ``query is
   points`` and a distinct query, k = 17 and 48 at D = 3); the any-D
   kernel at the edges of its tiling (``knn_any_d_edges``: D = 1, 2, 4, 9,
   31, 33, 63, 64, 65, 128, 512 and 4096, S = 1, 127, 129 and 4096, N = 1,
   63, 65 and 4099, k = 1, 16, 17, 48 and k == N, ``query is points`` and
   a distinct query, quarter-grid, constant and far → near clouds, on
   grids where every product is exact); wide-row
   bottom-k on [4, 4096, 40960] k=16 pyramid distances, on tie-heavy
   rounded values, at its edges (N = 8193 and 2^22 at k = 1, 32 and 48,
   N = 2^20) and on a 10,000-point cloud's ball-query rows and the rows
   built from them (none, 5 and k − 1 in radius, all equal, a run that
   takes the exact branch; the rows that took it counted by the kernel
   and equal to ``overflow_rows_plain``'s) at k = 1, 32, 48; refusal
   past the bounds (k = 49 at D = 3 and 64, D > 4096). Values and indices
   equal; median times of kernel and
   plain, per shape and per ``build_pyramid``, and of the far → near and
   near → far orders beside the random one.
5. The two kNN routes at full size: the 40960² level through the fused
   kernel and through the tiled route (``square_distance`` + wide-row
   bottom-k, tile 4096) give identical indices.
6. The PointNet++ slice: synthetic rooms at 25k points/m², a full-width
   PointNet++ SSG checkpoint with seeded random weights (BatchNorm
   statistics from one forward over synthetic blocks), and the NB attack
   through ``pointsecguard_tpu_torch.cli.attack.main`` on 32 blocks of
   4096 points at batch 8. FPS and bottom-k must have launched on that
   run; then the model on the card (kernels) against the same model on
   the CPU (plain versions) on two blocks.
7. The RandLA slice: the same rooms prepared at 0.04 m (the Area-5 cloud
   keeps ≥ 40960 points, so nothing is up-sampled), a full-width RandLA
   checkpoint with seeded random weights (BatchNorm statistics from one
   train-mode forward), and the NB attack through the same CLI on 8
   clouds of 40960 points at batch 4: exactly 10 kNN launches per batch,
   finite output, mean adversarial accuracy below mean clean accuracy.
8. The fused attentive-pooling kernels (forward and backward) against
   their plain version at the shapes of one RandLA batch ([16, 163840, 8]
   and [16, 40960, 32], with and without dW) and at the contract's edges
   (M = 1, M off the row tile, D = 1, 5, 8, 12, 32, 63, K = 4 and 16); dW
   the same on two runs; refusal past the bounds; times of kernel and
   plain per RandLA forward (4 calls) and per backward.
9. The full-width RandLA with ``ap_impl="fused"`` against the reference
   composition on one sampler batch: logits within 1e-4 of the largest;
   the colour gradient as close to a float64 evaluation as the float32
   reference's, within a factor of 2.
10. RandLA NB through the CLI with and without ``--fused_ap``, in turns
    (reference, fused, fused, reference): ms/cloud of each; 4 forward
    and 4 backward attentive-kernel launches per model forward / backward
    with the flag, none without.
11. RandLA NU through the CLI: one batch of 4 clouds, the preset's 1000
    steps or its early exit, with ``--fused_ap`` and without, in turns;
    launches as in 10.
12. PointNet++ NU through the CLI on 8 blocks at batch 8 (the random
    checkpoint with the ceiling, floor and wall logits raised, so that
    the clean accuracy starts above NU's exit): bottom-k launches for the
    geometry and for the smooth term of every step.
13. Card vs CPU on one 8192-point cloud, reference and fused model:
    pyramid indices equal at every level, logits within 1e-4 of the
    largest magnitude.
14. FPS and bottom-k at the shapes of one training step: one
    ``build_geometry`` of 32 × 4096-point blocks with a random FPS start
    per cloud and level; equal to plain, with their times (part of the
    kernel phases, so ``--kernels_only`` runs it too).
15. The trained fixture on the card: ``tests/fixtures/trained_pointnet2.npz``
    through ``utils/convert.py``, NB and tar_NB (floor → table, 50
    iterations) on 8 blocks of 128 points, held against
    ``tests/fixtures/trained_pointnet2.json`` at the tolerances of
    ``tests/test_torch_attack.py``.
16. One optimizer step of the full-width PointNet++ from the same
    weights, batch (8 × 4096), FPS starts and dropout mask on the card
    (kernels) and on the CPU (plain versions): FPS centres equal,
    neighbour indices in agreement; on the card's plan, loss, gradients,
    Adam moments, parameters and BatchNorm statistics within the
    tolerances stated in ``phase_train_step``.
17. Training through ``pointsecguard_tpu_torch.cli.train.main`` at full
    width: batch 32 × 4096 points on four synthetic rooms at 25k
    points/m², 5 epochs of 13 optimizer steps, two evals; every loss
    finite, no skipped batch, the last epoch's mean loss below the
    first's, exactly 4 FPS and 8 bottom-k launches per optimizer step and
    per eval batch, one ``epoch`` line per epoch; a second call with one
    more epoch resumes and repeats none. ms per step on the host's clock
    and by CUDA events, blocks/s, the host's share, peak device memory.
18. ``cli.eval.main --num_votes 1`` on that checkpoint: accuracy on the
    Area-5 room at or above ``EVAL_ACC_FLOOR``.
19. ``cli.attack.main --attack nb --save_adv`` on that checkpoint, 32
    blocks at batch 8: adversarial accuracy below clean accuracy; then
    ``cli.eval.main --adv_set`` on the written ``.npz`` gives the attack
    run's adversarial accuracy back.
20. kNN at the shapes of one RandLA training step: one ``build_pyramid``
    of [6, 40960] on the train sampler's clouds, each of its 10 calls
    equal to plain; times (a kernel phase).
21. The value gradient of bottom-k on the card: ``bottom_k_indices`` on
    the 3-NN inputs of one ``build_geometry`` of [8, 4096] and on rows of
    9000 gives the kernels' own values and indices and the CPU's gradient,
    bit for bit; the 3-NN weights' gradient card vs CPU (a kernel phase).
22. One RandLA optimizer step, card vs CPU, at full width on 2 × 8192
    points: pyramid indices equal at every level; loss, gradients, Adam
    moments, parameters and BatchNorm statistics within the tolerances
    stated in ``phase_randla_train_step``.
23. The fused against the reference RandLA in training mode at 6 × 40960:
    parameter gradients against float64, the fused within twice the
    reference's distance; the attentive backward with dW at the step's
    shapes against plain, timed.
24. Training through ``cli.train.main --model randla`` at full width: batch
    6 × 40960 on the train cloud prepared at 0.04 m, 3 epochs of 40 steps
    and 4 validation clouds, one more epoch on resume; every loss finite,
    no skipped batch, the last epoch's loss below the first's, exactly 10
    kNN launches per optimizer step and per validation cloud, no epoch
    repeated. ms per step on the host's clock and by CUDA events, clouds/s,
    the host's share, the sampler alone, peak device memory.
25. ``cli.eval.main --model randla`` on that checkpoint: 8 samples at batch
    4 voted onto the Area-5 cloud; accuracy at or above
    ``RANDLA_EVAL_ACC_FLOOR`` (0.3, set before the first run).
26. ``cli.attack.main --model randla --attack nb --save_adv`` on that
    checkpoint, 8 clouds at batch 4: adversarial accuracy below clean; then
    ``cli.eval.main --model randla --adv_set`` gives it back to 1e-3.

27. kNN at the four shapes of one full-width ResGCN-28 forward of 8 ×
    4096 points (seeded weights, BatchNorm statistics from one forward):
    the head graph over xyz (D = 3, k = 16) and DynConv_0..2 over their
    real input features (D = 64, k·d = 16, 32, 48), equal to plain except
    in near-tie rows (counted); card, eager and plain ms, bound, share,
    ``cross_bmm_ms`` (cuBLAS's float32 ``torch.bmm`` of the cross term
    alone, a yardstick), 4 launches a forward. The large-k selection of
    DynConv_3..26 (k·d = 64
    … 432, [8, 4096, 4096]): the stable sort of the route, the ``bottom_k``
    kernel and ``torch.topk``, equal and timed (a kernel phase), printed
    as a record of its own on a ``{"selection": [...]}`` line, not in the
    kernel records: ``bottom_k`` never launches on this route.
28. ResGCN card vs CPU on 2048 points of one block: every block's graph rebuilt on the
    CPU from the card's features equal to the card's except in near-tie
    rows; on the card's graphs, logits and colour gradient of the card no
    further from a float64 evaluation than twice the CPU's float32, and
    card vs CPU logits within 4e-4 of the largest.
29. ResGCN NB through ``cli.attack.main --model resgcn`` on a random-weight
    checkpoint, 4 blocks at batch 4, 50 iterations: 4 kNN launches per
    forward, adversarial accuracy below clean, ms/block, peak memory.
30. ResGCN NU through the C&W engine on one batch, the preset cut to
    ``RESGCN_NU_STEPS`` steps: one ``bottom_k`` launch a step, 4 kNN a
    forward.
31. One ResGCN optimizer step card vs CPU on two blocks, on the card's
    train-mode graphs, at ``phase_train_step``'s tolerances.
32. ``cli.train.main --model resgcn`` at 8 × 4096 on one synthetic train
    room (13 steps an epoch), 2 epochs and one more on resume: losses
    finite and falling, 4 kNN launches a step, no epoch repeated; ms per
    step (host clock, CUDA events), blocks/s, host share, peak memory.
33. ``cli.eval.main --model resgcn --num_votes 1`` on that checkpoint:
    accuracy at or above ``RESGCN_EVAL_ACC_FLOOR`` (0.3, set before the
    first run), 4 kNN launches a batch of 16.
34. On that checkpoint: NB ``--save_adv`` on 8 blocks lowers the
    accuracy and ``cli.eval --adv_set`` gives it back; tar_NB (board →
    table) at batch 1 on up to 2 blocks, the per-cloud gates both
    attacking and skipping clouds.

35. FPS and bottom-k at PointNet++ MSG's shapes (a kernel phase, run
    after 27): one ``build_geometry_msg`` of [8, 4096] from index 0 and of
    [32, 4096] with random starts, 4 FPS and 12 bottom-k calls each (ball
    queries at k = 16 and 32 on rows up to [B, 1024, 4096], 3-NN at k = 3):
    equal to plain (indices; values, so the 3-NN weights), the geometry
    equal to ``build_geometry_msg``'s, ``torch.topk``'s values equal; card,
    eager, plain and ``torch.topk`` ms, bound and share of each set
    (records ``msg_attack`` and ``msg_train_step``).

Phases 36-41 run for PointNet++ MSG and then for PointNet (206 and 102
tensors, 1,895,253 and 3,541,334 floats), after phase 34:

36. Card vs CPU on two blocks, calibrated seeded weights (``phase_block_
    reference``): MSG's geometry built on both (FPS centres equal,
    neighbours in agreement); log-probabilities and the NB loss's colour
    gradient in float64 on the card within 1e-6 of the CPU's; in float32
    the card's log-probabilities no further from float64 than twice the
    CPU's and within 4e-4 of the largest of them, its gradient within 5 %
    of float64 (MSG's maxima over tied groups: 2.8 % from rounding alone).
37. NB through ``cli.attack.main`` on 32 blocks at batch 8 (phase 6's
    protocol): MSG launches 4 FPS and 12 bottom-k a batch, PointNet none
    (said on a line of its own); then NU on 8 blocks, the preset cut to
    ``BLOCK_NU_STEPS``: the geometry's launches plus one bottom-k a step.
38. One optimizer step of 8 × 4096 card vs CPU at phase 16's batch and
    tolerances (MSG: pinned FPS starts and dropout mask; PointNet: the
    feature-transform aux loss; 32 × 4096 until phases 69-71 came: the
    CPU's half of it set the phase's time).
39. ``cli.train.main`` at 32 × 4096 on phase 17's rooms, 2 epochs (an eval
    after the second) and one more on resume: losses finite and falling,
    one geometry's launches per step and per eval batch (PointNet none).
40. ``cli.eval.main --num_votes 1``: accuracy at or above ``EVAL_ACC_FLOOR``.
41. NB ``--save_adv`` on 32 blocks lowers the trained model's accuracy, and
    ``cli.eval --adv_set`` gives the attack run's accuracy back.

Phases 42-46 drive the attack CLIs' protocol flags:

42. The D = 3 kNN kernel at the resample defense's shapes (a kernel phase,
    run after 5): the self-kNN over xyz of [8, 4096, 3] and [4, 40960, 3]
    at k = 8, equal to plain, card, eager and plain ms, bound and share
    (the ``resample`` entry of the knn record).
43. On the trained SSG of phase 17, ``PROTOCOL_BATCHES`` batches of 8
    blocks each (ms a block of the last) through ``cli.attack.main``: NB
    without flags,
    NB ``--control --log_steps`` (adversarial accuracy below
    ``rand_acc``), NB ``--control --log_steps --defense resample --eot 2
    --visual`` (exactly 25 kNN launches a batch: the deployed defense's
    clean, adversarial and control forwards, two EoT draws for each of the
    10 attack forwards and PGD's last; 10 steps rows a batch; six visual
    files), ``--defense bit_depth``, ``jitter``, ``jpeg`` and ``--attack
    random`` (l2 1.0); ms a block of each.
44. The defenses card vs CPU on two blocks (bit depth, resample and jitter
    on the same draws exactly; JPEG at quality 95 and 10 within 1e-6
    outside the tests' rounding-boundary rule) and one NB trajectory of the
    calibrated SSG in float64 on both devices within 1e-4.
45. On the trained RandLA of phase 24: NB on 4 clouds with ``--defense
    resample --control --log_steps`` (exactly 10 + 14 kNN launches), then
    ``cli.eval --model randla --visual --save_preds``, and ``cli.cv6fold``
    on those PLYs (eval's accuracy and mIoU).
46. ResGCN NB with ``--resgcn_fixed_graphs`` on phase 29's checkpoint and
    blocks: 12 kNN launches (graph collection, clean and adversarial
    forwards), ms a block and adversarial accuracy beside phase 29's.

Phases 47-51 drive the ensemble victim and the ares benchmark layer, after
41, each at full width and with its own seconds:

47. ``cli.attack --attack nb`` on the trained SSG (phase 17) with ``--ensemble
    pointnet2_msg:<MSG log> --ensemble pointnet:<PointNet log>:0.5`` (phase
    39's logs), ``PROTOCOL_BATCHES`` batches of 8 × 4096 under ``--ensemble_mode probs`` and
    ``log_probs``: exactly 8 FPS (4 SSG + 4 MSG) and 20 bottom-k (8 + 12)
    launches a batch, ms a block beside NB alone; a self-ensemble's clean
    accuracy equal to the single model's.
48. ``cli.benchmark --model pointnet2`` on the trained SSG, one batch of 8 ×
    4096 a call: ``--mode prediction``, then ``--mode attack`` with fgsm,
    bim, pgd, mim, cw (``--cw_steps 100``), nes and spsa (``--samples 32``
    and ``16``, ``--iters 20``) and nattack (16 × ``NATTACK_ITERS``): ms and forwards a batch,
    queries per second of the score-based three, adversarial accuracy and
    success; 4 FPS and 8 bottom-k launches a batch whatever the query
    count (C&W: one more bottom-k a step).
49. ``--mode distortion --attack_name pgd`` (probes, minimal ε),
    ``--mode iteration --attack_name bim`` (10 rows, L2 monotone or not) and
    ``--mode worstcase --attack_names pgd,nes``.
50. NES and SPSA card vs CPU on two blocks with the same draws through
    ``noise=`` at 4 pairs × 3 iterations (the colour elements that differ in
    float32, in units of α), NES's first step with every flipped sign
    within the estimate's rounding bound, and MIM in float64 card vs CPU
    within 1e-10.
51. ``cli.benchmark --model randla --attack_name pgd`` on phase 24's
    checkpoint, 4 × 40960 (10 kNN launches), and ``--model resgcn
    --attack_name bim --iters 10`` on phase 29's, 8 × 4096 (4 kNN a
    forward).
52. Raw SemanticKITTI (sequences 00, 08, 11; 120k-point scans with
    ignored ids and a learning-map yaml), Semantic3D (two labeled 160k-point
    clouds, one of them ``bildstein_station3``, and an unlabeled one, with
    label-0 points) and S3DIS (``Area_*/room/Annotations`` of phase 3's
    rooms) written in the datasets' formats, then ``cli.prepare`` on each;
    its seconds, and every cloud at least the preset's sample size.
53. ``knn`` at every call of one ``build_pyramid`` of Semantic3D's [4,
    65536] (10 calls) and SemanticKITTI's [6, 45056] (8 calls), equal to
    plain; launches and times per pyramid against the bound; the fused
    attentive pair at a Semantic3D pass (2 × [16, 262144, 8], 2 × [16,
    65536, 32]) within tolerance of plain, timed (a kernel phase).
54. Semantic3D at full width: ``cli.train`` 4 × 65536 (8 steps and one
    validation batch of 16 an epoch, 2 epochs + 1 on resume; ms a step by
    CUDA events and the host's clock, peak memory), ``cli.eval`` with
    ``--save_preds`` (a prediction for every point of the original cloud),
    ``cli.attack --attack nb`` on 4 clouds with and without ``--fused_ap``
    (10 kNN a batch, ignored points' colours unchanged, accuracy lowered),
    and the 8-class model and ignored-label loss card vs CPU against
    float64 on 8192 points.
55. SemanticKITTI at full width: ``cli.train`` 6 × 45056 on xyz-only
    features (2 epochs, 8 kNN a step), ``cli.eval`` at sub-cloud
    resolution, ``cli.attack`` refused for the xyz-only reason.
56. The kernels at the ModelNet classifiers' shapes (a kernel phase) on a
    synthetic ModelNet of 2048-point shapes (4 classes, 24 train and 8 test
    shapes each; the loader takes 1024 points): FPS [16, 1024] → 512 and
    [16, 512] → 128 from index 0, [24, 1024] from random starts; the ball
    queries on bottom-k (SSG k = 32 on [16, 512, 1024]; MSG k = 16, 32 there
    and 32 on [16, 128, 512]); SOR's self-kNN [16, 1024, 3], k = 11. Each
    equal to plain (and the classifier geometry's indices to the calls');
    card, eager, plain ms, bound, share, ``torch.topk``. The k = 64 / 128
    ball queries take the stable sort, as JAX's ``lax.top_k`` route: timed
    beside the bottom-k kernel and ``torch.topk`` on the ``selection`` line.
57. Card vs CPU for each classifier at 40 classes, calibrated seeded
    weights, 8 × 1024 × 6 shapes: log-probabilities and the xyz gradient
    through the moving geometry (the card's indices, centres regathered
    from the leaf), in float32 and float64, against the CPU's float64.
58. ``cli.train`` (24 a batch, 8 epochs, an eval every 4) and ``cli.eval``
    for each classifier (instance accuracy ≥ ``CLS_EVAL_ACC_FLOOR``, the
    trainer's figure; one geometry's launches a step and an eval batch),
    then ``cli.attack_object`` on the trained SSG: NB and NB
    ``--fixed_geometry`` (two batches of 16), NU cut to 10 steps, tar_NB,
    ``--attack random``, NB ``--control``, NB ``--defense sor`` and
    ``--defense srs --eot 2``; then NB ``--control`` on an SSG trained on
    xyz alone (24 epochs at lr 1e-3; the fixture's normals name its
    classes, and coordinate attacks leave them): ms a batch, launches by
    path (NB: 106 FPS and 53 bottom-k a batch; fixed: 2 and 1; SOR: a kNN
    a forward), accuracy clean / adversarial / control; on xyz alone NB
    lowers it below clean and below its control.
59. ``cli.benchmark --task cls --no_normals`` on the xyz-only SSG of phase
    58, one batch of 16: all
    eleven registry names (DeepFool, Boundary and Evolutionary included)
    and ``--mode distortion --attack_name boundary``: ms and forwards a
    batch, two FPS and one bottom-k launch a forward (C&W one bottom-k more
    a step: its smooth term). Then DeepFool at ModelNet40's K = 40 (40
    backwards an iteration) on the SSG with phase 57's 40-class weights,
    16 shapes: ms a batch, iterations, forwards, backwards, launches, and
    one iteration's ms by CUDA events with 40 and with 4 backwards.
60. The kernels at the part-seg nets' shapes (a kernel phase) on a synthetic
    ShapeNetPart of 2500-point shapes (3 categories; 21 train, 1 val and 3
    test shapes each; the loader draws 2048 with replacement): FPS of one
    attack geometry ([8, 2048] → 512, [8, 512] → 128 from index 0) and of
    one train geometry ([16, 2048], random starts); the k = 32 ball query
    on [8, 512, 2048]; the 3-NN hops l0 ← l1 ([8, 2048, 512]) and l1 ← l2
    ([8, 512, 128]) at k = 3; SOR's self-kNN [8, 2048, 3], k = 11. Each
    equal to plain and the geometry's indices (and 3-NN weights) to the
    calls'; card, eager, plain ms, bound, share, ``torch.topk``. The k = 64
    / 128 ball queries (SSG's second level, MSG's) take the stable sort:
    timed on the ``selection`` line.
61. Card vs CPU for each part-seg net, seeded weights carried through the
    flax layout (``utils/convert.py``), 4 × 2048 × 6 test shapes: the
    geometry built on both (FPS equal, groups and 3-NN indices in
    agreement), then on the card's indices with the centres and the 3-NN
    weights recomputed from the leaf (the moving geometry) the
    log-probabilities and the xyz gradient of the NB loss, in float32 and
    float64, against the CPU's float64; the 3-NN weights' share of the
    card's gradient (against the same plan with the weights detached) must
    not be zero.
62. ``cli.train`` (16 a batch, 4 steps an epoch, 10 epochs, an eval every
    5) and ``cli.eval`` for each part-seg net: instance mIoU at or above
    ``PS_MIOU_FLOOR``, the trainer's best figure; one geometry's launches
    (2 FPS, 3 bottom-k) a step and an eval batch; ms a step.
63. ``cli.attack_object`` on the trained nets, one batch of 8 a run: NB
    ``--control`` on each (54 forwards: 108 FPS and 162 bottom-k launches
    for SSG and MSG, none for PointNet; the adversarial mIoU below clean),
    then on the SSG tar_NB ``--origin 47 --target 49`` (only the Table's
    part-47 points move), NU cut to 10 steps and NB ``--defense sor`` (a
    kNN a forward): ms a batch, forwards, launches, mIoU clean /
    adversarial / control.
64. The device block sampler (``cli.train --device_sampler``) on the card
    against its CPU version on the card's draws, on phase 17's rooms and
    on one room of 2,500,096 points, with and without replacement and the
    z-rotation: labels equal, features within 1e-6; ms a batch of 32 ×
    4096 with and without ``--device_sampler_exact``, bytes staged.
65. PointNet++ SSG through ``cli.train`` at 32 × 4096, 2 epochs on the
    host sampler and 2 with ``--device_sampler --steps_per_call 4``: the
    same steps, one geometry's launches a step, the device run's eval
    mIoU in the host run's range; blocks/s, ms a step by CUDA events, the
    host's share.
66. ``cli.train --adv_train nb`` (5 iterations): SSG at 32 × 4096 (8 FPS
    and 16 bottom-k launches a step: the step's plan and one hoisted
    evaluation plan) and RandLA at 6 × 40960 (20 kNN a step); ms a step
    with the attack and without.
67. ResGCN-28 at 8 × 4096: ``cli.train --remat`` (4 kNN a step), then one
    step with and one without remat from the same state: peak memory, ms,
    and loss, gradients, statistics and parameters equal within the
    stated tolerances.
68. ``cli.train --profile``: the first epoch's Chrome trace names the FPS
    and bottom-k kernels, 4 and 8 a step.
69. The eleven models at full width in bf16 (``--precision bfloat16``),
    seeded weights (ResGCN-28: phase 32's trained ones): the same FPS,
    bottom-k and kNN launches as float32 (the geometry stays float32), the
    card's bf16 output (float32) against the CPU's bf16 on the card's
    geometry within ``BF16_CARD_ULPS`` bf16 ulps and JAX's 0.05 / 0.1 where
    they apply, and one bf16 train step keeping every parameter, gradient
    and statistic float32.
70. bf16 through the CLIs: ``cli.train`` of SSG (2 epochs on phase 17's
    rooms) and ResGCN-28 (an epoch, and one with ``--remat``), each then
    ``cli.eval``; NB through ``cli.attack`` on SSG, RandLA (reference
    pooling) and ResGCN, through ``cli.attack_object`` on the SSG
    classifier; ``cli.benchmark`` pgd; ``--fused_ap`` refused. Launches as
    float32's; SSG's ms a train step and ResGCN's an NB iteration by CUDA
    events and peak memory, float32 and bf16 on the same batch.
71. ``cli.import_ckpt`` of reference checkpoints written here (SSG and a
    4-block ResGCN ``.pth``, a RandLA ``.npz``), then ``cli.eval`` on the
    card: the imported weights' log-probabilities equal to the same
    weights through ``utils/convert.py``.
72. ``torch.library.opcheck`` of the six ``psg::`` custom ops on the card,
    one slice shape each (a kernel phase, run after 60).
73. ``cli.export --check`` (its ``main``, as ``python -m
    pointsecguard_tpu_torch.cli.export`` runs it) of the eleven models at
    full width and their task's default points from the checkpoints
    trained above (SSG 17, RandLA 24, ResGCN 32, MSG and PointNet 39, the
    classifiers 58, the part-seg nets 62), SSG also with ``--precision
    bfloat16``, RandLA and ResGCN also at 8192 and 1024 points for the CPU
    leg; four processes share the jobs. The live model's launches of one
    forward (SSG 4 FPS + 8 bottom-k, MSG 4 + 12, the classifiers 2 + 1 /
    2 + 3, the part-seg nets 2 + 3, RandLA 10 kNN, ResGCN-28 4, the
    PointNets none, said on a line of their own), its ms a forward, its
    outputs on the card and the CPU.
74. Every artifact reloaded in a fresh ``python -c`` process that imports
    no model code: on the card the live forward's launches and outputs
    (within 1e-5), and in a second process on the CPU (RandLA and ResGCN
    at their cut points; 4 threads, as the live model's CPU run) the live
    model's CPU outputs; load seconds, ms a forward beside the live
    model's.
75. ``knn_points_sharded`` at RandLA's pyramid shapes (a sampler batch of
    [4, 40960] clouds), the points axis over 2 and over 4 ranks of the
    card (gloo; NCCL takes one rank a card): every level bit-equal to the
    one-process ``psg::knn`` pyramid, 10 launches a rank, each on its query
    shard; card ms of the top level's self-kNN on a rank's query shard
    ([4, 20480] and [4, 10240] against the 40960 candidates) beside the
    whole cloud's, with bound and plain ms (``sharded_query``).
76. The port's ``dryrun_multichip`` (``parallel/dryrun.py``) on 2 × 2
    ranks of the card: a PointNet++ SSG and a narrow ResGCN train step
    (float32 and float64), a RandLA forward + backward with the points
    sharded and its pyramid, an NB attack, a device-sampler multi-step and
    whole-scene voting eval, each held to its one-process run: indices
    equal, loss within rtol 1e-6, gradient within atol 1e-5 (float64; in
    float32 the BatchNorm networks amplify the ranks' summation order,
    which is recorded), parameters equal on every rank.
77. The slice at full width through the CLI bodies on ranks of the card
    (``cli.train._train``, ``cli.attack._attack``; ``--devices 2`` itself
    wants two cards): SSG ``cli.train`` 32 × 4096, one epoch and its eval,
    data-parallel over 2 ranks, held to the one-process run (lr
    ``DP_TRAIN_LR``, see ``phase_parallel``); RandLA NB on 4 × 40960
    clouds with ``--devices 2 --shard_points 2``, its TSV equal to the
    one-process run's on phase 7's checkpoint (both under deterministic
    algorithms), ``time_s`` aside.
78. An NCCL group at ``torch.cuda.device_count()`` ranks, one card each:
    an all-reduce and ``knn_points_sharded`` through it; with one card the
    line says that NCCL across cards was not run.
79. (a kernel phase, after 27) ``--resgcn_fast``: a full-width ResGCN-28
    forward in subsample mode launches ``psg::knn`` 28 times and makes no
    large-k selection; its 26 subsample graphs ([8, 4096, 64] queries
    against the stride-d candidates, d = 2 … 27, 2048 down to 152 rows, k
    = 16) each equal to ``knn_plain`` but in near-tie rows, with card,
    eager and plain ms, bound and share; a forward's ms in both modes.
80. (after 34) ``cli.attack --model resgcn --resgcn_fast --attack nb`` and
    ``cli.eval --resgcn_fast`` on the trained ResGCN-28: 28 kNN launches a
    forward, adversarial accuracy below clean, ms per NB iteration beside
    the exact mode's; one forward's graphs and logits card against CPU.
81. (with 75–77, on the first two of their four ranks) ``cli.benchmark
    --devices 2`` on the trained SSG in the modes prediction, attack (pgd,
    nes), distortion and worstcase, and ``cli.attack --control --log_steps
    --devices 2``, each held to the one-process run of phases 48, 49 or 43
    (``result_gap`` within ``DP_BENCH_POINTS`` / ``DP_BENCH_FLOAT``: the
    ranks' half-size GEMMs round apart on the card).
82. FPS above 8192 points. (A kernel phase, after 72) ``psg::fps`` against
    ``fps_plain`` on the card, indices equal, at [16, 10000] → 512 (a
    ModelNet 10k classifier's first level), [8, 16384] → 1024 (a
    16,384-point block's), N = 8192 / 8193 (the seam between the register
    kernel and the cluster kernel) and 131072 / 131073 → 256 (the cluster
    kernel's capacity and the streaming kernel's first N), each on the
    kernel the contract gives it (read from the launch counters), with
    card, eager, bound, share and plain ms; the edges on whichever kernel
    takes them (identical and rounded points, npoint > N, start at N − 1,
    N = 2²², a start outside the cloud on the cluster and the streaming
    kernel) and N = 2²² + 1 refused. (After 63) NB through
    ``cli.attack_object --num_point 10000`` on one batch of 16 shapes
    written at 10,000 points, with phase 58's SSG classifier: the first
    forward's FPS indices and groups equal card vs CPU; the wide-row
    bottom-k at its ball query [16, 512, 10000] k = 32 equal to plain on
    its rows and on rows built from them (none, 5 and k − 1 in radius, all
    equal, a run of 300 that takes the kernel's exact branch, reported),
    timed beside ``torch.topk``; 106 FPS (53 on the cluster kernel, none
    streaming) and 53 wide-row bottom-k launches a batch; adversarial
    accuracy at most clean and every shape moved (L2 > 0); ms a batch.
    Then the same NB on 2 shapes of 131,104 points: 106 FPS (53 on the
    streaming kernel) and 53 wide-row bottom-k launches.
83. The sparse GCN library (``models/gcn_sparse.py``) on one 4096-point
    block of phase 17's rooms: ``knn_edge_index`` over xyz and over 64
    features (2 ``psg::knn`` launches, edges equal to ``knn_plain``'s but
    in near-tie rows); every conv of JAX's ``test_forward_shapes`` list
    and both blocks at width 64 on the xyz graph, forward and backward in
    training mode, card against CPU (``GCN_*_TOL``); 10 steps each of the
    port's ``radam`` and ``adamw`` with ``smooth_cross_entropy`` on a
    small stack of the library's layers: the loss falls, the first step
    within ``GCN_PARAM_TOL`` of the CPU's, ms a step.

Phases 75–77 and 81 run on one start of four gloo ranks of the card: the
four-rank programs first, then the two-rank ones on ranks 0 and 1 while
ranks 2 and 3 wait (``parallel.dryrun.programs``).

Every kernel's time is given twice: ``ms`` is its time on the card alone
(``device_ms``: the launches are queued behind a spin kernel, so the
host's time to send them is hidden) and ``eager_ms`` the median of single
eager calls as a caller sees them; they differ where the card finishes a
call faster than the host sends it. Beside them stand the plain PyTorch
version's time, ``bound_ms`` (the least time an H100 could take: every
input byte read once and every output byte written once at 3.35 TB/s, or
the operations at 67 TFLOP/s, whichever is larger;
``pointsecguard_tpu_torch/ops/cuda/bounds.py``), ``library_ms`` (the one
PyTorch call that computes the same values, ``torch.topk`` for the two
bottom-k kernels; null where there is none) and ``calls_per_batch`` from
the launch counters of the slice phases.

The last lines are the kernels' JSON record, the card's name and power
limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}``.
``--kernels_only`` stops after phases 3, 4, 5, 42, 8, 14, 20, 21, 27, 79, 35,
56, 60, 72 and 82 (its kernel part) and exits 1. Every phase prints its seconds (``phase N: … s``).
Work files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
BATCH, NUM_POINT, MAX_BLOCKS = 8, 4096, 32
STATE_FLOATS = 975_949  # full-width SSG: parameters + BN running stats
# the block models of the PointNet family at full width: their state
# floats (SSG 134 tensors, MSG 206, PointNet 102) and the kernel launches
# of one geometry (a batch's forward or train step): four FPS levels, one
# ball query per radius and four 3-NN plans; PointNet builds none
MODEL_STATE_FLOATS = {"pointnet2": STATE_FLOATS, "pointnet2_msg": 1_895_253,
                      "pointnet": 3_541_334}
GEOMETRY_LAUNCHES = {"pointnet2": {"fps": 4, "bottom_k": 8},
                     "pointnet2_msg": {"fps": 4, "bottom_k": 12},
                     "pointnet": {"fps": 0, "bottom_k": 0}}
# phases 36-41 drive these two as 6 and 12-19 drive SSG: NU cut to 10 C&W
# steps, cli.train on phase 17's rooms for 2 epochs (an eval after the
# second) and one more on resume (with its eval)
BLOCK_MODELS = ("pointnet2_msg", "pointnet")
BLOCK_NU_STEPS, BLOCK_TRAIN_EPOCHS = 10, 2
RANDLA_BATCH, RANDLA_POINTS, RANDLA_CLOUDS = 4, 40960, 8
RANDLA_STATE_FLOATS = 5_010_981  # full-width S3DIS RandLA-Net
NU_CLOUDS, NU_BLOCKS = 4, 8  # one C&W batch of each model
# the fused attentive poolings of one RandLA batch: layers 0 and 1, two
# poolings each, [K, M, D] with M = batch × the level's points
ATT_SHAPES = ((16, RANDLA_BATCH * RANDLA_POINTS, 8), (16, RANDLA_BATCH * RANDLA_POINTS // 4, 32))
ROOM_POINTS = 400_000  # synthetic 4 × 4 m rooms at 25k points/m²
# the training slice: batch 32, four train rooms (390 sampler blocks, 13
# steps an epoch), evals after epochs 3 and 5, one more epoch on resume
TRAIN_BATCH, TRAIN_AREAS, TRAIN_EPOCHS, TRAIN_EVAL_EVERY = 32, (1, 2, 3, 4), 5, 3
TRAIN_LR = 0.003
# whole-scene accuracy the trained checkpoint must reach on the Area-5
# room (7 classes, the largest three a quarter of the points each);
# 2/13 is twice the chance of 13 classes
EVAL_ACC_FLOOR = 0.3
# RandLA training: the config's batch of 6 × 40960 points on the train
# cloud prepared at 0.04 m, 40 steps and 4 validation clouds an epoch, 3
# epochs and one more on resume, the config's lr 1e-2. BatchNorm keeps
# 0.99 of its running statistics a step, so after 30 steps they are still
# 74 % the initial ones and evaluation-mode accuracy stays near chance
# (0.21 on the Area-5 cloud); after 200, 13 %. (100 steps an epoch until
# the part-seg phases came: validation accuracy 0.78 after 200 steps and
# eval 0.9885 after 400 on an H100, against the floor of 0.3; 70 until the
# export phases came: 0.8531 after 210; 50 until --resgcn_fast's phases
# came: 0.9367 after 200)
RANDLA_TRAIN_BATCH, RANDLA_TRAIN_STEPS, RANDLA_VAL_STEPS = 6, 40, 4
RANDLA_TRAIN_EPOCHS = 3
# the card-vs-CPU step: the CPU's plain pyramid of 2 × 40960 points takes
# ~100 s on 8 cores (the stable sort of 40960-wide rows), of 2 × 16384 ~15 s
# (the whole phase 16.6 s on an H100 host), so 2 × 8192 since the
# several-rank phases came
RANDLA_STEP_POINTS = 8192
# whole-cloud accuracy the trained RandLA checkpoint must reach on the
# Area-5 cloud, set before the first run: PointNet++'s floor
RANDLA_EVAL_ACC_FLOOR = 0.3
RANDLA_EVAL_CLOUDS = 8
# the fused attentive poolings of one training step: [K, M, D] at
# M = 6 × the level's points
ATT_TRAIN_SHAPES = ((16, RANDLA_TRAIN_BATCH * RANDLA_POINTS, 8),
                    (16, RANDLA_TRAIN_BATCH * RANDLA_POINTS // 4, 32))


# ResGCN-28 at full width: 28 blocks, 64 filters, k = 16, 188 tensors
RESGCN_STATE_FLOATS = 3_651_469
# RESGCN_BLOCKS: the NB runs of phases 29, 34, 46 and 80 attack one batch
# of 4 blocks (8 until the script's wall neared its limit; the kernel
# phases keep the batch of 8)
RESGCN_BATCH, RESGCN_BLOCKS, RESGCN_TAR_BLOCKS = 8, 4, 2
RESGCN_REFERENCE_POINTS = 2048  # phase 28's card-vs-CPU cloud
RESGCN_NU_STEPS = 10  # the NU phase cuts the preset's 1000 C&W steps to this
# training: one train room at 25k points/m² (97 sampler blocks, 13 steps an
# epoch at 8 × 4096), the config's constant lr 1e-3, RESGCN_TRAIN_EPOCHS
# epochs and one more on resume
RESGCN_TRAIN_EPOCHS = 2  # 3 until phases 82-83 came
# whole-scene accuracy the trained checkpoint must reach on the Area-5
# room, set before the first run: PointNet++'s floor
RESGCN_EVAL_ACC_FLOOR = 0.3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def record_bound(rec: dict, work) -> None:
    """The least time the card could take for ``work`` and what sets it."""
    rec.update(bound_ms=work.bound_ms, bound_by=work.bound_by)


def topk_library(vals: torch.Tensor, k: int):
    """The one PyTorch call that computes bottom-k's values (it does not
    order ties, so only its values are comparable). A yardstick for the
    timings here; the port never calls it."""
    return torch.topk(vals, k, dim=-1, largest=False, sorted=True)


TOPK_CALL = "torch.topk(vals, k, dim=-1, largest=False, sorted=True)"


def device_ms(fn, reps: int = 10) -> float:
    """Milliseconds of ``fn()`` on the card alone: ``reps`` runs are queued
    behind a spin kernel of some 20 ms, so the host's time to send the
    launches is hidden and the events see back-to-back device work.
    ``cuda_ms`` times one eager call as a caller sees it; for a call that
    the card finishes faster than the host sends it, the two differ."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def slice_blocks(dev) -> torch.Tensor:
    """[8, 4096, 9]: four blocks of a synthetic room at 25k points/m²
    (padded with repeated points, as WholeSceneBlocks pads) and four
    uniform-noise clouds."""
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks
    from pointsecguard_tpu_torch.data.synthetic import make_room

    rng = np.random.default_rng(1)
    room = make_room(400_000, rng=rng)
    rooms = RoomSet(["smoke"], [room[:, :6]], [room[:, 6].astype(np.int64)],
                    [room[:, :3].min(0)], [room[:, :3].max(0)])
    data, *_ = WholeSceneBlocks(rooms, block_points=NUM_POINT).room_blocks(0, rng)
    noise = rng.random((4, NUM_POINT, 9), dtype=np.float32)
    return torch.from_numpy(np.concatenate([data[:4], noise])).to(dev)


def geometry_inputs(xyz: torch.Tensor):
    """The FPS inputs and the bottom-k inputs of one build_geometry."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models.pointnet2 import (
        SSG_NPOINTS, SSG_NSAMPLES, SSG_RADII,
    )

    fps_in, bk_in, levels = [], [], [xyz]
    for npoint, radius, nsample in zip(SSG_NPOINTS, SSG_RADII, SSG_NSAMPLES):
        cur = levels[-1]
        fps_in.append((cur, npoint))
        centers = ops.gather_points(cur, ops.farthest_point_sample(cur, npoint))
        n = cur.shape[1]
        sqr = ops.square_distance(centers, cur)
        arange = torch.arange(n, dtype=torch.float32, device=cur.device)
        bk_in.append((torch.where(sqr > radius * radius, float(n), arange), nsample))
        levels.append(centers)
    for li in range(4):
        bk_in.append((ops.square_distance(levels[li], levels[li + 1]), 3))
    return fps_in, bk_in


def phase_kernels(dev, records):
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bounds, fps
    from pointsecguard_tpu_torch.ops.distance import square_distance

    blocks = slice_blocks(dev)
    xyz = blocks[..., :3].contiguous()
    # the C&W smooth term's input: colour distances of a batch, [8, 4096, 4096]
    colors = blocks[..., 3:6].contiguous()
    cw_in = square_distance(colors, colors)
    fps_in, bk_in = geometry_inputs(xyz)
    start = torch.zeros(xyz.shape[0], dtype=torch.int32, device=dev)
    fps_err = 0.0  # largest index difference
    for cur, npoint in fps_in:
        got = fps.fps(cur, npoint, start)
        want = fps.fps_plain(cur, npoint, start)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fps kernel != plain at {tuple(cur.shape)}->{npoint}")
        fps_err = max(fps_err, (got - want).abs().max().item())
        print(f"fps {tuple(cur.shape)} -> {npoint}: indices equal")

    rounded = torch.round(torch.randn(
        (8, 1024, 4096), generator=torch.Generator(device=dev).manual_seed(0),
        device=dev) * 20) / 20
    bk_err = 0.0
    for vals, k in bk_in + [(rounded, 3), (rounded, 32), (cw_in, 10), (cw_in, 5)]:
        gv, gi = bottomk.bottom_k(vals, k)
        wv, wi = bottomk.bottom_k_plain(vals, k)
        torch.cuda.synchronize()
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
        bk_err = max(bk_err, (gv - wv).abs().max().item())
        print(f"bottom_k {tuple(vals.shape)} k={k}: values and indices equal")

    # the contracts' edges: N at the limit, npoint > N (wrap onto index 0),
    # a nonzero start, k == N with sentinel ties, and refusal past the limit
    gen = torch.Generator(device=dev).manual_seed(1)
    # ... and for the argmax by warp reductions: N off 32 and off the
    # thread count, the start at N - 1, a cloud of identical points (every
    # step a tie of all N: index 0 from the second step on), rounded
    # coordinates (tied maxima in different warps), one warp and 32 warps
    fps_edges = [(8192, 1024, 5, "rand"), (500, 1024, 7, "rand"), (1, 4, 0, "rand"),
                 (1000, 256, 999, "rand"), (33, 33, 32, "rand"), (4097, 64, 4096, "rand"),
                 (512, 64, 3, "same"), (1000, 300, 0, "rounded"), (8192, 128, 8191, "rounded")]
    for n, npoint, s, kind in fps_edges:
        cloud = torch.rand((2, n, 3), generator=gen, device=dev)
        if kind == "same":
            cloud = cloud[:, :1].expand(2, n, 3).contiguous()
        elif kind == "rounded":
            cloud = torch.round(cloud * 4) / 4
        st = torch.full((2,), s, dtype=torch.int32, device=dev)
        if not torch.equal(fps.fps(cloud, npoint, st), fps.fps_plain(cloud, npoint, st)):
            raise AssertionError(f"fps kernel != plain at N={n} npoint={npoint} ({kind})")
    outside = torch.tensor([500, -1], dtype=torch.int32, device=dev)
    if not (fps.fps(cloud[:, :500].contiguous(), 8, outside) == -1).all():
        raise AssertionError("fps: a start outside [0, N) must give -1")
    print(f"fps: {len(fps_edges)} edge cases (N = 1, 33, 500, 1000, 4097, 8192, npoint > N, "
          "start at N - 1, identical and rounded points) equal to plain; "
          "start outside the cloud gives -1")
    sentinel = torch.where(torch.rand((8, 16, 32), generator=gen, device=dev) < 0.7,
                           32.0, torch.arange(32.0, device=dev))
    wide = torch.rand((2, 64, 8192), generator=gen, device=dev)
    # orders that stress the selection: a descending row (every element
    # passes the threshold), a constant row (all ties), ±inf among the
    # values; widths off 4 and off 128 (the scalar-load kernel); k above
    # the warp kernel's 128 (the sorting kernel), up to k == N == 8192
    descending = -torch.arange(4096.0, device=dev).expand(64, 4096).contiguous()
    constant = torch.full((64, 4096), 2.5, device=dev)
    odd = torch.rand((5, 33, 4099), generator=gen, device=dev)
    infs = torch.where(torch.rand((64, 1000), generator=gen, device=dev) < 0.3,
                       float("inf"), torch.randn((64, 1000), generator=gen, device=dev))
    infs[:, 7] = float("-inf")
    edge_cases = (
        (wide, 48), (wide, 1), (sentinel, 32),
        (torch.rand((3, 8, 1), generator=gen, device=dev), 1),
        (descending, 10), (descending, 32), (descending, 128), (constant, 10),
        (constant, 32), (odd, 16), (odd[..., :130], 130), (odd[..., :130], 7),
        (odd[..., :2], 2), (infs, 32), (infs, 1000),
        (torch.round(odd[..., :1001] * 8) / 8, 64),
        (wide[:, :8], 129), (wide[:1, :4], 8192), (odd[:, :4], 4099),
    )
    for vals, k in edge_cases:
        vals = vals.contiguous()
        gv, gi = bottomk.bottom_k(vals, k)
        wv, wi = bottomk.bottom_k_plain(vals, k)
        torch.cuda.synchronize()
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
    print(f"bottom_k: {len(edge_cases)} edge cases (descending, constant, ±inf, "
          "N off 4 and 128, k = 1, 48, 129, N = 8192 = k) equal to plain")
    for call in (lambda: fps.fps(torch.zeros((1, fps.MAX_N + 1, 3), device=dev), 4, start[:1]),
                 lambda: bottomk.bottom_k(torch.zeros((1, 8, 8193), device=dev), 4)):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("a kernel took a shape past its limit")
    print("contract edges: N at 8192, npoint > N, k == N, N = 1 equal to plain; "
          "FPS N = 2^22 + 1 and bottom-k N = 8193 refused")

    # times at the slice's shapes: all launches of one build_geometry
    def run_fps(f):
        return lambda: [f(cur, n, start) for cur, n in fps_in]

    def run_bk(f):
        return lambda: [f(v, k) for v, k in bk_in]

    def rows_of(v):
        return v.numel() // v.shape[-1]

    work = {
        "fps": bounds.total(bounds.fps(cur.shape[0], cur.shape[1], n) for cur, n in fps_in),
        "bottom_k": bounds.total(bounds.bottom_k(rows_of(v), v.shape[-1], k)
                                 for v, k in bk_in),
    }
    for name, kern, plain, fn, reps in (
        ("fps", fps.fps, fps.fps_plain, run_fps, 5),
        ("bottom_k", bottomk.bottom_k, bottomk.bottom_k_plain, run_bk, 20),
    ):
        eager_ms = cuda_ms(fn(kern), reps=20)
        ms = device_ms(fn(kern))
        plain_ms = cuda_ms(fn(plain), reps=reps)
        record_bound(records[name], work[name])
        bound = records[name]["bound_ms"]
        print(f"{name}: kernel {ms:.4f} ms on the card ({eager_ms:.4f} ms as eager calls, "
              f"median), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({records[name]['bound_by']}; {work[name].bytes} bytes, "
              f"{work[name].operations} operations; share {bound / ms:.3f}) per "
              f"build_geometry of [{BATCH}, {NUM_POINT}]")
        records[name].update(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms)
    # a recurrence: the time of one dependent step says more than the bound
    steps = sum(n - 1 for _, n in fps_in)
    records["fps"]["ns_per_step"] = 1e6 * records["fps"]["ms"] / steps
    print(f"fps: {steps} dependent steps per build_geometry, "
          f"{records['fps']['ns_per_step']:.0f} ns per step on the card")
    records["fps"]["max_abs_err"] = fps_err
    records["bottom_k"]["max_abs_err"] = bk_err
    # the library call on the same inputs: its values must be the kernel's
    for v, k in bk_in + [(cw_in, 10)]:
        if not torch.equal(topk_library(v, k)[0], bottomk.bottom_k(v, k)[0]):
            raise AssertionError(f"torch.topk values != bottom_k at {tuple(v.shape)} k={k}")
    lib_ms = device_ms(run_bk(topk_library))
    records["bottom_k"].update(library_ms=lib_ms, library_call=TOPK_CALL)
    print(f"bottom_k: library call {TOPK_CALL} {lib_ms:.4f} ms per build_geometry")
    # one call of the C&W smooth term (NU: k = 10, tar_NU: k = 5)
    cw = {}
    for k in (10, 5):
        w = bounds.bottom_k(rows_of(cw_in), cw_in.shape[-1], k)
        cw[f"k={k}"] = {
            "shape": list(cw_in.shape),
            "ms": device_ms(lambda: bottomk.bottom_k(cw_in, k)),
            "eager_ms": cuda_ms(lambda: bottomk.bottom_k(cw_in, k), reps=20),
            "plain_ms": cuda_ms(lambda: bottomk.bottom_k_plain(cw_in, k), reps=5),
            "library_ms": device_ms(lambda: topk_library(cw_in, k)),
            "bound_ms": w.bound_ms, "bound_by": w.bound_by,
        }
        c = cw[f"k={k}"]
        print(f"bottom_k {tuple(cw_in.shape)} k={k} (one C&W step): kernel {c['ms']:.4f} ms, "
              f"plain {c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {w.bytes} bytes; share "
              f"{c['bound_ms'] / c['ms']:.3f})")
    records["bottom_k"]["cw_step"] = cw
    for vals, k, what in ((descending.expand(128, 64, 4096).contiguous(), 32, "descending"),
                          (constant.expand(128, 64, 4096).contiguous(), 32, "constant")):
        ms = device_ms(lambda: bottomk.bottom_k(vals, k))
        print(f"  bottom_k {tuple(vals.shape)} k={k} {what} rows: {ms:.4f} ms")
    for cur, n in fps_in:
        ms = device_ms(lambda: fps.fps(cur, n, start))
        print(f"  fps {tuple(cur.shape)} -> {n}: {ms:.4f} ms "
              f"({1e6 * ms / (n - 1):.0f} ns per step)")
    for v, k in bk_in:
        ms = device_ms(lambda: bottomk.bottom_k(v, k))
        lib = device_ms(lambda: topk_library(v, k))
        b = bounds.bottom_k(rows_of(v), v.shape[-1], k).bound_ms
        print(f"  bottom_k {tuple(v.shape)} k={k}: {ms:.4f} ms (bound {b:.4f} ms, "
              f"library {lib:.4f} ms)")


def train_blocks(dev, n: int = TRAIN_BATCH) -> torch.Tensor:
    """[n, 4096, 9]: the first n whole-scene blocks of a synthetic room at
    25k points/m²."""
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks
    from pointsecguard_tpu_torch.data.synthetic import make_room

    rng = np.random.default_rng(2)
    room = make_room(ROOM_POINTS, rng=rng)
    rooms = RoomSet(["smoke"], [room[:, :6]], [room[:, 6].astype(np.int64)],
                    [room[:, :3].min(0)], [room[:, :3].max(0)])
    data, *_ = WholeSceneBlocks(rooms, block_points=NUM_POINT).room_blocks(0, rng)
    return torch.from_numpy(data[:n]).to(dev)


def phase_train_kernels(dev, records) -> None:
    """FPS and bottom-k at the shapes of one training step: a
    ``build_geometry`` of [32, 4096] with one random FPS start per cloud
    and level. Equal to plain; times as in ``phase_kernels``."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models.pointnet2 import (
        SSG_NPOINTS, SSG_NSAMPLES, SSG_RADII,
    )
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bounds, fps

    xyz = train_blocks(dev)[..., :3].contiguous()
    gen = torch.Generator(device=dev).manual_seed(5)
    fps_in, bk_in, levels = [], [], [xyz]
    for npoint, radius, nsample in zip(SSG_NPOINTS, SSG_RADII, SSG_NSAMPLES):
        cur = levels[-1]
        n = cur.shape[1]
        start = torch.randint(0, n, (cur.shape[0],), generator=gen, device=dev,
                              dtype=torch.int32)
        got = fps.fps(cur, npoint, start)
        torch.cuda.synchronize()
        if not torch.equal(got, fps.fps_plain(cur, npoint, start)):
            raise AssertionError(f"fps kernel != plain at {tuple(cur.shape)}->{npoint}, "
                                 "random starts")
        if not torch.equal(got[:, 0], start):
            raise AssertionError("fps does not begin at the start it was given")
        fps_in.append((cur, npoint, start))
        centers = ops.gather_points(cur, got)
        sqr = ops.square_distance(centers, cur)
        arange = torch.arange(n, dtype=torch.float32, device=dev)
        bk_in.append((torch.where(sqr > radius * radius, float(n), arange), nsample))
        levels.append(centers)
    for li in range(4):
        bk_in.append((ops.square_distance(levels[li], levels[li + 1]), 3))
    for vals, k in bk_in:
        gv, gi = bottomk.bottom_k(vals, k)
        wv, wi = bottomk.bottom_k_plain(vals, k)
        torch.cuda.synchronize()
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
        if not torch.equal(topk_library(vals, k)[0], gv):
            raise AssertionError(f"torch.topk values != bottom_k at {tuple(vals.shape)} k={k}")
        del wv, wi
    print(f"train step shapes: fps at 4 levels of [{TRAIN_BATCH}, {NUM_POINT}] with random "
          "starts and bottom_k on its 8 inputs equal to plain")

    def rows_of(v):
        return v.numel() // v.shape[-1]

    def run_fps(f):
        return lambda: [f(cur, n, st) for cur, n, st in fps_in]

    def run_bk(f):
        return lambda: [f(v, k) for v, k in bk_in]

    work = {
        "fps": bounds.total(bounds.fps(c.shape[0], c.shape[1], n) for c, n, _ in fps_in),
        "bottom_k": bounds.total(bounds.bottom_k(rows_of(v), v.shape[-1], k)
                                 for v, k in bk_in),
    }
    for name, kern, plain, fn, reps in (
        ("fps", fps.fps, fps.fps_plain, run_fps, 3),
        ("bottom_k", bottomk.bottom_k, bottomk.bottom_k_plain, run_bk, 5),
    ):
        rec = {"unit": f"one build_geometry of [{TRAIN_BATCH}, {NUM_POINT}], random starts",
               "eager_ms": cuda_ms(fn(kern), reps=20), "ms": device_ms(fn(kern)),
               "plain_ms": cuda_ms(fn(plain), reps=reps),
               "bound_ms": work[name].bound_ms, "bound_by": work[name].bound_by,
               "library_ms": None}
        if name == "bottom_k":
            rec["library_ms"] = device_ms(run_bk(topk_library))
        print(f"{name} (train step): kernel {rec['ms']:.4f} ms on the card "
              f"({rec['eager_ms']:.4f} ms as eager calls, median), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
              f"{work[name].bytes} bytes, {work[name].operations} operations; share "
              f"{rec['bound_ms'] / rec['ms']:.3f}), library {rec['library_ms']} ms per "
              f"build_geometry of [{TRAIN_BATCH}, {NUM_POINT}]")
        records[name]["train_step"] = rec
    for cur, n, st in fps_in:
        ms = device_ms(lambda: fps.fps(cur, n, st))
        print(f"  fps {tuple(cur.shape)} -> {n}: {ms:.4f} ms "
              f"({1e6 * ms / (n - 1):.0f} ns per step)")
    for v, k in bk_in:
        ms = device_ms(lambda: bottomk.bottom_k(v, k))
        b = bounds.bottom_k(rows_of(v), v.shape[-1], k).bound_ms
        print(f"  bottom_k {tuple(v.shape)} k={k}: {ms:.4f} ms (bound {b:.4f} ms)")


def msg_kernel_inputs(xyz: torch.Tensor, starts):
    """The FPS and bottom-k inputs of one ``build_geometry_msg`` from the
    given starts (one [B] tensor a level): per level the cloud and its
    start, one ball-query row set per radius (index values, the sentinel
    N out of the radius), then the four 3-NN distance sets."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models.pointnet2 import MSG_SPEC
    from pointsecguard_tpu_torch.ops.cuda import fps

    fps_in, bk_in, levels = [], [], [xyz]
    for (npoint, radii, nsamples), start in zip(MSG_SPEC, starts):
        cur = levels[-1]
        n = cur.shape[1]
        fps_in.append((cur, npoint, start))
        centers = ops.gather_points(cur, fps.fps(cur, npoint, start))
        sqr = ops.square_distance(centers, cur)
        arange = torch.arange(n, dtype=torch.float32, device=cur.device)
        for radius, nsample in zip(radii, nsamples):
            bk_in.append((torch.where(sqr > radius * radius, float(n), arange), nsample))
        levels.append(centers)
    for li in range(len(MSG_SPEC)):
        bk_in.append((ops.square_distance(levels[li], levels[li + 1]), 3))
    return fps_in, bk_in


def phase_msg_kernels(dev, records) -> None:
    """35. FPS and bottom-k at the shapes of PointNet++ MSG: one
    ``build_geometry_msg`` of [8, 4096] from index 0 (an attack batch) and
    of [32, 4096] with a random start per cloud and level (a train step):
    4 FPS and 12 bottom-k calls each (k = 16 and 32 on rows up to [B,
    1024, 4096], k = 3 for the 3-NN). Kernel equal to plain (indices, and
    values, so the 3-NN weights too), the geometry the kernels' inputs
    give equal to ``build_geometry_msg``'s, ``torch.topk``'s values equal;
    times as in ``phase_kernels`` (a kernel phase)."""
    from pointsecguard_tpu_torch.models import build_geometry_msg
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bounds, fps
    from pointsecguard_tpu_torch.ops.interpolate import inverse_distance_weights

    gen = torch.Generator(device=dev).manual_seed(7)
    sizes = (NUM_POINT, 1024, 256, 64)
    for key, xyz, random_starts in (
            ("msg_attack", slice_blocks(dev)[..., :3].contiguous(), False),
            ("msg_train_step", train_blocks(dev)[..., :3].contiguous(), True)):
        b = xyz.shape[0]
        starts = [torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
                  if random_starts else torch.zeros(b, dtype=torch.int32, device=dev)
                  for n in sizes]
        fps_in, bk_in = msg_kernel_inputs(xyz, starts)
        geo = build_geometry_msg(xyz, start_idx=starts)
        for li, (cur, npoint, st) in enumerate(fps_in):
            got = fps.fps(cur, npoint, st)
            if not torch.equal(got, fps.fps_plain(cur, npoint, st)):
                raise AssertionError(f"fps kernel != plain at {tuple(cur.shape)}->{npoint}")
            if not torch.equal(geo["sa"][li][0], cur.gather(
                    1, got.long()[..., None].expand(-1, -1, 3))):
                raise AssertionError(f"build_geometry_msg centres != the kernel's, level {li}")
        weights = []
        for j, (vals, k) in enumerate(bk_in):
            gv, gi = bottomk.bottom_k(vals, k)
            wv, wi = bottomk.bottom_k_plain(vals, k)
            if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
                raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
            if not torch.equal(topk_library(vals, k)[0], gv):
                raise AssertionError(f"torch.topk values != bottom_k at {tuple(vals.shape)} "
                                     f"k={k}")
            if j < 8:  # a ball query: index values, the sentinel N → the first
                n = vals.shape[-1]
                g = gv.to(torch.int32)
                want = geo["sa"][j // 2][1][j % 2]
                if not torch.equal(torch.where(g == n, g[..., :1], g), want):
                    raise AssertionError(f"build_geometry_msg groups != the kernel's ({j})")
            else:  # a 3-NN plan: indices and the weights of kernel and plain
                w_k, w_p = (inverse_distance_weights(v) for v in (gv, wv))
                idx, w = geo["fp"][j - 8]
                if not (torch.equal(w_k, w_p) and torch.equal(gi, idx) and torch.equal(w_k, w)):
                    raise AssertionError(f"3-NN plan differs kernel vs plain ({j - 8})")
                weights.append(w_k)
            del wv, wi
        torch.cuda.synchronize()
        print(f"msg geometry [{b}, {NUM_POINT}]{', random starts' if random_starts else ''}: "
              "fps at 4 levels and bottom_k on its 12 inputs (8 ball queries at k = 16 / 32, "
              "4 three-NN) equal to plain, 3-NN weights equal, build_geometry_msg equal")

        def rows_of(v):
            return v.numel() // v.shape[-1]

        def run_fps(f, fps_in=fps_in):
            return lambda: [f(cur, n, st) for cur, n, st in fps_in]

        def run_bk(f, bk_in=bk_in):
            return lambda: [f(v, k) for v, k in bk_in]

        work = {
            "fps": bounds.total(bounds.fps(c.shape[0], c.shape[1], n) for c, n, _ in fps_in),
            "bottom_k": bounds.total(bounds.bottom_k(rows_of(v), v.shape[-1], k)
                                     for v, k in bk_in),
        }
        unit = (f"one build_geometry_msg of [{b}, {NUM_POINT}]"
                + (", random starts" if random_starts else ""))
        for name, kern, plain, fn, reps in (
            ("fps", fps.fps, fps.fps_plain, run_fps, 3),
            ("bottom_k", bottomk.bottom_k, bottomk.bottom_k_plain, run_bk, 5),
        ):
            rec = {"unit": unit, "eager_ms": cuda_ms(fn(kern), reps=20),
                   "ms": device_ms(fn(kern)), "plain_ms": cuda_ms(fn(plain), reps=reps),
                   "bound_ms": work[name].bound_ms, "bound_by": work[name].bound_by,
                   "library_ms": device_ms(run_bk(topk_library)) if name == "bottom_k"
                   else None, "calls": len(fps_in) if name == "fps" else len(bk_in)}
            print(f"{name} (MSG): kernel {rec['ms']:.4f} ms on the card "
                  f"({rec['eager_ms']:.4f} ms as eager calls, median), plain "
                  f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}; {work[name].bytes} bytes, {work[name].operations} "
                  f"operations; share {rec['bound_ms'] / rec['ms']:.3f}), library "
                  f"{rec['library_ms']} ms per {unit}")
            records[name][key] = rec
        for cur, n, st in fps_in:
            ms = device_ms(lambda: fps.fps(cur, n, st))
            print(f"  fps {tuple(cur.shape)} -> {n}: {ms:.4f} ms "
                  f"({1e6 * ms / (n - 1):.0f} ns per step)")
        for v, k in bk_in:
            ms = device_ms(lambda: bottomk.bottom_k(v, k))
            lib = device_ms(lambda: topk_library(v, k))
            bd = bounds.bottom_k(rows_of(v), v.shape[-1], k).bound_ms
            print(f"  bottom_k {tuple(v.shape)} k={k}: {ms:.4f} ms (bound {bd:.4f} ms, "
                  f"library {lib:.4f} ms)")
        del fps_in, bk_in, geo, weights


def phase_block_reference(dev, model: str) -> dict:
    """36. Card vs CPU for a block model (MSG or PointNet), calibrated
    seeded weights, on two blocks: for MSG the geometry built on both (FPS
    centres equal, neighbour indices in agreement) and the card's shared;
    then the log-probabilities and the colour gradient of the NB loss (the
    summed per-point cross-entropy of random labels) on the card and on
    the CPU, each in float32 and in float64.

    In float64 the card computes what the CPU does: log-probabilities and
    gradient within 1e-6 (relative to the largest, and in relative L2).
    In float32 the card's log-probabilities are no further from float64
    than twice the CPU's (plus 1e-6 of the largest), and within 4e-4 of
    the largest of the CPU's: calibrated BatchNorm statistics leave
    channels of near-zero variance that scale rounding on both devices
    alike (as in ``phase_resgcn_reference``). The float32 colour gradient
    is held within 5 % of float64 in relative L2: it runs through maxima
    over groups of repeated and nearly tied points (two thirds of MSG's
    first-level maxima are exact ties), so float32 rounding alone moves
    MSG's by 2.8 % on an H100 80GB HBM3 and 0.6 to 1.5 % on two CPUs
    (SSG's and PointNet's by under 0.06 %)."""
    from pointsecguard_tpu_torch.attacks.common import per_point_ce
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS

    model_cls, family = POINTNET_MODELS[model]
    net = model_cls()
    net.load_state_dict(calibrated_state_dict(1, dev, model))
    net.eval()
    pts = slice_blocks(dev)[[0, 4]].contiguous()
    geo = family.plan(pts)
    agree = [1.0]
    if geo is not None:
        geo_cpu = family.plan(pts.cpu())
        for li in range(4):
            if not torch.equal(geo["sa"][li][0].cpu(), geo_cpu["sa"][li][0]):
                raise AssertionError(f"{model}: FPS centres differ card vs CPU at level {li}")
        agree = [(g.cpu() == c).float().mean().item()
                 for g, c in zip(_neighbour_indices(geo), _neighbour_indices(geo_cpu))]
        if min(agree) < 0.999:
            raise AssertionError(f"{model}: card/CPU neighbour agreement {min(agree)} < 0.999")
    labels = torch.randint(0, 13, pts.shape[:2], generator=torch.Generator().manual_seed(5))
    out = {}
    cpu = torch.device("cpu")
    for name, device, dtype in (("card", dev, torch.float32), ("card64", dev, torch.float64),
                                ("cpu", cpu, torch.float32), ("float64", cpu, torch.float64)):
        m = net.to(device=device, dtype=dtype)
        p = pts.to(device=device, dtype=dtype).clone().requires_grad_(True)
        lp = family.head(family.apply(m, p, _to_device(geo, device, dtype)))
        per_point_ce(lp, labels.to(device)).sum().backward()
        out[name] = (lp.detach().double().cpu(), p.grad[..., 3:6].double().cpu())
    ref_lp, ref_grad = out["float64"]
    scale = ref_lp.abs().max().item()
    err = {n: (out[n][0] - ref_lp).abs().max().item() / scale for n in ("card", "card64", "cpu")}
    grad_err = {n: _rel_l2(out[n][1], ref_grad) for n in ("card", "card64", "cpu")}
    card_cpu = (out["card"][0] - out["cpu"][0]).abs().max().item() / scale
    res = {"neighbour_agreement_min": min(agree), "largest_log_prob": scale,
           "log_probs_card_vs_cpu_over_largest": card_cpu,
           "log_probs_vs_cpu_float64_over_largest": err,
           "colour_grad_card_vs_cpu_rel_l2": _rel_l2(out["card"][1], out["cpu"][1]),
           "colour_grad_vs_cpu_float64_rel_l2": grad_err}
    print(f"{model} card vs CPU: " + json.dumps(res))
    ok = (torch.isfinite(out["card"][0]).all() and out["card"][0].shape == (2, NUM_POINT, 13)
          and err["card64"] <= 1e-6 and grad_err["card64"] <= 1e-6
          and err["card"] <= 2 * err["cpu"] + 1e-6 and card_cpu <= 4e-4
          and grad_err["card"] <= 0.05)
    if not ok:
        raise AssertionError(f"the card's {model} disagrees with the CPU's")
    return res


def _to_device(geo, device, dtype):
    """A geometry plan on ``device``, its floating tensors (centres, 3-NN
    weights) in ``dtype``, its indices as they are."""
    if isinstance(geo, dict):
        return {k: _to_device(v, device, dtype) for k, v in geo.items()}
    if isinstance(geo, tuple):
        return tuple(_to_device(v, device, dtype) for v in geo)
    if geo is None:
        return None
    return geo.to(device=device, dtype=dtype if geo.is_floating_point() else geo.dtype)


def random_state_dict(seed: int, model: str = "pointnet2") -> dict:
    """Full-width weights of a block model of the PointNet family (SSG by
    default) from a seeded generator: every Linear's weight and bias
    uniform in ±1/sqrt(fan_in) (torch's default bound); BatchNorm at its
    initial scale 1, bias 0, mean 0, var 1."""
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS

    gen = torch.Generator().manual_seed(seed)
    net = POINTNET_MODELS[model][0]()
    linear = {name for name, m in net.named_modules() if isinstance(m, torch.nn.Linear)}
    sd = net.state_dict()
    for key, t in sd.items():
        mod = key.rpartition(".")[0]
        if mod in linear:
            bound = 1.0 / math.sqrt(sd[mod + ".weight"].shape[1])
            t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)
    n = sum(t.numel() for t in sd.values())
    if n != MODEL_STATE_FLOATS[model]:
        raise AssertionError(f"{model} state dict holds {n} floats, "
                             f"want {MODEL_STATE_FLOATS[model]}")
    return sd


def calibrated_state_dict(seed: int, dev, model: str = "pointnet2") -> dict:
    """``random_state_dict`` with BatchNorm running statistics set from
    one train-mode forward over four synthetic blocks (keep fraction 0),
    so the random network's predictions vary from point to point and the
    attack has decisions to flip."""
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS

    net = POINTNET_MODELS[model][0]()
    net.load_state_dict(random_state_dict(seed, model))
    net.to(dev).train()
    with torch.no_grad():
        net(slice_blocks(dev)[:4], momentum=0.0)
    return net.state_dict()


def check_geometry_launches(model: str, counts: dict, geometries: int, what: str) -> None:
    """Exactly ``GEOMETRY_LAUNCHES[model]`` FPS and bottom-k launches per
    geometry built, and no kernel off the path."""
    want = {k: n * geometries for k, n in GEOMETRY_LAUNCHES[model].items()}
    got = {k: counts[k] for k in want}
    if got != want or any(counts[k] for k in counts if k not in want):
        raise AssertionError(f"{model} {what} launches {counts}, want {want} "
                             f"({geometries} geometries)")
    if not any(want.values()):
        print(f"{model} {what}: no kernel launched (PointNet builds no neighbourhood): "
              + json.dumps(counts))


def read_tsv(path: str) -> list[dict]:
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        return [dict(zip(header, line.rstrip("\n").split("\t"))) for line in f]


def phase_slice(dev, records, data: str, model: str = "pointnet2") -> dict:
    """NB through ``cli.attack.main`` on 32 blocks at batch 8 with the
    calibrated random checkpoint of ``model``: one geometry's launches a
    batch (``GEOMETRY_LAUNCHES``), finite output."""
    from pointsecguard_tpu_torch.cli import attack
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    log = os.path.join(WORK, "log" if model == "pointnet2" else f"log_{model}")
    save_checkpoint(log, calibrated_state_dict(0, dev, model))
    argv = ["--model", model, "--attack", "nb", "--data_root", data,
            "--log_dir", log, "--num_point", str(NUM_POINT),
            "--batch_size", str(BATCH), "--max_blocks", str(MAX_BLOCKS)]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = attack.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    rows = read_tsv(os.path.join(log, f"{model}_nb_area5.tsv"))
    if len(rows) < MAX_BLOCKS:
        raise AssertionError(f"{len(rows)} TSV rows, want {MAX_BLOCKS}")
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s")}
    iters = int(rows[0]["steps"])
    # each row carries its batch's wall time / batch size
    ms_block = 1e3 * col["time_s"]
    warm = ms_block[BATCH:]  # the first batch pays one-off CUDA set-up
    stats = {
        "blocks": len(rows),
        "nb_iters": iters,
        "ms_per_block_mean": float(ms_block.mean()),
        "ms_per_block_warm_median": float(np.median(warm)),
        "wall_nb_iters_per_s": len(rows) * iters / float(col["time_s"].sum()),
        "main_wall_s": wall,
        "clean_acc": float(col["clean_acc"].mean()),
        "adv_acc": float(col["adv_acc"].mean()),
        "l2_mean": float(col["l2"].mean()),
        "clean_miou": clean_m.miou,
        "adv_miou": adv_m.miou,
        "launches": counts,
    }
    print(("slice: " if model == "pointnet2" else f"{model} nb: ") + json.dumps(stats))
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("non-finite value in the slice's output")
    batches = len(rows) // BATCH
    check_geometry_launches(model, counts, batches, "nb")
    for name, per in GEOMETRY_LAUNCHES[model].items():
        if per:
            records[name].setdefault("launches_by_path", {})[f"{model} nb"] = counts[name]
            records[name].setdefault("calls_per_batch", {})[f"{model} nb"] = (
                counts[name] / batches)
    return stats


def phase_reference(dev) -> None:
    """Port on the card (kernels) vs the port on the CPU (plain versions)
    on two blocks: FPS indices equal, ball-query / 3-NN agreement, and
    log-probabilities on the same geometry within 1e-4 of the largest."""
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry

    model = PointNet2SemSegSSG()
    model.load_state_dict(calibrated_state_dict(1, dev))
    model.eval()
    pts = slice_blocks(dev)[[0, 4]]
    geo_gpu = build_geometry(pts[..., :3])
    geo_cpu = build_geometry(pts[..., :3].cpu())
    for li in range(4):
        if not torch.equal(geo_gpu["sa"][li][0].cpu(), geo_cpu["sa"][li][0]):
            raise AssertionError(f"FPS centres differ card vs CPU at level {li}")
    # ball-query groups (sa, item 1) and 3-NN indices (fp, item 0): the
    # distance product may round differently on the card than on the CPU
    agree = [
        (geo_gpu[part][li][item].cpu() == geo_cpu[part][li][item]).float().mean().item()
        for part, item in (("sa", 1), ("fp", 0)) for li in range(4)
    ]
    if min(agree) < 0.999:
        raise AssertionError(f"card/CPU neighbour agreement {min(agree)} < 0.999")
    geo_shared = {k: tuple(tuple(t.cpu() for t in p) for p in v)
                  for k, v in geo_gpu.items()}
    with torch.no_grad():
        lp_gpu = model.to(dev)(pts, geometry=geo_gpu)[0].cpu()
        lp_cpu = model.cpu()(pts.cpu(), geometry=geo_shared)[0]
    # float32 sums run in another order on the card than on the CPU; the
    # difference grows with the magnitude of what is summed, so the bound
    # is relative to the largest log-probability
    err = (lp_gpu - lp_cpu).abs().max().item()
    tol = 1e-4 * max(1.0, lp_cpu.abs().max().item())
    print(f"reference: card vs CPU log-probs max |diff| {err:.3e} "
          f"(tolerance {tol:.3e}); neighbour agreement min {min(agree):.6f}")
    if not (lp_gpu.shape == (2, NUM_POINT, 13) and torch.isfinite(lp_gpu).all()
            and err <= tol):
        raise AssertionError("card log-probs disagree with the CPU reference")


def prepare_randla(data: str) -> str:
    """The synthetic rooms prepared as RandLA clouds (0.04 m grid, KD-tree,
    projection, and the full-resolution ``original_ply`` beside them, as
    ``cli.prepare`` lays them out); the Area-5 cloud must keep ≥ 40960
    points."""
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler, prepare_room

    prep = os.path.join(WORK, "randla_input_0.040")
    for name in sorted(os.listdir(data)):
        prepare_room(os.path.join(data, name), prep, 0.04,
                     original_dir=os.path.join(WORK, "original_ply"))
    sizes = {c.name: len(c.labels) for c in
             SpatiallyRegularSampler.load(prep, split="test").clouds}
    print(f"randla clouds (test split, 0.04 m grid): {sizes}")
    if min(sizes.values()) < RANDLA_POINTS:
        raise AssertionError(f"a test cloud holds fewer than {RANDLA_POINTS} points")
    return prep


def randla_batch(prep: str, dev, num_points: int = RANDLA_POINTS, batch: int = RANDLA_BATCH):
    """One sampler batch of features [B, P, 6] on the card."""
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler

    sampler = SpatiallyRegularSampler.load(prep, split="test", num_points=num_points,
                                           rng=np.random.default_rng(7))
    _, feats, _, _, _ = next(sampler.batches(batch, 1))
    return torch.from_numpy(feats).to(dev)


def pyramid_knn_inputs(xyz: torch.Tensor, ratios=(4, 4, 4, 4, 2)):
    """The (query, points, k) of every kNN call of one build_pyramid."""
    calls, cur = [], xyz
    for ratio in ratios:
        sub = cur[:, : cur.shape[1] // ratio]
        calls += [(cur, cur, 16), (cur, sub, 1)]
        cur = sub
    return calls


def _equal(name, got, want) -> float:
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{name}: kernel != plain")
    return (got[0] - want[0]).abs().max().item()


def knn_stress(dev, knn, gen):
    """Orders and shapes that stress the fused kNN's deferred insertion,
    each equal to the plain version; returns the (query, points) of three
    orders of the same points, for timing.

    Far -> near: the queries huddle around the cube's centre and the
    points come sorted by falling distance from it, so nearly every point
    is below a query's k-th value when it is scanned (the queue's worst
    case). A constant cloud ties every distance (indices 0..k-1); a
    duplicated cloud ties pairs; S and N off the block, tile and group
    sizes; k == N; one query; ``query is points`` and a distinct query."""
    B, S, N = 4, 4096, 40960
    pts = torch.rand((B, N, 3), generator=gen, device=dev)
    centre = torch.full((3,), 0.5, device=dev)
    order = torch.argsort(((pts - centre) ** 2).sum(-1), dim=-1, descending=True)
    far = torch.gather(pts, 1, order[..., None].expand(B, N, 3)).contiguous()
    q = (centre + 1e-3 * torch.randn((B, S, 3), generator=gen, device=dev)).contiguous()
    constant = torch.full((2, 1000, 3), 0.3, device=dev)
    dup = torch.rand((2, 3000, 3), generator=gen, device=dev)
    dup[:, 1500:] = dup[:, :1500]
    odd_q = torch.rand((3, 1000, 3), generator=gen, device=dev)
    odd_p = torch.rand((3, 4099, 3), generator=gen, device=dev)
    tiny = torch.rand((2, 16, 3), generator=gen, device=dev)
    near = far[:, -2048:].contiguous()
    one = torch.rand((1, 1, 3), generator=gen, device=dev)
    cases = [
        ("far -> near", q, far, 16), ("far -> near", q, far, 1), ("random", q, pts, 16),
        ("far -> near, query is points", near, near, 16),
        ("near -> far", q[:, :512], far.flip(1).contiguous(), 16),
        ("constant", constant, constant, 16), ("constant", constant[:, :7], constant, 1),
        ("duplicated", dup, dup, 16), ("duplicated, distinct query", dup.clone(), dup, 16),
        ("S, N off the block and tile", odd_q, odd_p, 16), ("S, N off", odd_q, odd_p, 1),
        ("N off the group", odd_q[:, :33], odd_p[:, :513], 5),
        ("k == N == 16", tiny, tiny, 16), ("B = S = 1", one, odd_p[:1, :777], 5),
        ("k = 48, D = 3", odd_q[:, :300], odd_p, 48), ("k = 17", odd_q[:, :300], odd_p, 17),
        ("k = 48, far -> near", q[:1, :256], far[:1, :8192].contiguous(), 48),
    ]
    for what, a, b, k in cases:
        _equal(f"knn {what} {tuple(a.shape)} x {tuple(b.shape)} k={k}",
               knn.knn(a, b, k), knn.knn_plain(a, b, k))
    idx = knn.knn(constant, constant, 16)[1]
    if not torch.equal(idx, torch.arange(16, dtype=torch.int32, device=dev).expand_as(idx)):
        raise AssertionError("knn on a constant cloud: indices are not 0..k-1")
    print(f"knn: {len(cases)} stress cases (far -> near, near -> far, constant, duplicated, "
          "S and N off the block / tile / group, k == N, one query, query is points and "
          "distinct, k = 17 and 48 at D = 3) equal to plain")
    # as many huddled queries as a cloud has points, against the points
    # near -> far: after the first few nothing hits, so this is the time
    # of the scan alone
    q_full = (centre + 1e-3 * torch.randn((B, N, 3), generator=gen, device=dev)).contiguous()
    return {"far -> near": (q, far), "random": (q, pts),
            "near -> far (the scan alone)": (q_full, far.flip(1).contiguous())}


def knn_any_d_edges(dev, knn, gen) -> int:
    """The any-D kNN kernel (``knn_tiled_kernel``) at the edges of its
    tiling, each equal to the plain version in values and indices: D off
    and on the 16-coordinate chunk up to the contract's widest, S off the
    128-query block, N off the 64-point tile, k at 1, 16, 17, 48 and k == N,
    ``query is points`` and a distinct query, a quarter-grid tie-heavy
    cloud, a constant cloud and points sorted far → near from huddled
    queries. The coordinates lie on grids fine enough to be varied but
    coarse enough that every product and sum is exact, so cuBLAS's
    product in the plain version rounds nothing at any D; the rounding
    chain on real features is phase 27's. Returns the number of cases."""

    def grid(B, n, D, step=16, lo=-2.0, hi=2.0):
        x = lo + (hi - lo) * torch.rand((B, n, D), generator=gen, device=dev)
        return torch.round(x * step) / step

    def far_to_near(B, S, N, D):
        pts = grid(B, N, D, 16, 0.0, 2.0)
        order = torch.argsort(((pts - 1.0) ** 2).sum(-1), dim=-1, descending=True)
        pts = torch.gather(pts, 1, order[..., None].expand(B, N, D)).contiguous()
        q = 1.0 + torch.round(0.05 * torch.randn((B, S, D), generator=gen, device=dev) * 64) / 64
        return q, pts

    quarter = lambda B, n, D: grid(B, n, D, 4, 0.0, 1.0)  # noqa: E731
    same = lambda x: (x, x)  # noqa: E731  query is points
    cases = [  # (what, query, points, k)
        ("D = 1, query is points", *same(grid(2, 4096, 1)), 16),
        ("D = 2, S = 1, N = 4099", grid(2, 1, 2), grid(2, 4099, 2), 48),
        ("D = 4, quarter grid, S = 127, N = 63", quarter(2, 127, 4), quarter(2, 63, 4), 17),
        ("D = 9, quarter grid, S = 129, N = 65", quarter(2, 129, 9), quarter(2, 65, 9), 48),
        ("D = 31, N = 1", grid(2, 300, 31), grid(2, 1, 31), 1),
        ("D = 33, k == N == 16, query is points", *same(grid(2, 16, 33)), 16),
        ("D = 63, constant", *same(torch.full((2, 1000, 63), 0.5, device=dev)), 48),
        ("D = 64, far -> near", *far_to_near(2, 256, 4099, 64), 48),
        ("D = 64, far -> near, k = 1", *far_to_near(2, 129, 4099, 64), 1),
        ("D = 65, query is points", *same(grid(1, 4096, 65)), 16),
        ("D = 65, k == N == 48", grid(2, 100, 65), grid(2, 48, 65), 48),
        ("D = 128, quarter grid, S = 129, N = 4099", quarter(2, 129, 128),
         quarter(2, 4099, 128), 17),
        ("D = 512, S = 127, N = 600", grid(2, 127, 512), grid(2, 600, 512), 48),
        (f"D = {knn.MAX_D}, S = 64, N = 300", grid(2, 64, knn.MAX_D), grid(2, 300, knn.MAX_D),
         16),
    ]
    x = grid(2, 700, 64)
    cases.append(("D = 64, query is points and a distinct copy", x, x.clone(), 16))
    for what, q, p, k in cases:
        _equal(f"knn {what} {tuple(q.shape)} x {tuple(p.shape)} k={k}",
               knn.knn(q, p, k), knn.knn_plain(q, p, k))
    idx = knn.knn(cases[6][1], cases[6][2], 48)[1]
    if not torch.equal(idx, torch.arange(48, dtype=torch.int32, device=dev).expand_as(idx)):
        raise AssertionError("knn on a constant cloud at D = 63: indices are not 0..k-1")
    print(f"knn any-D kernel: {len(cases)} tiling edges (D = 1 … {knn.MAX_D}, S off the block, "
          "N off the tile, k = 1, 16, 17, 48 and k == N, query is points and distinct, "
          "quarter-grid, constant, far -> near) equal to plain")
    return len(cases)


def ball_query_edge_rows(real: torch.Tensor, k: int) -> dict:
    """Rows that stress the wide-row bottom-k's threshold, built from real
    ball-query rows [..., N] (index values, the sentinel N out of radius):
    none in radius (T = N, the sentinel tied across the row), 5 and k − 1
    of the first row's points in radius, every value equal, and a run of
    300 columns in radius (T = N with 300 entries below it: more than the
    short list holds, so the kernel's exact branch runs)."""
    N = real.shape[-1]
    cols = torch.arange(N, dtype=torch.float32, device=real.device)
    inside = real.reshape(-1, N)[0] < N

    def first(m):
        return torch.where(inside & (torch.cumsum(inside, 0) <= m), cols, float(N))[None]

    return {"none in radius": torch.full((1, N), float(N), device=real.device),
            "5 in radius": first(5), f"{k - 1} in radius": first(k - 1),
            "every value equal": torch.full((1, N), 0.5, device=real.device),
            "a run of 300 in radius": torch.where((cols >= 1000) & (cols < 1300), cols,
                                                  float(N))[None]}


def check_chunked_rows(what: str, rows: dict, k: int) -> dict:
    """Each set of rows through ``psg::bottom_k_chunked`` equal to
    ``bottom_k_plain``, values and indices; the rows that took the
    kernel's exact branch, counted by the kernel, equal to
    ``overflow_rows_plain``'s; the built run of 300 must take it (k > 1)."""
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked

    ran = {}
    for name, vals in rows.items():
        got, want = bottomk_chunked.bottom_k_chunked(vals, k), bottomk.bottom_k_plain(vals, k)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"bottom_k_chunked != plain: {what}, {name}")
        ran[name] = bottomk_chunked.overflow_rows(vals, k)
        plain = int(bottomk_chunked.overflow_rows_plain(vals, k).sum())
        if ran[name] != plain:
            raise AssertionError(f"bottom_k_chunked {what}, {name}: the exact branch ran on "
                                 f"{ran[name]} rows, the rule says {plain}")
    # (at k = 1 the list holds the row's first minimum alone: no branch)
    if k > 1 and ran.get("a run of 300 in radius", 1) != 1:
        raise AssertionError(f"bottom_k_chunked {what}: the built row missed the exact branch")
    print(f"bottom_k_chunked {what}: equal to plain on " + ", ".join(
        f"{name} ({rows[name].numel() // rows[name].shape[-1]} rows, exact branch ran on "
        f"{ran[name]})" for name in rows))
    return ran


def phase_randla_kernels(dev, records, xyz):
    from pointsecguard_tpu_torch.ops import gather_points
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked, bounds, fps, knn
    from pointsecguard_tpu_torch.ops.distance import square_distance

    calls = pyramid_knn_inputs(xyz)
    gen = torch.Generator(device=dev).manual_seed(2)
    feat64 = torch.randn((1, 4096, 64), generator=gen, device=dev)
    feat4 = torch.round(torch.randn((2, 2048, 4), generator=gen, device=dev) * 4) / 4
    knn_err = 0.0
    # the pyramid's calls (D = 3 kernel, k = 1 and 16), then the any-D
    # kernel, with k below its list size (8 of 16) and at the bound (48)
    for q, p, k in calls + [(feat64, feat64, 16), (feat4, feat4, 8),
                            (feat64[:, :1024], feat64, 48)]:
        knn_err = max(knn_err, _equal(f"knn {tuple(q.shape)} x {tuple(p.shape)} k={k}",
                                      knn.knn(q, p, k), knn.knn_plain(q, p, k)))
        print(f"knn {tuple(q.shape)} x {tuple(p.shape)} k={k}: values and indices equal")

    stress_orders = knn_stress(dev, knn, gen)
    knn_any_d_edges(dev, knn, gen)

    dists = square_distance(xyz[:, :4096], xyz)  # a tile of the tiled route
    rounded = torch.round(dists * 4) / 4
    bk_err = 0.0
    odd = torch.round(torch.rand((2, 64, 8193), generator=gen, device=dev) * 64) / 64
    widest = torch.round(torch.rand((1, 2, bottomk_chunked.MAX_N), generator=gen,
                                    device=dev) * 4096)
    for vals, k in ((dists, 16), (rounded, 16), (odd, 1), (odd, 32),
                    (torch.rand((2, 64, 8193), generator=gen, device=dev), 48),
                    (torch.rand((1, 4, 1 << 20), generator=gen, device=dev), 16),
                    (widest, 1), (widest, 32), (widest, 48)):
        bk_err = max(bk_err, _equal(f"bottom_k_chunked {tuple(vals.shape)} k={k}",
                                    bottomk_chunked.bottom_k_chunked(vals, k),
                                    bottomk.bottom_k_plain(vals, k)))
        print(f"bottom_k_chunked {tuple(vals.shape)} k={k}: values and indices equal")
    # the 10,000-point ball query's rows (a random cloud's 512 FPS centres,
    # radius 0.2) and the rows built from them, at k = 1, 32, 48
    cloud = torch.rand((2, 10000, 3), generator=gen, device=dev)
    centers = gather_points(cloud, fps.fps(cloud, 512, torch.zeros(2, dtype=torch.int32,
                                                                      device=dev)))
    ball = torch.where(square_distance(centers, cloud) > 0.04, 10000.0,
                       torch.arange(10000, dtype=torch.float32, device=dev))
    for k in (1, 32, 48):
        check_chunked_rows(f"[2, 10000] cloud's ball query k={k}",
                           {"its rows": ball, **ball_query_edge_rows(ball, k)}, k)
    refused = (
        lambda: knn.knn(xyz[:, :64], xyz[:, :64], 49),
        lambda: knn.knn(feat64, feat64, 49),
        lambda: knn.knn(xyz[:, :8], xyz[:, :8], 9),
        lambda: knn.knn(*(2 * [torch.zeros((1, 64, knn.MAX_D + 1), device=dev)]), 16),
        lambda: bottomk_chunked.bottom_k_chunked(dists[:1, :1], 49),
        lambda: bottomk_chunked.bottom_k_chunked(
            torch.zeros((1, bottomk_chunked.MAX_N + 1), device=dev), 4),
    )
    for call in refused:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("a kernel took a shape past its bounds")
    print("contract edges: N = 8193 at k = 1, 32, 48, N = 2^20, N = 2^22 at k = 1, 32, 48 "
          "equal to plain; "
          f"k = 49 (D = 3 and 64), k > N, D > {knn.MAX_D}, N > 2^22 refused")

    def run_knn(f):
        return lambda: [f(q, p, k) for q, p, k in calls]

    for name, kern, plain, fn, arg, what in (
        ("knn", knn.knn, knn.knn_plain, run_knn, None,
         f"build_pyramid of [{RANDLA_BATCH}, {RANDLA_POINTS}] (10 calls)"),
        ("bottom_k_chunked", bottomk_chunked.bottom_k_chunked, bottomk.bottom_k_plain,
         None, dists, f"[{RANDLA_BATCH}, 4096, {RANDLA_POINTS}] k=16"),
    ):
        if fn is not None:
            eager_ms, plain_ms = cuda_ms(fn(kern), reps=10), cuda_ms(fn(plain), reps=3)
            ms = device_ms(fn(kern), reps=3)
        else:
            eager_ms = cuda_ms(lambda: kern(arg, 16), reps=20)
            ms = device_ms(lambda: kern(arg, 16))
            plain_ms = cuda_ms(lambda: plain(arg, 16), reps=5)
        work = (bounds.total(bounds.knn(q.shape[0], q.shape[1], p.shape[1], q.shape[2], k)
                             for q, p, k in calls) if fn is not None else
                bounds.bottom_k_chunked(arg.numel() // arg.shape[-1], arg.shape[-1], 16))
        record_bound(records[name], work)
        bound = records[name]["bound_ms"]
        print(f"{name}: kernel {ms:.4f} ms on the card ({eager_ms:.4f} ms as eager calls, "
              f"median), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({records[name]['bound_by']}; {work.bytes} bytes, {work.operations} "
              f"operations; share {bound / ms:.3f}) per {what}")
        records[name].update(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms)
    records["knn"]["max_abs_err"] = knn_err
    records["bottom_k_chunked"]["max_abs_err"] = bk_err
    if not torch.equal(topk_library(dists, 16)[0], bottomk_chunked.bottom_k_chunked(dists, 16)[0]):
        raise AssertionError("torch.topk values != bottom_k_chunked")
    lib_ms = device_ms(lambda: topk_library(dists, 16), reps=5)
    records["bottom_k_chunked"].update(library_ms=lib_ms, library_call=TOPK_CALL)
    print(f"bottom_k_chunked: library call {TOPK_CALL} {lib_ms:.4f} ms")
    for q, p, k in calls:
        ms = device_ms(lambda: knn.knn(q, p, k), reps=5)
        b = bounds.knn(q.shape[0], q.shape[1], p.shape[1], q.shape[2], k)
        print(f"  knn {tuple(q.shape)} x {tuple(p.shape)} k={k}: {ms:.4f} ms "
              f"(bound {b.bound_ms:.4f} ms, {b.bound_by})")
    for what, (q, p) in stress_orders.items():
        ms = device_ms(lambda: knn.knn(q, p, 16), reps=5)
        print(f"  knn {tuple(q.shape)} x {tuple(p.shape)} k=16, points in {what} order: "
              f"{ms:.4f} ms ({1e9 * ms / (q.shape[0] * q.shape[1] * p.shape[1]):.3f} ps "
              f"per pair)")


def phase_routes(records, xyz) -> None:
    """The 40960² level through the fused kernel and through the tiled
    route (square_distance + wide-row bottom-k on tiles of 4096)."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.ops import cuda as kernels

    fused = ops.knn(xyz, xyz, 16, strategy="fused")
    kernels.reset_launch_counts()
    tiled = ops.knn(xyz, xyz, 16, tile=4096, strategy="pallas")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if not torch.equal(fused[1], tiled[1]):
        raise AssertionError("fused and tiled kNN routes give different indices")
    if counts["bottom_k_chunked"] != RANDLA_POINTS // 4096:
        raise AssertionError(f"tiled route launches: {counts}")
    records["bottom_k_chunked"]["launches"] = counts["bottom_k_chunked"]
    _record_path(records, "bottom_k_chunked", "knn tiled route 40960^2",
                 counts["bottom_k_chunked"], "tiled kNN of one 40960² level",
                 counts["bottom_k_chunked"])
    print(f"routes: fused and tiled kNN indices identical at {tuple(xyz.shape)} k=16; "
          f"launches on the tiled route {counts}")


def randla_state_dict(seed: int, dev, feats, floats: int = RANDLA_STATE_FLOATS,
                      **model_kwargs) -> dict:
    """Full-width RandLA weights from a seeded generator (Linear weights
    and biases uniform in ±1/sqrt(fan_in), BatchNorm at scale 1, bias 0)
    with BatchNorm statistics from one train-mode forward over ``feats``
    (keep fraction 0); ``model_kwargs`` go to ``RandLANet`` (5 levels)."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    gen = torch.Generator().manual_seed(seed)
    model = RandLANet(**model_kwargs)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for t in (mod.weight, mod.bias):
                    if t is not None:
                        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)
    n = sum(t.numel() for t in model.state_dict().values())
    if n != floats:
        raise AssertionError(f"RandLA state holds {n} floats, want {floats}")
    model.to(dev).train()
    with torch.no_grad():
        model(feats, build_pyramid(feats[..., :3]), momentum=0.0)
    return model.state_dict()


def run_randla_cli(prep: str, log: str, attack: str, fused: bool, clouds: int,
                   extra: tuple = (), knn_per_batch: int = 10, points: int = RANDLA_POINTS):
    """One attack run through the CLI at batch 4, the launch counts set to
    0 just before it and read just after; its rows and summary. Without a
    defense a batch launches ``knn`` 10 times, for its pyramid."""
    from pointsecguard_tpu_torch.cli import attack as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    argv = ["--model", "randla", "--attack", attack, "--randla_dir", prep,
            "--log_dir", log, "--num_clouds", str(clouds),
            "--batch_size", str(RANDLA_BATCH), *extra] + (["--fused_ap"] if fused else [])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rows = read_tsv(os.path.join(log, f"randla_{attack}_area5.tsv"))
    if len(rows) != clouds:
        raise AssertionError(f"{len(rows)} TSV rows, want {clouds}")
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s", "steps")}
    ms_cloud = 1e3 * col["time_s"]  # each row: its batch's wall / batch size
    stats = {
        "attack": attack, "fused_ap": fused, "clouds": len(rows), "points": points,
        "steps": [int(x) for x in col["steps"]],
        "ms_per_cloud_mean": float(ms_cloud.mean()),
        "ms_per_cloud_warm_median": float(np.median(ms_cloud[RANDLA_BATCH:]
                                                    if clouds > RANDLA_BATCH else ms_cloud)),
        "main_wall_s": wall,
        "clean_acc": float(col["clean_acc"].mean()),
        "adv_acc": float(col["adv_acc"].mean()),
        "l2_mean": float(col["l2"].mean()),
        "clean_miou": clean_m.miou,
        "adv_miou": adv_m.miou,
        "launches": counts,
    }
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite value in the RandLA {attack} output")
    if counts["knn"] != knn_per_batch * clouds // RANDLA_BATCH:
        raise AssertionError(f"kNN launches {counts['knn']}, want {knn_per_batch} per batch")
    # model passes per batch: the collect forward, one forward + backward
    # per attack step, PGD's final forward and the adversarial prediction's
    # forward; S = the batch's steps
    steps = [max(col["steps"][b : b + RANDLA_BATCH]) for b in range(0, clouds, RANDLA_BATCH)]
    passes = 3 if attack in ("nb", "tar_nb") else 2
    fwd, bwd = sum(int(S) + passes for S in steps), sum(int(S) for S in steps)
    want = (4 * fwd, 4 * bwd) if fused else (0, 0)
    if (counts["attentive_fwd"], counts["attentive_bwd"]) != want:
        raise AssertionError(f"attentive launches {counts}, want fwd/bwd {want} "
                             f"({fwd} forwards, {bwd} backwards)")
    return stats


def phase_randla(dev, records, prep: str, sd: dict) -> list[dict]:
    """NB through the CLI on the reference and the fused model, in turns."""
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    log = os.path.join(WORK, "randla_log")
    save_checkpoint(log, sd)
    runs = []
    for fused in (False, True, True, False):
        stats = run_randla_cli(prep, log, "nb", fused, RANDLA_CLOUDS)
        stats["nb_iters_per_s"] = sum(stats["steps"]) / (
            1e-3 * stats["ms_per_cloud_mean"] * stats["clouds"])
        print("randla slice: " + json.dumps(stats))
        if not stats["adv_acc"] < stats["clean_acc"]:
            raise AssertionError("the NB attack did not lower the mean accuracy")
        runs.append(stats)
    records["knn"]["launches_by_path"] = {"randla nb": runs[0]["launches"]["knn"]}
    batches = RANDLA_CLOUDS // RANDLA_BATCH
    records["knn"]["calls_per_batch"] = {"randla nb": runs[0]["launches"]["knn"] / batches}
    for name in ("attentive_fwd", "attentive_bwd"):
        records[name]["calls_per_batch"] = {
            "randla nb --fused_ap": runs[1]["launches"][name] / batches}
    for name in ("reference", "fused_ap"):
        picked = [r for r in runs if r["fused_ap"] == (name == "fused_ap")]
        print(f"randla nb {name}: ms/cloud warm median "
              f"{[r['ms_per_cloud_warm_median'] for r in picked]}")
    return runs


def phase_randla_nu(prep: str, records) -> list[dict]:
    """NU (C&W, ares flavour) through the CLI on one batch of 4
    full-width clouds at the preset's budget, with --fused_ap and
    without, in turns (fused, reference, fused, reference). The launch
    counts of the last fused run are the attentive kernels' record."""
    log = os.path.join(WORK, "randla_log")
    runs = []
    for fused in (True, False, True, False):
        stats = run_randla_cli(prep, log, "nu", fused, NU_CLOUDS)
        stats["ms_per_step"] = stats["ms_per_cloud_mean"] * NU_CLOUDS / max(stats["steps"])
        print("randla nu: " + json.dumps(stats))
        steps = stats["steps"]
        if not all(1 <= n <= 1000 for n in steps):
            raise AssertionError(f"NU steps {steps} outside 1..1000")
        if max(steps) > 1 and not stats["adv_acc"] < stats["clean_acc"]:
            raise AssertionError("the NU attack did not lower the mean accuracy")
        runs.append(stats)
    fused_run = runs[2]
    for name in ("attentive_fwd", "attentive_bwd"):
        if fused_run["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
        records[name]["launches"] = fused_run["launches"][name]
        records[name]["calls_per_batch"]["randla nu --fused_ap"] = (
            f"{fused_run['launches'][name]} over {max(fused_run['steps'])} steps")
    records["knn"]["calls_per_batch"]["randla nu"] = fused_run["launches"]["knn"]
    for name in ("reference", "fused_ap"):
        picked = [r for r in runs if r["fused_ap"] == (name == "fused_ap")]
        print(f"randla nu {name}: ms per step {[r['ms_per_step'] for r in picked]}")
    return runs


def phase_pointnet2_nu(data: str, records, model: str = "pointnet2") -> dict:
    """NU through the CLI on 8 blocks at batch 8: the geometry's
    launches and one more bottom-k per C&W step for the smooth term.
    The checkpoint is ``phase_slice``'s with +2 on the ceiling, floor and
    wall logits (3/4 of the room's points): the random weights alone
    start below NU's 1/13 accuracy exit on every block, so the attack
    would stop at its first step. SSG runs the preset's 1000 steps or its
    exit; the other models ``BLOCK_NU_STEPS``."""
    import dataclasses

    from pointsecguard_tpu_torch import attacks
    from pointsecguard_tpu_torch.cli import attack as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    src = "log" if model == "pointnet2" else f"log_{model}"
    sd = load_checkpoint(os.path.join(WORK, src))
    sd["cls.bias"][:3] += 2.0
    log = os.path.join(WORK, f"{src}_nu")
    save_checkpoint(log, sd)
    argv = ["--model", model, "--attack", "nu", "--data_root", data,
            "--log_dir", log, "--num_point", str(NUM_POINT),
            "--batch_size", str(BATCH), "--max_blocks", str(NU_BLOCKS)]
    key = ("pointnet2", "nu")  # every PointNet-family model takes these presets
    preset = attacks._PRESETS[key]
    cut = model != "pointnet2"
    if cut:
        attacks._PRESETS[key] = dataclasses.replace(preset, steps=BLOCK_NU_STEPS)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        clean_m, adv_m = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        attacks._PRESETS[key] = preset
    rows = read_tsv(os.path.join(log, f"{model}_nu_area5.tsv"))
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s", "steps")}
    S = int(col["steps"].max())
    stats = {
        "blocks": len(rows), "steps": [int(x) for x in col["steps"]],
        "ms_per_block": float(1e3 * col["time_s"].mean()),
        "ms_per_step": float(1e3 * col["time_s"].sum() / S),
        "main_wall_s": wall,
        "clean_acc": float(col["clean_acc"].mean()),
        "adv_acc": float(col["adv_acc"].mean()),
        "l2_mean": float(col["l2"].mean()),
        "launches": counts,
    }
    print(("pointnet2 nu: " if model == "pointnet2" else
           f"{model} nu ({BLOCK_NU_STEPS} steps at most): ") + json.dumps(stats))
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if len(rows) != NU_BLOCKS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{model} NU: {len(rows)} rows or a non-finite value")
    geo = GEOMETRY_LAUNCHES[model]
    if (counts["fps"] != geo["fps"] or counts["bottom_k"] != geo["bottom_k"] + S
            or (cut and S > BLOCK_NU_STEPS)):
        raise AssertionError(f"{model} NU launches {counts}, want fps {geo['fps']} and "
                             f"bottom_k {geo['bottom_k']} + {S} steps")
    if not cut and S > 1 and not stats["adv_acc"] < stats["clean_acc"]:
        raise AssertionError("the NU attack did not lower the mean accuracy")
    if geo["fps"]:
        records["fps"]["calls_per_batch"][f"{model} nu"] = counts["fps"]
    records["bottom_k"]["calls_per_batch"][f"{model} nu"] = (
        f"{counts['bottom_k']} over {S} steps ({geo['bottom_k']} + 1 per step)")
    return stats


def attentive_case(K: int, M: int, D: int, gen, dev):
    """fn, fx [K, M, D] and a [2D, 2D] projection at Linear's init scale."""
    fn = torch.randn((K, M, D), generator=gen, device=dev)
    fx = torch.randn((K, M, D), generator=gen, device=dev)
    w = (torch.rand((2 * D, 2 * D), generator=gen, device=dev) * 2 - 1) / math.sqrt(2 * D)
    return fn, fx, w


def grad_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want|, which must stay within 1e-8 + 1e-4·max|want|
    (the JAX package's gate for the fused gradients)."""
    err = (got - want).abs().max().item()
    tol = 1e-8 + 1e-4 * want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{name}: max |diff| {err:.3e} > {tol:.3e}")
    return err


def phase_attentive_kernels(dev, records):
    from pointsecguard_tpu_torch.ops.attentive import attentive_pool_fused_plain as plain
    from pointsecguard_tpu_torch.ops.cuda import attentive, bounds

    gen = torch.Generator(device=dev).manual_seed(3)
    fwd_err = bwd_err = 0.0
    # the slice shapes, then the edges: M = 1 and M off the row tile (a
    # block holds 64, 32, 8 or 4 rows at D = 1, 8, 32, 63), D off 4 (the
    # padded layout with 4-byte copies), both K, with and without dW
    cases = [(*ATT_SHAPES[0], False), (*ATT_SHAPES[0], True),
             (*ATT_SHAPES[1], False), (*ATT_SHAPES[1], True),
             (16, 1, 8, True), (16, 1001, 8, True), (16, 1001, 63, True),
             (4, 1001, 63, True), (4, 37, 5, False),
             (16, 1001, 1, True), (4, 999, 1, False), (4, 1001, 8, True),
             (16, 1001, 32, True), (4, 1003, 32, False), (16, 100003, 32, False),
             (16, 997, 63, False), (16, 5000, 12, True), (4, 70001, 8, True)]
    for K, M, D, want_dw in cases:
        fn, fx, w = attentive_case(K, M, D, gen, dev)
        g1, g2 = torch.randn((2, M, D), generator=gen, device=dev)
        grads = {}
        for name, f in (("kernel", attentive.attentive_pool_fused), ("plain", plain)):
            leaves = [fn.clone().requires_grad_(True), fx.clone().requires_grad_(True),
                      w.clone().requires_grad_(want_dw)]
            out = f(*leaves)
            wrt = leaves if want_dw else leaves[:2]
            grads[name] = (out, torch.autograd.grad(out, wrt, (g1, g2)))
        torch.cuda.synchronize()
        (ok_, gk), (op_, gp) = grads["kernel"], grads["plain"]
        for a, b in zip(ok_, op_):
            err = (a - b).abs().max().item()
            if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=2e-5, atol=2e-6)):
                raise AssertionError(f"attentive fwd [{K}, {M}, {D}]: max |diff| {err:.3e}")
            fwd_err = max(fwd_err, err)
        for name, a, b in zip(("dfn", "dfx", "dw"), gk, gp):
            bwd_err = max(bwd_err, grad_err(f"attentive {name} [{K}, {M}, {D}]", a, b))
        print(f"attentive [{K}, {M}, {D}] dW={want_dw}: forward and backward "
              f"within tolerance of plain")

    # dW is summed in a fixed order: two runs give the same bits
    for K, M, D in (ATT_SHAPES[1], ATT_SHAPES[0], (16, 20001, 63), (4, 20001, 1)):
        fn, fx, w = attentive_case(K, M, D, gen, dev)
        g1, g2 = torch.randn((2, M, D), generator=gen, device=dev)
        dws = []
        for _ in range(2):
            wl = w.clone().requires_grad_(True)
            dws.append(torch.autograd.grad(attentive.attentive_pool_fused(fn, fx, wl), wl,
                                           (g1, g2))[0])
        if not torch.equal(*dws):
            raise AssertionError(f"attentive dW differs between two runs at [{K}, {M}, {D}]")
    refused = (
        lambda: attentive.attentive_pool_fused(*attentive_case(8, 64, 8, gen, dev)),
        lambda: attentive.attentive_pool_fused(*attentive_case(16, 64, 64, gen, dev)),
        lambda: attentive.attentive_pool_fused(
            *(t.double() for t in attentive_case(16, 64, 8, gen, dev))),
    )
    for call in refused:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("the attentive kernel took an input past its bounds")
    print("contract edges: M = 1, M off the row tile, D = 1, 5, 8, 12, 32, 63, K = 4 and 16 "
          "within tolerance; dW equal on two runs; K = 8, D = 64, float64 refused")

    # times per RandLA forward (4 calls) and per backward (the attack's:
    # no dW), the same inputs for kernel and plain
    calls = [attentive_case(*ATT_SHAPES[i // 2], gen, dev) for i in range(4)]
    cots = [tuple(torch.randn((2, M, D), generator=gen, device=dev))
            for _, M, D in (ATT_SHAPES[i // 2] for i in range(4))]
    res = {}
    for name, f in (("kernel", attentive.attentive_pool_fused), ("plain", plain)):
        timer = cuda_ms if name == "plain" else device_ms
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: [f(*c) for c in calls], reps=20)
            fwd_dev = timer(lambda: [f(*c) for c in calls], reps=10)
        leaves = [(fn.clone().requires_grad_(True), fx.clone().requires_grad_(True), w)
                  for fn, fx, w in calls]
        outs = [o for lv in leaves for o in f(*lv)]
        flat = [t for lv in leaves for t in lv[:2]]
        cot = [g for c in cots for g in c]
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(outs, flat, cot, retain_graph=True),
                         reps=20)
        bwd_dev = timer(lambda: torch.autograd.grad(outs, flat, cot, retain_graph=True),
                        reps=10)
        res[name] = (fwd_ms, bwd_ms, fwd_dev, bwd_dev)
        del leaves, outs, flat
    (ef, eb, kf, kb), (pf, pb, _, _) = res["kernel"], res["plain"]
    print(f"attentive per RandLA forward (4 calls): kernel {kf:.4f} ms on the card "
          f"({ef:.4f} ms as eager calls, median), plain {pf:.4f} ms; backward (no dW): "
          f"kernel {kb:.4f} ms ({eb:.4f} ms eager), plain {pb:.4f} ms; forward + backward: "
          f"kernel {kf + kb:.4f} ms, plain {pf + pb:.4f} ms")
    records["attentive_fwd"].update(ms=kf, eager_ms=ef, plain_ms=pf, max_abs_err=fwd_err)
    records["attentive_bwd"].update(ms=kb, eager_ms=eb, plain_ms=pb, max_abs_err=bwd_err)
    shapes = [ATT_SHAPES[i // 2] for i in range(4)]
    for name, f, ms in (("attentive_fwd", bounds.attentive_fwd, kf),
                        ("attentive_bwd", bounds.attentive_bwd, kb)):
        work = bounds.total(f(*shape) for shape in shapes)
        record_bound(records[name], work)
        print(f"{name}: bound {work.bound_ms:.4f} ms ({work.bound_by}; {work.bytes} bytes "
              f"= {work.bytes_ms:.4f} ms, {work.operations} operations = "
              f"{work.operations_ms:.4f} ms; share {work.bound_ms / ms:.3f}) per RandLA pass")
    for (K, M, D), (fn, fx, w), (g1, g2) in zip(shapes[::2], calls[::2], cots[::2]):
        with torch.no_grad():
            ms = device_ms(lambda: attentive.attentive_pool_fused(fn, fx, w))
        bf = bounds.attentive_fwd(K, M, D)
        print(f"  attentive fwd [{K}, {M}, {D}]: {ms:.4f} ms (bound {bf.bound_ms:.4f} ms, "
              f"{bf.bound_by})")
        for want_dw in (False, True):
            lv = (fn.clone().requires_grad_(True), fx.clone().requires_grad_(True),
                  w.clone().requires_grad_(want_dw))
            out = attentive.attentive_pool_fused(*lv)
            wrt = lv if want_dw else lv[:2]
            ms = device_ms(lambda: torch.autograd.grad(out, wrt, (g1, g2), retain_graph=True))
            bb = bounds.attentive_bwd(K, M, D, want_dw)
            print(f"  attentive bwd [{K}, {M}, {D}] dW={want_dw}: {ms:.4f} ms "
                  f"(bound {bb.bound_ms:.4f} ms, {bb.bound_by})")


def phase_fused_model(dev, feats: torch.Tensor, sd: dict) -> None:
    """The full-width RandLA with ap_impl="fused" against the reference
    composition on one sampler batch of 4 × 40960 points: logits within
    1e-4 of the largest. The colour gradient of a cross-entropy is held
    against a float64 evaluation of the reference: the random calibrated
    model's gradient is ill-conditioned in float32 (the float32 reference
    itself misses float64 by ~0.3 % in L2 at 4 × 2048 points on the CPU),
    so the fused gradient must come as close to it as the float32
    reference does, within a factor of 2."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    pyr = build_pyramid(feats[..., :3])
    labels = torch.randint(0, 13, feats.shape[:2], device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))
    out = {}
    for ap_impl, dtype in (("reference", torch.float64), ("reference", torch.float32),
                           ("fused", torch.float32)):
        model = RandLANet(ap_impl=ap_impl)
        model.load_state_dict(sd)
        model.to(dev, dtype).eval().requires_grad_(False)
        f = feats.to(dtype)
        p = dict(pyr, xyz=tuple(x.to(dtype) for x in pyr["xyz"]))
        colors = f[..., 3:6].clone().requires_grad_(True)
        logits = model(torch.cat([f[..., :3], colors], dim=-1), p)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 13), labels.reshape(-1))
        out[ap_impl, dtype] = (logits.detach(), torch.autograd.grad(loss, colors)[0].double())
        del model
    torch.cuda.synchronize()
    g64 = out["reference", torch.float64][1]
    (lr, gr), (lf, gf) = out["reference", torch.float32], out["fused", torch.float32]
    err = (lf - lr).abs().max().item()
    tol = 1e-4 * max(1.0, lr.abs().max().item())
    ref_gerr = (gr - g64).abs().max().item()
    fused_gerr = (gf - g64).abs().max().item()
    rel = [(torch.linalg.norm(g - g64) / torch.linalg.norm(g64)).item() for g in (gr, gf)]
    print(f"fused vs reference RandLA at [{RANDLA_BATCH}, {RANDLA_POINTS}]: logits max "
          f"|diff| {err:.3e} (tolerance {tol:.3e}); colour gradient vs float64 max |diff| "
          f"reference {ref_gerr:.3e}, fused {fused_gerr:.3e} (max |g| "
          f"{g64.abs().max().item():.3e}), relative L2 reference {rel[0]:.3e}, "
          f"fused {rel[1]:.3e}; fused vs reference max |diff| "
          f"{(gf - gr).abs().max().item():.3e}")
    if not (torch.isfinite(lf).all() and err <= tol):
        raise AssertionError("fused RandLA logits disagree with the reference")
    if not (torch.isfinite(gf).all() and fused_gerr <= 2 * ref_gerr):
        raise AssertionError("the fused colour gradient is further from float64 than "
                             "twice the float32 reference's")


def phase_randla_reference(dev, prep: str) -> None:
    """RandLA on the card (kernels) vs on the CPU (plain versions) on one
    8192-point cloud, with the reference and the fused attentive pooling:
    pyramid indices equal at every level; logits on the same pyramid
    within 1e-4 of the largest magnitude."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    feats = randla_batch(prep, dev, num_points=8192, batch=1)
    sd = randla_state_dict(1, dev, feats)
    pyr_gpu = build_pyramid(feats[..., :3])
    pyr_cpu = build_pyramid(feats[..., :3].cpu())
    for key in ("neigh_idx", "sub_idx", "interp_idx"):
        for level, (g, c) in enumerate(zip(pyr_gpu[key], pyr_cpu[key])):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"card/CPU pyramid {key}[{level}] differ")
    for ap_impl in ("reference", "fused"):
        model = RandLANet(ap_impl=ap_impl)
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            lg = model.to(dev)(feats, pyr_gpu).cpu()
            lc = model.cpu()(feats.cpu(), pyr_cpu)
        # float32 sums run in another order on the card than on the CPU;
        # the bound is relative to the largest logit
        err = (lg - lc).abs().max().item()
        tol = 1e-4 * max(1.0, lc.abs().max().item())
        print(f"randla {ap_impl}: pyramid indices equal card vs CPU at all 5 levels; "
              f"logits max |diff| {err:.3e} (tolerance {tol:.3e})")
        if not (lg.shape == (1, 8192, 13) and torch.isfinite(lg).all() and err <= tol):
            raise AssertionError(f"card RandLA ({ap_impl}) logits disagree with the CPU")


def phase_trained_fixture(dev) -> dict:
    """The trained PointNet++ fixture on the card: NB at the preset and
    tar_NB (floor → table, 50 iterations) on the first 8 blocks of 128
    points of the recipe's synthetic Area-5 room, as
    ``tools/make_trained_fixture.py`` measured the committed figures."""
    from pointsecguard_tpu_torch import attacks
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks, make_synthetic_rooms
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry
    from pointsecguard_tpu_torch.utils.convert import from_jax_variables

    fixdir = os.path.join(REPO, "tests", "fixtures")
    with np.load(os.path.join(fixdir, "trained_pointnet2.npz")) as f:
        sd = from_jax_variables({k: f[k] for k in f.files})
    with open(os.path.join(fixdir, "trained_pointnet2.json")) as f:
        expected = json.load(f)["expected"]
    model = PointNet2SemSegSSG()
    model.load_state_dict(sd)
    model.to(dev).eval().requires_grad_(False)
    data = os.path.join(WORK, "fixture_data")
    make_synthetic_rooms(data, points_per_room=6000, seed=0)
    feats, labs, _, _ = WholeSceneBlocks(
        RoomSet.load(data, "test", 5), block_points=128).room_blocks(
            0, np.random.default_rng(0))
    feats = torch.from_numpy(feats[:8]).to(dev)
    labs = torch.from_numpy(labs[:8]).long().to(dev)
    geo = build_geometry(feats[..., :3])

    def outputs_fn(p):
        return model(p, geometry=geo)[0]

    with torch.no_grad():
        clean = (outputs_fn(feats).argmax(-1) == labs).float().mean().item()
    nb = attacks.pgd_color_attack(outputs_fn, feats, labs,
                                  attacks.attack_preset("pointnet2", "nb"))
    ys, mask = attacks.make_target_labels(labs, 1, 7)
    tnb = attacks.pgd_color_attack(
        outputs_fn, feats, ys,
        attacks.attack_preset("pointnet2", "tar_nb", target=7, iters=50), mask=mask)
    got = {"clean_acc": clean, "nb_adv_acc": nb.acc.item(),
           "nb_l2_mean": nb.l2_dist.mean().item(),
           "tar_nb_success_rate": tnb.success_rate.item()}
    # tolerances of tests/test_torch_attack.py (tests/test_trained_regression.py's)
    tol = {"clean_acc": 0.02, "nb_adv_acc": 0.03,
           "nb_l2_mean": 0.05 * expected["nb_l2_mean"], "tar_nb_success_rate": 0.05}
    print("trained fixture on the card: " + json.dumps(
        {k: {"card": got[k], "committed": expected[k], "tolerance": tol[k]} for k in got}))
    for k in got:
        if not abs(got[k] - expected[k]) < tol[k]:
            raise AssertionError(f"trained fixture {k}: {got[k]} vs committed {expected[k]}")
    return got


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def phase_train_step(dev, model: str = "pointnet2", batch: int = BATCH) -> dict:
    """One optimizer step of a full-width block model (SSG by default)
    from the same weights, batch (``batch`` × 4096), FPS starts and
    dropout mask (PointNet: neither; its step adds the feature-transform
    aux loss), on the card (kernels) and on the CPU (plain versions).

    Geometry: FPS centres equal; ball-query and 3-NN indices agree on
    ≥ 0.999 of the entries (the distance product rounds differently on the
    card). The step itself runs on both devices on the card's plan, so
    that what differs is float32 summation order and, on the card, the
    atomics of the gathers' scatter-add backward (not reproducible from
    run to run). Tolerances: loss 1e-4 relative; the gradient and Adam's
    first moment 2e-2 in relative L2 over the whole vector (the CPU step
    itself sits 4e-3 from a float64 evaluation at a small size,
    tests/test_torch_train.py), the second moment twice that; BatchNorm
    statistics 1e-3 of the largest. The first Adam update is
    lr · g / (|g| + ε), ±lr whatever the size of g, so the parameters'
    move is compared where |g| is clear of rounding noise (above a fifth
    of its tensor's largest entry; never a tensor whose true gradient is
    0, ``_block_noise_only``): within 1e-5 there."""
    from pointsecguard_tpu_torch.models import init_parameters, weighted_nll_loss
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET_MODELS, TrainState, make_train_step,
    )

    model_cls, family = POINTNET_MODELS[model]
    blocks = train_blocks(dev, batch)
    gen = torch.Generator().manual_seed(11)
    labels = torch.randint(0, 13, blocks.shape[:2], generator=gen)
    weights = 0.5 + torch.rand(13, generator=gen)
    mask = torch.rand((batch, NUM_POINT, 128), generator=gen) >= 0.5
    sizes = (NUM_POINT, 1024, 256, 64)
    starts = [torch.randint(0, n, (batch,), generator=gen, dtype=torch.int32) for n in sizes]
    geo_gpu = family.plan(blocks, start_idx=[s.to(dev) for s in starts])
    agree = [1.0]
    if geo_gpu is not None:
        geo_cpu = family.plan(blocks.cpu(), start_idx=starts)
        for li in range(4):
            if not torch.equal(geo_gpu["sa"][li][0].cpu(), geo_cpu["sa"][li][0]):
                raise AssertionError(f"train geometry: FPS centres differ card vs CPU at "
                                     f"level {li}")
            if not torch.equal(geo_gpu["sa"][li][0][:, 0].cpu(),
                               ([blocks[..., :3].cpu()] + [g[0] for g in geo_cpu["sa"]])[li][
                                   torch.arange(batch), starts[li].long()]):
                raise AssertionError("train geometry: a level does not begin at its start")
        agree = [(g.cpu() == c).float().mean().item()
                 for g, c in zip(_neighbour_indices(geo_gpu), _neighbour_indices(geo_cpu))]
        if min(agree) < 0.999:
            raise AssertionError(f"train geometry: neighbour agreement {min(agree)} < 0.999")
    geo_shared = _to_device(geo_gpu, torch.device("cpu"), torch.float32)

    out = {}
    for name, device, geo in (("card", dev, geo_gpu), ("cpu", torch.device("cpu"), geo_shared)):
        net = model_cls()
        init_parameters(net, torch.Generator().manual_seed(3))
        state = TrainState(net.to(device))
        before = state.params.clone()
        step = make_train_step(net, weighted_nll_loss, family=family)
        t0 = time.perf_counter()
        loss = step(state, blocks.to(device), labels.to(device), weights.to(device),
                    TRAIN_LR, 0.1, dropout_mask=mask.to(device), geometry=geo)
        named = [(k, p.numel()) for k, p in net.named_parameters()]
        out[name] = {"loss": loss.item(), "grads": state.grads.cpu(), "mu": state.mu.cpu(),
                     "nu": state.nu.cpu(), "move": (state.params - before).cpu(),
                     "stats": state.stats.cpu(), "seconds": time.perf_counter() - t0}
    card, cpu = out["card"], out["cpu"]
    clear = torch.cat([
        (g.abs() > 0.2 * g.abs().max()) & (not _block_noise_only(model, key))
        for (key, _), g in zip(named, cpu["grads"].split([n for _, n in named]))])
    res = {
        "loss_card": card["loss"], "loss_cpu": cpu["loss"],
        "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        "grad_rel_l2": _rel_l2(card["grads"], cpu["grads"]),
        "mu_rel_l2": _rel_l2(card["mu"], cpu["mu"]),
        "nu_rel_l2": _rel_l2(card["nu"], cpu["nu"]),
        "move_max_abs_where_clear": (card["move"] - cpu["move"])[clear].abs().max().item(),
        "clear_entries": int(clear.sum()),
        "stats_max_abs": (card["stats"] - cpu["stats"]).abs().max().item(),
        "stats_max": cpu["stats"].abs().max().item(),
        "neighbour_agreement_min": min(agree),
        "card_step_s": card["seconds"], "cpu_step_s": cpu["seconds"],
    }
    print(("train step, card vs CPU: " if model == "pointnet2" else
           f"{model} train step [{batch}, {NUM_POINT}], card vs CPU: ") + json.dumps(res))
    ok = (math.isfinite(card["loss"]) and res["loss_rel"] <= 1e-4
          and res["grad_rel_l2"] <= 2e-2 and res["mu_rel_l2"] <= 2e-2
          and res["nu_rel_l2"] <= 4e-2 and res["move_max_abs_where_clear"] <= 1e-5
          and res["clear_entries"] > 10_000
          and res["stats_max_abs"] <= 1e-3 * res["stats_max"]
          and card["move"].abs().max().item() > 0)
    if not ok:
        raise AssertionError(f"the card's {model} train step disagrees with the CPU's")
    return res


def _neighbour_indices(geo: dict) -> list:
    """The ball-query groups (one or, for MSG, one per radius a level) and
    the 3-NN indices of a geometry plan."""
    groups = []
    for _, idx in geo["sa"]:
        groups += list(idx) if isinstance(idx, tuple) else [idx]
    return groups + [idx for idx, _ in geo["fp"]]


def _block_noise_only(model: str, key: str) -> bool:
    """Parameters whose true gradient is 0, so that what they get is
    rounding noise: a Linear bias under a BatchNorm, and in PointNet the
    BatchNorm bias of the last conv before a max over the points (the
    shift passes the max whole, the same for every cloud, and the next
    BatchNorm takes it out; the STNs' ReLU clips no channel's max of 4096
    points)."""
    return key.endswith("dense.bias") or model == "pointnet" and key in (
        "feat.stn.fc.0.bias", "feat.stn.fc.1.bias", "feat.fstn.fc.0.bias",
        "feat.fstn.fc.1.bias", "feat.conv3.bn.bias", "feat.stn.convs.2.bn.bias",
        "feat.fstn.convs.2.bn.bias")


def read_events(log: str) -> list[dict]:
    with open(os.path.join(log, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train(dev, records, model: str = "pointnet2", n_epochs: int = TRAIN_EPOCHS,
                data: str | None = None) -> tuple[str, str, dict]:
    """Training of a block model (SSG by default) through
    ``cli.train.main`` at full width for ``n_epochs`` epochs (an eval every
    ``TRAIN_EVAL_EVERY`` and after the last), then a resumed call with one
    more epoch: losses finite and falling, one geometry's launches per
    step and per eval batch. ``data`` reuses rooms made before. Returns
    the data root, the log dir and the figures of the run."""
    from pointsecguard_tpu_torch.cli import train as cli
    from pointsecguard_tpu_torch.data import (
        RoomSet, S3DISBlockSampler, WholeSceneBlocks, make_synthetic_rooms,
    )
    from pointsecguard_tpu_torch.models import weighted_nll_loss
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET_MODELS, TrainState, make_train_step,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

    if data is None:
        data = os.path.join(WORK, "train_data")
        make_synthetic_rooms(data, points_per_room=ROOM_POINTS, seed=0,
                             train_areas=TRAIN_AREAS)
    log = os.path.join(WORK, "train_log" if model == "pointnet2" else f"train_log_{model}")
    rooms = RoomSet.load(data, "train", 5)
    sampler = S3DISBlockSampler(rooms, num_point=NUM_POINT)
    steps_per_epoch = -(-len(sampler) // TRAIN_BATCH)
    test_blocks = WholeSceneBlocks(RoomSet.load(data, "test", 5), block_points=NUM_POINT
                                   ).room_blocks(0, np.random.default_rng(0))[0].shape[0]
    eval_batches = -(-test_blocks // TRAIN_BATCH)
    if model == "pointnet2" and steps_per_epoch * n_epochs < 60:
        raise AssertionError(f"{steps_per_epoch} steps an epoch: fewer than 60 in all")
    want_evals = sum((e + 1) % TRAIN_EVAL_EVERY == 0 or e == n_epochs - 1
                     for e in range(n_epochs))

    def argv(epochs):
        return ["--model", model, "--data_root", data, "--log_dir", log,
                "--npoint", str(NUM_POINT), "--batch_size", str(TRAIN_BATCH),
                "--epochs", str(epochs), "--eval_every", str(TRAIN_EVAL_EVERY),
                "--learning_rate", str(TRAIN_LR)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, best_miou = cli.main(argv(n_epochs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    events = read_events(log)
    epochs = [e for e in events if e["event"] == "epoch"]
    evals = [e for e in events if e["event"] == "eval"]
    if [e["epoch"] for e in epochs] != list(range(n_epochs)):
        raise AssertionError(f"epoch lines {[e['epoch'] for e in epochs]}")
    if len(evals) != want_evals:
        raise AssertionError(f"{len(evals)} evals, want {want_evals}")
    if any(e["batches"] != steps_per_epoch or e["nan_batches"] for e in epochs):
        raise AssertionError(f"steps or skipped batches: {epochs}")
    if not all(math.isfinite(e["loss"]) for e in epochs):
        raise AssertionError("a non-finite epoch loss")
    if not epochs[-1]["loss"] < epochs[0]["loss"]:
        raise AssertionError("the last epoch's mean loss is not below the first's")
    steps = steps_per_epoch * n_epochs
    passes = steps + len(evals) * eval_batches  # geometries built
    check_geometry_launches(model, counts, passes,
                            f"train ({steps} steps, {len(evals)} × {eval_batches} eval batches)")
    for name, per in GEOMETRY_LAUNCHES[model].items():
        if per:
            records[name]["launches_by_path"][f"{model} train"] = counts[name]
            records[name]["calls_per_batch"][f"{model} train step"] = per
            records[name]["calls_per_batch"][f"{model} eval batch"] = per

    # the resumed call: one more epoch, none repeated
    cli.main(argv(n_epochs + 1))
    resumed = [e["epoch"] for e in read_events(log) if e["event"] == "epoch"]
    if resumed != list(range(n_epochs + 1)):
        raise AssertionError(f"epochs after the resumed call: {resumed}")
    latest = CheckpointManager(os.path.join(log, "checkpoints")).restore_latest()
    if latest["epoch"] != n_epochs + 1 or latest["step"] != steps + steps_per_epoch:
        raise AssertionError(f"resumed checkpoint: epoch {latest['epoch']}, step {latest['step']}")

    # the step alone on the card: CUDA events around each of 10 steps on
    # batches that already lie there
    model_cls, family = POINTNET_MODELS[model]
    net = model_cls()
    state = TrainState(net.to(dev))
    state.load_payload(latest)
    step = make_train_step(net, weighted_nll_loss, family=family)
    rng = np.random.default_rng(1)
    pts, labels = next(iter(sampler.batches(rng, TRAIN_BATCH)))
    pts, labels = torch.from_numpy(pts).to(dev), torch.from_numpy(labels).to(dev)
    weights = torch.from_numpy(np.asarray(rooms.label_weights, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = cuda_ms(lambda: step(state, pts, labels, weights, 1e-4, 0.1, gen), reps=10)
    t0 = time.perf_counter()
    for _ in sampler.batches(rng, TRAIN_BATCH):
        pass
    sampler_ms = 1e3 * (time.perf_counter() - t0) / steps_per_epoch

    warm = epochs[1:]  # the first epoch pays the one-off CUDA set-up
    # an epoch's line is written before its eval runs, so its seconds are
    # training alone
    host_ms = 1e3 * sum(e["seconds"] for e in warm) / sum(e["batches"] for e in warm)
    stats = {
        "rooms": len(rooms.names), "sampler_blocks": len(sampler),
        "steps_per_epoch": steps_per_epoch, "steps": steps, "eval_batches": eval_batches,
        "epoch_loss": [e["loss"] for e in epochs],
        "eval_accuracy": [e["accuracy"] for e in evals], "eval_miou": [e["miou"] for e in evals],
        "best_miou": best_miou,
        "ms_per_step_host_clock": host_ms,
        "ms_per_step_host_clock_by_epoch": [1e3 * e["seconds"] / e["batches"] for e in epochs],
        "ms_per_step_cuda_events": step_ms,
        "blocks_per_s": 1e3 * TRAIN_BATCH / host_ms,
        "host_share": 1.0 - step_ms / host_ms,
        "sampler_ms_per_batch_alone": sampler_ms,
        "peak_device_memory_gb": peak / 1e9,
        "main_wall_s": wall, "launches": counts,
    }
    print(("train: " if model == "pointnet2" else f"{model} train: ") + json.dumps(stats))
    return data, log, stats


def phase_eval(data: str, log: str, model: str = "pointnet2") -> float:
    """``cli.eval --num_votes 1`` on the trained checkpoint: one
    geometry's launches a batch."""
    from pointsecguard_tpu_torch.cli import eval as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    total = cli.main(["--model", model, "--data_root", data, "--log_dir", log,
                      "--num_point", str(NUM_POINT), "--batch_size", str(TRAIN_BATCH),
                      "--num_votes", "1"])
    counts = kernels.launch_counts()
    print(("eval: " if model == "pointnet2" else f"{model} eval: ")
          + f"accuracy {total.accuracy:.4f}, mIoU {total.miou:.4f} on the Area-5 room "
          f"(floor {EVAL_ACC_FLOOR}, chance 1/13 = {1 / 13:.4f}); launches {counts}")
    if not (math.isfinite(total.miou) and total.accuracy >= EVAL_ACC_FLOOR >= 2 / 13):
        raise AssertionError(f"eval accuracy {total.accuracy} under the floor {EVAL_ACC_FLOOR}")
    per = GEOMETRY_LAUNCHES[model]["fps"]
    batches = counts["fps"] // per if per else 0
    if per and batches <= 0:
        raise AssertionError(f"eval launches {counts}")
    check_geometry_launches(model, counts, batches, "eval")
    return total.accuracy


def phase_attack_trained(data: str, log: str, model: str = "pointnet2") -> dict:
    """NB with ``--save_adv`` on the port's own trained checkpoint, then
    ``cli.eval --adv_set`` on what it wrote."""
    from pointsecguard_tpu_torch.cli import attack, eval as cli_eval

    clean_m, adv_m = attack.main([
        "--model", model, "--attack", "nb", "--save_adv", "--data_root", data,
        "--log_dir", log, "--num_point", str(NUM_POINT), "--batch_size", str(BATCH),
        "--max_blocks", str(MAX_BLOCKS)])
    rows = read_tsv(os.path.join(log, f"{model}_nb_area5.tsv"))
    clean = float(np.mean([float(r["clean_acc"]) for r in rows]))
    adv = float(np.mean([float(r["adv_acc"]) for r in rows]))
    path = os.path.join(log, f"{model}_nb_adv_area5.npz")
    m = cli_eval.main(["--model", model, "--log_dir", log, "--adv_set", path,
                       "--batch_size", str(BATCH)])
    stats = {"blocks": len(rows), "clean_acc": clean, "adv_acc": adv,
             "l2_mean": float(np.mean([float(r["l2"]) for r in rows])),
             "ms_per_block_warm_median": float(np.median(
                 [1e3 * float(r["time_s"]) for r in rows[BATCH:]])),
             "clean_miou": clean_m.miou, "adv_miou": adv_m.miou,
             "adv_set_accuracy": m.accuracy}
    print(("attack on the trained checkpoint: " if model == "pointnet2" else
           f"{model} attack on the trained checkpoint: ") + json.dumps(stats))
    if len(rows) != MAX_BLOCKS or not adv < clean:
        raise AssertionError("NB did not lower the trained model's accuracy")
    if clean < 2 / 13:
        raise AssertionError(f"the trained model has no accuracy to attack: {clean}")
    # the TSV rounds each block to 4 decimals; the .npz holds the same
    # blocks and the checkpoint is the same
    if abs(m.accuracy - adv) > 1e-3:
        raise AssertionError(f"--adv_set accuracy {m.accuracy} != the attack run's {adv}")
    return stats


def phase_bottom_k_vjp(dev) -> dict:
    """The value gradient of ``bottom_k_indices`` on the card (one
    ``autograd.Function`` over every route). On the 3-NN inputs of one
    ``build_geometry`` of [8, 4096] (kernel B) and on rows of 9000 (the
    wide-row kernel): values and indices bit-equal to the kernels' own
    wrappers, each kernel launched once a call, and d(values)/d(vals)
    bit-equal to the CPU's on the same values (a scatter of the same
    cotangent at the same indices). Then the 3-NN weights' gradient with
    respect to both point sets, card and CPU, each against a float64
    evaluation at its own indices: the weights go as 1 / d², and d² =
    |q|² − 2 q·p + |p|² of points a few millimetres apart in a 4 m room
    loses ~1 % to cancellation in float32 on either device (the card's
    GEMM rounds it differently), so the card must come as close to
    float64 as the CPU, within a factor of 2, with 3-NN indices equal on
    ≥ 0.999 of the entries."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models import build_geometry
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked
    from pointsecguard_tpu_torch.ops.selection import bottom_k_indices

    xyz = slice_blocks(dev)[..., :3].contiguous()
    geo = build_geometry(xyz)
    levels = [xyz] + [geo["sa"][li][0] for li in range(4)]
    gen = torch.Generator(device=dev).manual_seed(9)
    wide = torch.rand((2, 64, 9000), generator=gen, device=dev)
    cases = [(ops.square_distance(levels[li], levels[li + 1]), 3, bottomk.bottom_k)
             for li in range(4)] + [(wide, 16, bottomk_chunked.bottom_k_chunked)]
    kernels.reset_launch_counts()
    for vals, k, direct in cases:
        grads, outs = [], []
        for device in (dev, torch.device("cpu")):
            leaf = vals.detach().to(device).requires_grad_(True)
            v, i = bottom_k_indices(leaf, k)
            cot = torch.linspace(-1.0, 1.0, v.numel(), device=device).view_as(v)
            (v * cot).sum().backward()
            grads.append(leaf.grad.cpu())
            outs.append((v.detach().cpu(), i.cpu()))
        want_v, want_i = direct(vals, k)
        if not (torch.equal(outs[0][0], want_v.cpu()) and torch.equal(outs[0][1], want_i.cpu())):
            raise AssertionError(f"bottom_k_indices at {tuple(vals.shape)} k={k}: values or "
                                 "indices differ from the kernel's own")
        if not torch.equal(grads[0], grads[1]):
            raise AssertionError(f"bottom-k value VJP at {tuple(vals.shape)}: card != CPU")
    counts = kernels.launch_counts()
    # the direct wrapper calls above launch once more each
    if counts["bottom_k"] != 8 or counts["bottom_k_chunked"] != 2:
        raise AssertionError(f"bottom-k VJP launches {counts}")
    res = {"vjp_bit_equal_card_vs_cpu": True, "launches": {
        k: v for k, v in counts.items() if k.startswith("bottom_k")}}

    def weights64(dst, src, idx):
        # the 3-NN weights in float64 from the difference form at given
        # indices: no |q|² − 2 q·p + |p|² cancellation
        d = ((dst[:, :, None, :] - ops.gather_points(src, idx)) ** 2).sum(-1)
        recip = 1.0 / (d + 1e-8)
        return recip / recip.sum(-1, keepdim=True)

    errs, agree = {"card": [], "cpu": []}, []
    for li in range(4):
        idx_of = {}
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            dst = levels[li].detach().to(device).requires_grad_(True)
            src = levels[li + 1].detach().to(device).requires_grad_(True)
            idx, w = ops.three_nn_plan(dst, src)
            cot = torch.linspace(-1.0, 1.0, w.numel(), device=device).view_as(w)
            (w * cot).sum().backward()
            d64 = levels[li].detach().cpu().double().requires_grad_(True)
            s64 = levels[li + 1].detach().cpu().double().requires_grad_(True)
            (weights64(d64, s64, idx.cpu().long()) * cot.cpu().double()).sum().backward()
            errs[name] += [_rel_l2(dst.grad, d64.grad), _rel_l2(src.grad, s64.grad)]
            idx_of[name] = idx.cpu()
        agree.append((idx_of["card"] == idx_of["cpu"]).float().mean().item())
    res["three_nn_index_agreement_min"] = min(agree)
    res["three_nn_grad_rel_l2_vs_float64"] = {k: max(v) for k, v in errs.items()}
    print("bottom-k value VJP on the card: " + json.dumps(res))
    card, cpu = res["three_nn_grad_rel_l2_vs_float64"].values()
    if not (min(agree) >= 0.999 and card <= 2 * cpu + 1e-6):
        raise AssertionError("3-NN weight gradient: the card is further from float64 than "
                             "twice the CPU")
    return res


def randla_train_batch(prep: str, dev, batch: int, num_points: int, seed: int):
    """One batch of the train split's sampler: features [B, P, 6] and
    labels [B, P] on ``dev``."""
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler

    sampler = SpatiallyRegularSampler.load(prep, split="train", num_points=num_points,
                                           rng=np.random.default_rng(seed))
    _, feats, labels, _, _ = next(sampler.batches(batch, 1))
    return torch.from_numpy(feats).to(dev), torch.from_numpy(labels).long().to(dev)


def phase_randla_train_knn(dev, records, prep: str):
    """``knn`` at the shapes of one RandLA training step: one
    ``build_pyramid`` of [6, 40960] on the train sampler's clouds; indices
    and values equal to plain at each of its 10 calls, 10 launches; times
    as in ``phase_randla_kernels``. Returns the batch."""
    from pointsecguard_tpu_torch.models import build_pyramid
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.cuda import bounds, knn

    feats, labels = randla_train_batch(prep, dev, RANDLA_TRAIN_BATCH, RANDLA_POINTS, 0)
    xyz = feats[..., :3].contiguous()
    calls = pyramid_knn_inputs(xyz)
    err = 0.0
    for q, p, k in calls:
        err = max(err, _equal(f"knn (train step) {tuple(q.shape)} x {tuple(p.shape)} k={k}",
                              knn.knn(q, p, k), knn.knn_plain(q, p, k)))
    kernels.reset_launch_counts()
    build_pyramid(xyz)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["knn"]
    if launches != 10:
        raise AssertionError(f"build_pyramid launched knn {launches} times, want 10")

    def run(f):
        return lambda: [f(q, p, k) for q, p, k in calls]

    work = bounds.total(bounds.knn(q.shape[0], q.shape[1], p.shape[1], q.shape[2], k)
                        for q, p, k in calls)
    rec = {"unit": f"one build_pyramid of [{RANDLA_TRAIN_BATCH}, {RANDLA_POINTS}] "
                   "(a train step)",
           "eager_ms": cuda_ms(run(knn.knn), reps=10), "ms": device_ms(run(knn.knn), reps=3),
           "plain_ms": cuda_ms(run(knn.knn_plain), reps=2, warmup=1),
           "bound_ms": work.bound_ms, "bound_by": work.bound_by, "library_ms": None,
           "launches": launches, "max_abs_err": err}
    print(f"knn (train step): kernel {rec['ms']:.4f} ms on the card ({rec['eager_ms']:.4f} ms "
          f"as eager calls, median), plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {work.bytes} bytes, "
          f"{work.operations} operations; share {rec['bound_ms'] / rec['ms']:.3f}) per "
          f"build_pyramid of [{RANDLA_TRAIN_BATCH}, {RANDLA_POINTS}], {launches} launches; "
          "values and indices equal to plain")
    records["knn"]["train_step"] = rec
    return feats, labels


def _noise_only(key: str) -> bool:
    """A Linear bias under a BatchNorm (every conv's, and fc0's under bn0):
    its true gradient is 0, what is there is rounding noise."""
    return key.endswith("dense.bias") or key == "fc0.bias"


def phase_randla_train_step(dev, prep: str) -> dict:
    """One optimizer step of the full-width RandLA-Net from the same
    weights (flax-style initialisation), sampler batch (2 ×
    ``RANDLA_STEP_POINTS`` points of the train cloud) and dropout mask, on the card (kernels) and on the
    CPU (plain versions). Pyramid indices equal at every level; the step
    runs on both devices on the card's pyramid. Tolerances as in
    ``phase_train_step``: loss 1e-4 relative; the gradient and Adam's
    first moment 2e-2 in relative L2 and the second moment 4e-2, without
    the biases under a BatchNorm; BatchNorm statistics 1e-3 of the
    largest; the parameters' move within 1e-5 where |g| is clear of
    rounding noise (above a fifth of its tensor's largest entry)."""
    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.models import RandLANet, init_parameters, weighted_softmax_ce_loss
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, randla_family

    feats, labels = randla_train_batch(prep, dev, 2, RANDLA_STEP_POINTS, 3)
    weights = torch.from_numpy(get_class_weights("S3DIS"))
    mask = torch.rand((2, RANDLA_STEP_POINTS, 32), generator=torch.Generator().manual_seed(12)) >= 0.5
    family = randla_family()
    t0 = time.perf_counter()
    pyr_cpu = family.plan(feats.cpu())
    cpu_pyramid_s = time.perf_counter() - t0
    pyr_gpu = family.plan(feats)
    for key in ("neigh_idx", "sub_idx", "interp_idx"):
        for level, (g, c) in enumerate(zip(pyr_gpu[key], pyr_cpu[key])):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"train step: card/CPU pyramid {key}[{level}] differ")
    pyr_shared = {k: tuple(t.cpu() for t in v) for k, v in pyr_gpu.items()}

    out = {}
    for name, device, pyr in (("card", dev, pyr_gpu), ("cpu", torch.device("cpu"), pyr_shared)):
        model = RandLANet()
        init_parameters(model, torch.Generator().manual_seed(3))
        state = TrainState(model.to(device))
        before = state.params.clone()
        step = make_train_step(model, weighted_softmax_ce_loss, weight_decay=0.0, family=family)
        t0 = time.perf_counter()
        loss = step(state, feats.to(device), labels.to(device), weights.to(device), 1e-2, None,
                    dropout_mask=mask.to(device), geometry=pyr)
        named = [(k, p.numel()) for k, p in model.named_parameters()]
        out[name] = {"loss": loss.item(), "grads": state.grads.cpu(), "mu": state.mu.cpu(),
                     "nu": state.nu.cpu(), "move": (state.params - before).cpu(),
                     "stats": state.stats.cpu(), "seconds": time.perf_counter() - t0}
    card, cpu = out["card"], out["cpu"]
    sizes = [n for _, n in named]
    signal = torch.cat([torch.full((n,), not _noise_only(k)) for k, n in named])
    clear = torch.cat([(g.abs() > 0.2 * g.abs().max()) & (not _noise_only(k))
                       for (k, _), g in zip(named, cpu["grads"].split(sizes))])
    res = {
        "points": [2, RANDLA_STEP_POINTS],
        "loss_card": card["loss"], "loss_cpu": cpu["loss"],
        "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        "grad_rel_l2": _rel_l2(card["grads"][signal], cpu["grads"][signal]),
        "mu_rel_l2": _rel_l2(card["mu"][signal], cpu["mu"][signal]),
        "nu_rel_l2": _rel_l2(card["nu"][signal], cpu["nu"][signal]),
        "move_max_abs_where_clear": (card["move"] - cpu["move"])[clear].abs().max().item(),
        "clear_entries": int(clear.sum()),
        "stats_max_abs": (card["stats"] - cpu["stats"]).abs().max().item(),
        "stats_max": cpu["stats"].abs().max().item(),
        "cpu_pyramid_s": cpu_pyramid_s, "cpu_step_s": cpu["seconds"],
    }
    print("randla train step, card vs CPU: " + json.dumps(res))
    ok = (math.isfinite(card["loss"]) and res["loss_rel"] <= 1e-4
          and res["grad_rel_l2"] <= 2e-2 and res["mu_rel_l2"] <= 2e-2
          and res["nu_rel_l2"] <= 4e-2 and res["move_max_abs_where_clear"] <= 1e-5
          and res["clear_entries"] > 10_000
          and res["stats_max_abs"] <= 1e-3 * res["stats_max"]
          and card["move"].abs().max().item() > 0)
    if not ok:
        raise AssertionError("the card's RandLA train step disagrees with the CPU's")
    return res


def phase_fused_train(dev, records, feats, labels) -> dict:
    """One train-mode forward and backward of the full-width RandLA-Net with
    ``ap_impl="fused"`` and ``"reference"`` on the same batch of 6 × 40960
    points, weights and dropout mask: the parameter gradients (without the
    biases under a BatchNorm) against a float64 evaluation of the
    reference, in relative L2; the fused one must come as close as the
    float32 reference, within a factor of 2. The fused pass launches 4
    forward and 4 backward (with dW) attentive kernels. Then the attentive
    backward with dW at the step's shapes ([16, 245760, 8] and
    [16, 61440, 32]): kernel against plain and timed."""
    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.models import (
        RandLANet, build_pyramid, init_parameters, weighted_softmax_ce_loss,
    )
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.attentive import attentive_pool_fused_plain as plain
    from pointsecguard_tpu_torch.ops.cuda import attentive, bounds

    pyr = build_pyramid(feats[..., :3])
    weights = torch.from_numpy(get_class_weights("S3DIS")).to(dev)
    mask = torch.rand((*feats.shape[:2], 32), generator=torch.Generator(device=dev).manual_seed(13),
                      device=dev) >= 0.5
    model0 = RandLANet()
    init_parameters(model0, torch.Generator().manual_seed(5))
    sd = model0.state_dict()
    keys = [k for k, _ in model0.named_parameters()]
    grads, counts = {}, None
    for ap_impl, dtype in (("reference", torch.float64), ("reference", torch.float32),
                           ("fused", torch.float32)):
        model = RandLANet(ap_impl=ap_impl)
        model.load_state_dict(sd)
        model.to(dev, dtype).train()
        p = dict(pyr, xyz=tuple(x.to(dtype) for x in pyr["xyz"]))
        kernels.reset_launch_counts()
        logits = model(feats.to(dtype), p, dropout_mask=mask)
        loss = weighted_softmax_ce_loss(logits, labels, weights.to(dtype))
        g = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        if ap_impl == "fused":
            counts = kernels.launch_counts()
        grads[ap_impl, dtype] = torch.cat([t.reshape(-1).double() for k, t in zip(keys, g)
                                           if not _noise_only(k)])
        del model, logits, loss, g
    g64 = grads["reference", torch.float64]
    ref_err = _rel_l2(grads["reference", torch.float32], g64)
    fused_err = _rel_l2(grads["fused", torch.float32], g64)
    res = {"points": list(feats.shape[:2]), "grad_rel_l2_reference": ref_err,
           "grad_rel_l2_fused": fused_err, "attentive_launches": {
               k: counts[k] for k in ("attentive_fwd", "attentive_bwd")}}
    print("fused vs reference RandLA, train mode: " + json.dumps(res))
    if (counts["attentive_fwd"], counts["attentive_bwd"]) != (4, 4):
        raise AssertionError(f"fused train-mode pass launches {counts}, want 4 and 4")
    if not (math.isfinite(fused_err) and fused_err <= 2 * ref_err):
        raise AssertionError("the fused parameter gradient is further from float64 than "
                             "twice the float32 reference's")
    del grads, g64

    gen = torch.Generator(device=dev).manual_seed(14)
    calls = [attentive_case(*ATT_TRAIN_SHAPES[i // 2], gen, dev) for i in range(4)]
    cots = [tuple(torch.randn((2, M, D), generator=gen, device=dev))
            for _, M, D in (ATT_TRAIN_SHAPES[i // 2] for i in range(4))]
    err = 0.0
    for (fn, fx, w), (g1, g2) in zip(calls[::2], cots[::2]):
        got = {}
        for name, f in (("kernel", attentive.attentive_pool_fused), ("plain", plain)):
            leaves = [fn.clone().requires_grad_(True), fx.clone().requires_grad_(True),
                      w.clone().requires_grad_(True)]
            got[name] = torch.autograd.grad(f(*leaves), leaves, (g1, g2))
        for gname, a, b in zip(("dfn", "dfx", "dw"), got["kernel"], got["plain"]):
            err = max(err, grad_err(f"attentive {gname} (train) {tuple(fn.shape)}", a, b))
    times = {}
    for name, f in (("kernel", attentive.attentive_pool_fused), ("plain", plain)):
        leaves = [(fn.clone().requires_grad_(True), fx.clone().requires_grad_(True),
                   w.clone().requires_grad_(True)) for fn, fx, w in calls]
        outs = [o for lv in leaves for o in f(*lv)]
        flat = [t for lv in leaves for t in lv]
        cot = [g for c in cots for g in c]

        def bwd():
            return torch.autograd.grad(outs, flat, cot, retain_graph=True)

        times[name] = (cuda_ms(bwd, reps=10), device_ms(bwd, reps=5) if name == "kernel" else None)
        del leaves, outs, flat
    work = bounds.total(bounds.attentive_bwd(*ATT_TRAIN_SHAPES[i // 2], True) for i in range(4))
    rec = {"unit": "backward with dW of the 4 calls of one training pass: "
                   + ", ".join(f"2 x {list(s)}" for s in ATT_TRAIN_SHAPES),
           "ms": times["kernel"][1], "eager_ms": times["kernel"][0],
           "plain_ms": times["plain"][0], "bound_ms": work.bound_ms, "bound_by": work.bound_by,
           "library_ms": None, "launches": counts["attentive_bwd"], "max_abs_err": err}
    print(f"attentive bwd with dW (train step): kernel {rec['ms']:.4f} ms on the card "
          f"({rec['eager_ms']:.4f} ms as eager calls), plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {work.bytes} bytes, "
          f"{work.operations} operations; share {rec['bound_ms'] / rec['ms']:.3f}); "
          f"{rec['launches']} launches per training pass; within tolerance of plain")
    records["attentive_bwd"]["train_step"] = rec
    res["attentive_bwd_dw"] = rec
    return res


def phase_randla_train(dev, records, prep: str) -> tuple[str, dict]:
    """Training through ``cli.train.main --model randla`` at full width,
    then a resumed call with one more epoch; returns the log dir and the
    figures of the run."""
    from pointsecguard_tpu_torch.cli import train as cli
    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler
    from pointsecguard_tpu_torch.models import RandLANet, weighted_softmax_ce_loss
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, randla_family
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

    log = os.path.join(WORK, "randla_train_log")

    def argv(epochs):
        return ["--model", "randla", "--randla_dir", prep, "--log_dir", log,
                "--randla_points", str(RANDLA_POINTS), "--batch_size", str(RANDLA_TRAIN_BATCH),
                "--steps_per_epoch", str(RANDLA_TRAIN_STEPS),
                "--val_steps", str(RANDLA_VAL_STEPS), "--epochs", str(epochs)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, best_miou = cli.main(argv(RANDLA_TRAIN_EPOCHS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    events = read_events(log)
    epochs = [e for e in events if e["event"] == "epoch"]
    evals = [e for e in events if e["event"] == "eval"]
    if [e["epoch"] for e in epochs] != list(range(RANDLA_TRAIN_EPOCHS)) or len(evals) != len(epochs):
        raise AssertionError(f"epoch lines {[e['epoch'] for e in epochs]}, {len(evals)} evals")
    if any(e["batches"] != RANDLA_TRAIN_STEPS or e["nan_batches"] for e in epochs):
        raise AssertionError(f"steps or skipped batches: {epochs}")
    if not all(math.isfinite(e["loss"]) for e in epochs):
        raise AssertionError("a non-finite epoch loss")
    if not epochs[-1]["loss"] < epochs[0]["loss"]:
        raise AssertionError("the last epoch's mean loss is not below the first's")
    steps = RANDLA_TRAIN_STEPS * RANDLA_TRAIN_EPOCHS
    val_clouds = RANDLA_VAL_STEPS * RANDLA_TRAIN_EPOCHS
    if counts["knn"] != 10 * (steps + val_clouds):
        raise AssertionError(f"randla train launches {counts}, want knn 10 × ({steps} steps + "
                             f"{val_clouds} validation clouds)")
    if any(counts[k] for k in counts if k != "knn"):
        raise AssertionError(f"a kernel off the training path launched: {counts}")
    records["knn"]["launches_by_path"]["randla train"] = counts["knn"]
    records["knn"]["calls_per_batch"]["randla train step"] = 10
    records["knn"]["calls_per_batch"]["randla validation cloud"] = 10

    cli.main(argv(RANDLA_TRAIN_EPOCHS + 1))
    resumed = [e["epoch"] for e in read_events(log) if e["event"] == "epoch"]
    if resumed != list(range(RANDLA_TRAIN_EPOCHS + 1)):
        raise AssertionError(f"epochs after the resumed call: {resumed}")
    latest = CheckpointManager(os.path.join(log, "checkpoints")).restore_latest()
    if (latest["epoch"] != RANDLA_TRAIN_EPOCHS + 1
            or latest["step"] != steps + RANDLA_TRAIN_STEPS):
        raise AssertionError(f"resumed checkpoint: epoch {latest['epoch']}, step {latest['step']}")

    # the step alone on the card: CUDA events around each of 5 steps on a
    # batch that already lies there
    model = RandLANet()
    state = TrainState(model.to(dev))
    state.load_payload(latest)
    step = make_train_step(model, weighted_softmax_ce_loss, weight_decay=0.0,
                           family=randla_family())
    feats, labels = randla_train_batch(prep, dev, RANDLA_TRAIN_BATCH, RANDLA_POINTS, 1)
    weights = torch.from_numpy(get_class_weights("S3DIS")).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = cuda_ms(lambda: step(state, feats, labels, weights, 1e-4, None, gen), reps=5)
    sampler = SpatiallyRegularSampler.load(prep, split="train", num_points=RANDLA_POINTS,
                                           rng=np.random.default_rng(2))
    t0 = time.perf_counter()
    for _ in sampler.batches(RANDLA_TRAIN_BATCH, 5):
        pass
    sampler_ms = 1e3 * (time.perf_counter() - t0) / 5

    warm = epochs[1:]  # the first epoch pays the one-off CUDA set-up
    # an epoch's line is written before its validation runs
    host_ms = 1e3 * sum(e["seconds"] for e in warm) / sum(e["batches"] for e in warm)
    stats = {
        "batch": [RANDLA_TRAIN_BATCH, RANDLA_POINTS], "steps_per_epoch": RANDLA_TRAIN_STEPS,
        "steps": steps, "val_clouds": val_clouds,
        "epoch_loss": [e["loss"] for e in epochs],
        "val_accuracy": [e["accuracy"] for e in evals], "val_miou": [e["miou"] for e in evals],
        "best_miou": best_miou,
        "randla_train_ms_per_step_host_clock": host_ms,
        "ms_per_step_host_clock_by_epoch": [1e3 * e["seconds"] / e["batches"] for e in epochs],
        "randla_train_ms_per_step": step_ms,
        "randla_train_hostpipe_clouds_per_sec": 1e3 * RANDLA_TRAIN_BATCH / host_ms,
        "host_share": 1.0 - step_ms / host_ms,
        "sampler_ms_per_batch_alone": sampler_ms,
        "peak_device_memory_gb": peak / 1e9,
        "main_wall_s": wall, "launches": counts,
    }
    print("randla train: " + json.dumps(stats))
    return log, stats


def phase_randla_eval(prep: str, log: str, records) -> dict:
    """``cli.eval.main --model randla`` on the trained checkpoint: 8
    samples at batch 4 voted onto the Area-5 cloud and reprojected to its
    full resolution; accuracy at or above ``RANDLA_EVAL_ACC_FLOOR``."""
    from pointsecguard_tpu_torch.cli import eval as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = cli.main(["--model", "randla", "--randla_dir", prep, "--log_dir", log,
                  "--randla_points", str(RANDLA_POINTS), "--num_clouds", str(RANDLA_EVAL_CLOUDS),
                  "--batch_size", str(RANDLA_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    stats = {"accuracy": m.accuracy, "miou": m.miou, "clouds": RANDLA_EVAL_CLOUDS,
             "randla_eval_ms_per_cloud": 1e3 * wall / RANDLA_EVAL_CLOUDS, "launches": counts}
    print(f"randla eval: {json.dumps(stats)} (floor {RANDLA_EVAL_ACC_FLOOR}, chance 1/13 = "
          f"{1 / 13:.4f})")
    if not (math.isfinite(m.miou) and m.accuracy >= RANDLA_EVAL_ACC_FLOOR >= 2 / 13):
        raise AssertionError(f"randla eval accuracy {m.accuracy} under the floor "
                             f"{RANDLA_EVAL_ACC_FLOOR}")
    if counts["knn"] != 10 * RANDLA_EVAL_CLOUDS // RANDLA_BATCH:
        raise AssertionError(f"randla eval launches {counts}, want knn 10 per batch")
    records["knn"]["launches_by_path"]["randla eval"] = counts["knn"]
    records["knn"]["calls_per_batch"]["randla eval batch"] = 10
    return stats


def phase_randla_attack_trained(prep: str, log: str) -> dict:
    """NB with ``--save_adv`` on the trained RandLA checkpoint, 8 clouds at
    batch 4, then ``cli.eval --model randla --adv_set`` on what it wrote."""
    from pointsecguard_tpu_torch.cli import eval as cli_eval

    stats = run_randla_cli(prep, log, "nb", False, RANDLA_CLOUDS,
                           extra=("--save_adv", "--randla_points", str(RANDLA_POINTS)))
    path = os.path.join(log, "randla_nb_adv_area5.npz")
    m = cli_eval.main(["--model", "randla", "--log_dir", log, "--adv_set", path,
                       "--batch_size", str(RANDLA_BATCH)])
    stats["adv_set_accuracy"] = m.accuracy
    print("randla attack on the trained checkpoint: " + json.dumps(stats))
    if not stats["adv_acc"] < stats["clean_acc"]:
        raise AssertionError("NB did not lower the trained RandLA model's accuracy")
    if stats["clean_acc"] < 2 / 13:
        raise AssertionError(f"the trained RandLA model has no accuracy to attack: "
                             f"{stats['clean_acc']}")
    # the TSV rounds each cloud to 4 decimals; the .npz holds the same clouds
    if abs(m.accuracy - stats["adv_acc"]) > 1e-3:
        raise AssertionError(f"--adv_set accuracy {m.accuracy} != the attack run's "
                             f"{stats['adv_acc']}")
    return stats


def resgcn_room_batch(data: str, n: int, dev, seed: int = 0):
    """The first n whole-scene blocks [n, 4096, 9] of the Area-5 room under
    ``data`` and their labels [n, 4096], on ``dev``."""
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks

    rooms = RoomSet.load(data, "test", 5)
    blocks, labels, *_ = WholeSceneBlocks(rooms, block_points=NUM_POINT).room_blocks(
        0, np.random.default_rng(seed))
    return (torch.from_numpy(blocks[:n]).to(dev),
            torch.from_numpy(labels[:n].astype(np.int64)).to(dev))


def resgcn_state_dict(seed: int, blocks: torch.Tensor) -> dict:
    """Full-width ResGCN-28 weights from a seeded generator as flax
    initialises them (``kaiming_normal``, biases 0), with BatchNorm
    statistics from one train-mode forward over ``blocks`` at keep 0, so
    that the random network's predictions vary from point to point."""
    import functools

    from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters
    from pointsecguard_tpu_torch.models.common import BatchNorm

    model = DenseDeepGCN()
    init_parameters(model, torch.Generator().manual_seed(seed), scale=2.0)
    n = sum(t.numel() for t in model.state_dict().values())
    if n != RESGCN_STATE_FLOATS or len(model.state_dict()) != 188:
        raise AssertionError(f"ResGCN state holds {n} floats in {len(model.state_dict())} "
                             f"tensors, want {RESGCN_STATE_FLOATS} in 188")
    model.to(blocks.device).train()
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.forward = functools.partial(BatchNorm.forward, m, momentum=0.0)
    with torch.no_grad():
        model(blocks)
    for m in bns:
        del m.forward
    return model.state_dict()


def resgcn_model(sd: dict, dev):
    from pointsecguard_tpu_torch.models import DenseDeepGCN

    model = DenseDeepGCN()
    model.load_state_dict(sd)
    return model.to(dev).eval()


def block_inputs(model, points: torch.Tensor) -> tuple[dict, tuple]:
    """The input features of every backbone block (hooks) and the graphs
    of one evaluation-mode forward of ``points``."""
    inputs = {}
    hooks = [blk.register_forward_pre_hook(
        lambda mod, args, i=i: inputs.__setitem__(i, args[0].detach()))
        for i, blk in enumerate(model.backbone)]
    with torch.no_grad():
        _, graphs = model(points, collect_graphs=True)
    for h in hooks:
        h.remove()
    return inputs, graphs


def near_tie_check(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor,
                   points: torch.Tensor | None = None):
    """Rows of a kNN graph of the queries ``x`` [B, N, D] among ``points``
    [B, M, D] (``x`` itself by default) where ``got`` and ``want`` differ,
    and how many of them differ by more than a near-tie. A row's
    difference is a near-tie when ``got`` holds no index twice and the
    distances (the plain version's ``square_distance``, on ``x``'s device)
    of ``got``'s neighbours equal those of ``want``'s position by position
    within 4 ulp of |q|² + the largest |p|² of those neighbours, the scale
    of the distance's rounding: a different summation order may swap
    neighbours only inside such a run. Returns (differing rows, rows that
    differ by more than a near-tie)."""
    from pointsecguard_tpu_torch.ops.distance import square_distance

    points = x if points is None else points
    got = got.to(want.device)
    rows = (got != want).any(-1).nonzero()
    bad = 0
    eps = torch.finfo(torch.float32).eps
    for c in range(0, rows.shape[0], 256):
        b, s = rows[c : c + 256].unbind(1)
        g, w = got[b, s].to(x.device).long(), want[b, s].to(x.device).long()
        b, s = b.to(x.device), s.to(x.device)
        q = x[b, s][:, None, :]
        d = square_distance(q, points[b])[:, 0]  # [m, M]
        p2 = (points[b[:, None], torch.cat([g, w], 1)] ** 2).sum(-1).amax(-1)
        scale = (q[:, 0] ** 2).sum(-1) + p2
        apart = (d.gather(1, g) - d.gather(1, w)).abs().amax(-1) > 4 * eps * scale
        srt = g.sort(-1).values
        bad += int((apart | (srt[:, 1:] == srt[:, :-1]).any(-1)).sum())
    return int(rows.shape[0]), bad


def phase_resgcn_kernels(dev, records, data: str) -> dict:
    """27. kNN at the four shapes of one full-width ResGCN forward of 8
    blocks of the Area-5 room (seeded weights): the head graph over xyz
    (D = 3, k = 16) and DynConv_0..2 over their real input features
    (D = 64, k·d = 16, 32, 48). Each call equal to plain, or different only
    in near-tie rows (``near_tie_check``); card, eager and plain ms, bound
    and share; 4 launches a forward. Then the large-k selection of
    DynConv_3..26 (k·d = 64 … 432) on their [8, 4096, 4096] distances: the
    stable sort (the route), the ``bottom_k`` kernel (equal indices) and
    ``torch.topk`` (equal values), each timed."""
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bounds, knn
    from pointsecguard_tpu_torch.ops.distance import square_distance

    blocks, _ = resgcn_room_batch(data, RESGCN_BATCH, dev)
    model = resgcn_model(resgcn_state_dict(0, blocks), dev)
    inputs, _ = block_inputs(model, blocks)
    kernels.reset_launch_counts()
    with torch.no_grad():
        model(blocks)
    torch.cuda.synchronize()
    per_forward = kernels.launch_counts()["knn"]
    if per_forward != 4:
        raise AssertionError(f"one ResGCN forward launched knn {per_forward} times, want 4")
    calls = [("head graph, xyz", blocks[..., :3].contiguous(), 16)] + [
        (f"DynConv_{i}", inputs[i].contiguous(), 16 * (i + 1)) for i in range(3)]
    rows, total = [], bounds.Work()
    for name, x, k in calls:
        got, want = knn.knn(x, x, k), knn.knn_plain(x, x, k)
        torch.cuda.synchronize()
        differ, bad = near_tie_check(x, got[1], want[1])
        if bad:
            raise AssertionError(f"knn {name} {tuple(x.shape)} k={k}: {differ} rows differ "
                                 f"from plain, {bad} of them not near-ties")
        if not differ and not torch.equal(got[0], want[0]):
            raise AssertionError(f"knn {name}: equal indices, different distances")
        work = bounds.knn(x.shape[0], x.shape[1], x.shape[1], x.shape[2], k)
        total = total + work
        rec = {"call": name, "shape": list(x.shape), "k": k,
               "ms": device_ms(lambda: knn.knn(x, x, k), reps=5),
               "eager_ms": cuda_ms(lambda: knn.knn(x, x, k), reps=10),
               "plain_ms": cuda_ms(lambda: knn.knn_plain(x, x, k), reps=3),
               "bound_ms": work.bound_ms, "bound_by": work.bound_by,
               # a yardstick, not an equivalent: cuBLAS's full-float32 GEMM
               # of the cross term alone, no norms and no selection
               "cross_bmm_ms": device_ms(lambda: torch.bmm(x, x.transpose(1, 2)), reps=5),
               "launches_per_forward": 1, "rows_differ": differ, "rows_not_near_tie": bad}
        rec["share"] = rec["bound_ms"] / rec["ms"]
        rows.append(rec)
        print(f"resgcn knn {name} {tuple(x.shape)} k={k}: {rec['ms']:.4f} ms on the card "
              f"({rec['eager_ms']:.4f} eager), plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), share {rec['share']:.3f}, "
              f"cross-term torch.bmm {rec['cross_bmm_ms']:.4f} ms; "
              f"{differ} rows differ from plain, all near-ties")
    forward_ms = sum(r["ms"] for r in rows)
    records["knn"]["resgcn_forward"] = {
        "unit": f"4 calls of one ResGCN-28 forward of [{RESGCN_BATCH}, {NUM_POINT}]",
        "ms": forward_ms, "bound_ms": total.bound_ms, "bound_by": total.bound_by,
        "launches": per_forward, "calls": rows}

    # large-k selection of the dilated graphs: not a TPU kernel (lax.top_k
    # in JAX); the port's route is the stable sort
    large = []
    for i in range(3, len(model.backbone)):
        K = 16 * (i + 1)
        d = square_distance(inputs[i], inputs[i])
        v_sort, i_sort = bottomk.bottom_k_plain(d, K)
        v_bk, i_bk = bottomk.bottom_k(d, K)
        v_top, _ = topk_library(d, K)
        torch.cuda.synchronize()
        if not (torch.equal(i_bk, i_sort) and torch.equal(v_bk, v_sort)
                and torch.equal(v_top, v_sort)):
            raise AssertionError(f"large-k selection k={K}: bottom_k or torch.topk != the sort")
        large.append({"block": f"DynConv_{i}", "k": K,
                      "sort_ms": device_ms(lambda: bottomk.bottom_k_plain(d, K), reps=3),
                      "bottom_k_ms": device_ms(lambda: bottomk.bottom_k(d, K), reps=3),
                      "topk_ms": device_ms(lambda: topk_library(d, K), reps=3),
                      "bottom_k_bound_ms": bounds.bottom_k(d.numel() // d.shape[-1],
                                                           d.shape[-1], K).bound_ms})
        del d, v_sort, i_sort, v_bk, i_bk, v_top
    sums = {key: sum(r[key] for r in large) for key in ("sort_ms", "bottom_k_ms", "topk_ms")}
    print(f"resgcn large-k selection, {len(large)} graphs a forward (k·d = 64 … "
          f"{large[-1]['k']}) on [{RESGCN_BATCH}, {NUM_POINT}, {NUM_POINT}]: stable sort "
          f"{sums['sort_ms']:.3f} ms, bottom_k kernel {sums['bottom_k_ms']:.3f} ms, "
          f"torch.topk {sums['topk_ms']:.3f} ms a forward; per k: " + json.dumps(large))
    # a record of its own: the bottom_k kernel never launches on this route
    return {"name": "resgcn_large_k_selection",
            "route": "torch.sort (stable): bottom_k_plain, not a kernel of the port",
            "replaces": "pointsecguard_tpu/ops/selection.py:160 (lax.top_k, not a Pallas kernel)",
            "timed_beside": ["bottom_k kernel", "torch.topk"],
            "per_forward": sums, "per_k": large}


RESGCN_FAST = {"dilated_mode": "subsample", "knn_strategy": "approx"}  # --resgcn_fast
RESGCN_FAST_LAUNCHES = 28  # psg::knn a forward: the head, DynConv_0 and 26 subsample graphs


def resgcn_fast_model(sd: dict, dev):
    from pointsecguard_tpu_torch.models import DenseDeepGCN

    model = DenseDeepGCN(**RESGCN_FAST)
    model.load_state_dict(sd)
    return model.to(dev).eval()


def fast_forward_launches(model, points: torch.Tensor) -> tuple[dict, list]:
    """The launch counts of one no-grad forward of ``model`` and the k of
    every large-k selection it made (``ops.selection``'s stable sort, the
    route of k > 48: none in subsample mode)."""
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops import selection

    sorts, real = [], selection.bottom_k_plain
    selection.bottom_k_plain = lambda v, k: sorts.append(k) or real(v, k)
    try:
        kernels.reset_launch_counts()
        with torch.no_grad():
            model(points)
        torch.cuda.synchronize()
        return kernels.launch_counts(), sorts
    finally:
        selection.bottom_k_plain = real


def phase_resgcn_fast_kernels(dev, records, data: str) -> dict:
    """79. ``--resgcn_fast``'s graphs on the kNN kernel: one forward of the
    full-width ResGCN-28 in subsample mode (phase 27's seeded weights and
    8 blocks) launches ``psg::knn`` 28 times and no other kernel, and makes
    no large-k selection; each of its 26 subsample graphs (DynConv_{d-1}
    for d = 2 … 27: the block's [8, 4096, 64] input features against
    the stride-d candidates [8, ⌈4096/d⌉, 64], k = 16: 2048 down to 152
    rows, most of them no multiple of the kernel's 64-point tile) against
    ``knn_plain`` on the same inputs, equal but in near-tie rows, and equal
    to the model's own graph; card, eager and plain ms, bound and share of
    each and of their sum; a no-grad forward's card ms in both modes."""
    from pointsecguard_tpu_torch.ops.cuda import bounds, knn

    blocks, _ = resgcn_room_batch(data, RESGCN_BATCH, dev)
    sd = resgcn_state_dict(0, blocks)
    fast, exact = resgcn_fast_model(sd, dev), resgcn_model(sd, dev)
    counts, sorts = fast_forward_launches(fast, blocks)
    if counts["knn"] != RESGCN_FAST_LAUNCHES or sorts or \
            any(v for k, v in counts.items() if k != "knn"):
        raise AssertionError(f"a --resgcn_fast forward launched {counts} and sorted at k = "
                             f"{sorts}; want {RESGCN_FAST_LAUNCHES} knn and no sort")
    inputs, graphs = block_inputs(fast, blocks)
    B, N, _ = blocks.shape
    rows, total = [], bounds.Work()
    for i in range(1, len(fast.backbone)):
        d = 1 + i
        x = inputs[i].contiguous()
        cand = x[:, ::d].contiguous()
        got, want = knn.knn(x, cand, fast.k), knn.knn_plain(x, cand, fast.k)
        torch.cuda.synchronize()
        differ, bad = near_tie_check(x, got[1], want[1], cand)
        if bad or not torch.equal(got[1] * d, graphs[1 + i]):
            raise AssertionError(f"knn DynConv_{i} subsample d={d} {tuple(cand.shape)}: {bad} "
                                 f"of {differ} rows apart from plain not near-ties, or the "
                                 "model's graph is another")
        if not differ and not torch.equal(got[0], want[0]):
            raise AssertionError(f"knn DynConv_{i} subsample: equal indices, other distances")
        work = bounds.knn(B, N, cand.shape[1], x.shape[2], fast.k)
        total = total + work
        rec = {"call": f"DynConv_{i}", "d": d, "query": list(x.shape),
               "points": list(cand.shape), "k": fast.k,
               "ms": device_ms(lambda: knn.knn(x, cand, fast.k), reps=5),
               "eager_ms": cuda_ms(lambda: knn.knn(x, cand, fast.k), reps=10),
               "plain_ms": cuda_ms(lambda: knn.knn_plain(x, cand, fast.k), reps=2),
               "bound_ms": work.bound_ms, "bound_by": work.bound_by,
               "rows_differ": differ}
        rec["share"] = rec["bound_ms"] / rec["ms"]
        rows.append(rec)
    forward_ms = {name: cuda_ms(lambda m=m: fast_forward(m, blocks), reps=3)
                  for name, m in (("exact", exact), ("fast", fast))}
    out = {"unit": f"26 subsample graphs of one ResGCN-28 --resgcn_fast forward of "
                   f"[{B}, {N}] (DynConv_1 … _26, d = 2 … 27, k = {fast.k})",
           "ms": sum(r["ms"] for r in rows), "eager_ms": sum(r["eager_ms"] for r in rows),
           "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": total.bound_ms,
           "bound_by": total.bound_by, "launches_per_forward": counts["knn"],
           "large_k_sorts_per_forward": len(sorts), "forward_ms": forward_ms, "calls": rows}
    out["share"] = out["bound_ms"] / out["ms"]
    records["knn"]["resgcn_fast_forward"] = out
    print("resgcn --resgcn_fast knn, per call (d, candidates, card / eager / plain ms, bound, "
          "share): " + json.dumps([(r["d"], r["points"][1], round(r["ms"], 4),
                                    round(r["eager_ms"], 4), round(r["plain_ms"], 3),
                                    round(r["bound_ms"], 4), round(r["share"], 3))
                                   for r in rows]))
    print(f"resgcn --resgcn_fast: {counts['knn']} psg::knn launches and {len(sorts)} large-k "
          f"sorts a forward; the 26 subsample graphs {out['ms']:.4f} ms on the card "
          f"({out['eager_ms']:.4f} eager, plain {out['plain_ms']:.3f}), bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}), share {out['share']:.3f}; "
          f"{sum(r['rows_differ'] for r in rows)} rows differ from plain, all near-ties; a "
          f"no-grad forward {forward_ms['fast']:.3f} ms against {forward_ms['exact']:.3f} exact")
    return out


def fast_forward(model, points: torch.Tensor):
    with torch.no_grad():
        return model(points)


def phase_resgcn_reference(dev) -> dict:
    """28. Card vs CPU, full-width ResGCN-28 with seeded weights on the
    first 2048 points of one block (two 4096-point blocks until the
    part-seg phases came, one until the script's wall neared its limit; the
    CPU's float64 run of the 24 large-k graphs is most of the phase): every block's
    graph built on the CPU from the card's input
    features equal to the card's, except in near-tie rows. On the card's
    graphs (``graphs=``), the logits and the colour gradient (of the
    summed log-probability of random labels) of the card, of the CPU in
    float32 and of the CPU in float64: the card no further from float64
    than twice the CPU's float32 (plus 1e-6 of the largest logit, 1e-5
    in relative L2), and card vs CPU logits within 4e-4 of the largest
    magnitude: about 4 times the 1.021e-4 that three runs on an H100 80GB
    HBM3 read (PERF.md). Twenty-eight residual blocks of float32 sums put
    the two float32 results that far apart: channels whose calibrated
    variance is near 0 scale rounding by up to 1/sqrt(ε) = 316 on both
    devices alike, so each is also judged by its distance from float64
    (the rule of the 3-NN weights' gradient phase)."""
    from pointsecguard_tpu_torch import ops

    blocks = train_blocks(dev, 8)
    sd = resgcn_state_dict(1, blocks)
    pts = blocks[[0], :RESGCN_REFERENCE_POINTS].contiguous()
    model = resgcn_model(sd, dev)
    inputs, graphs = block_inputs(model, pts)
    differ, bad, total = 0, 0, 0
    feats = [pts[..., :3]] + [inputs[i] for i in range(len(model.backbone))]
    for i, (x, g) in enumerate(zip(feats, graphs)):
        dilation = max(i, 1)  # the head and DynConv_0 take 1, DynConv_i 1 + i
        K = model.k * dilation
        want = ops.dilate_neighbors(ops.dense_knn_graph(x.cpu(), K), dilation)
        d, b = near_tie_check(x.cpu(), g.cpu(), want)
        differ, bad, total = differ + d, bad + b, total + g.shape[0] * g.shape[1]
    labels = torch.randint(0, 13, pts.shape[:2], generator=torch.Generator().manual_seed(5))
    out = {}
    cpu = torch.device("cpu")
    for name, device, dtype in (("card", dev, torch.float32), ("cpu", cpu, torch.float32),
                                ("float64", cpu, torch.float64)):
        m = model.to(device=device, dtype=dtype)
        p = pts.to(device=device, dtype=dtype).clone().requires_grad_(True)
        logits = m(p, graphs=tuple(g.to(device) for g in graphs))
        lp = torch.log_softmax(logits, -1)
        torch.gather(lp, -1, labels.to(device)[..., None]).sum().backward()
        out[name] = (logits.detach().double().cpu(), p.grad[..., 3:6].double().cpu())
    ref_logits, ref_grad = out["float64"]
    scale = ref_logits.abs().max().item()
    err = {n: (out[n][0] - ref_logits).abs().max().item() for n in ("card", "cpu")}
    grad_err = {n: _rel_l2(out[n][1], ref_grad) for n in ("card", "cpu")}
    card_cpu = (out["card"][0] - out["cpu"][0]).abs().max().item()
    res = {"graph_rows": total, "rows_differ": differ, "rows_not_near_tie": bad,
           "fraction_equal": 1 - differ / total, "largest_logit": scale,
           "logits_card_vs_cpu_over_largest": card_cpu / scale,
           "logits_vs_float64_over_largest": {n: e / scale for n, e in err.items()},
           "colour_grad_card_vs_cpu_rel_l2": _rel_l2(out["card"][1], out["cpu"][1]),
           "colour_grad_vs_float64_rel_l2": grad_err}
    print("resgcn card vs CPU: " + json.dumps(res))
    ok = (not bad and torch.isfinite(out["card"][0]).all()
          and err["card"] <= 2 * err["cpu"] + 1e-6 * scale and card_cpu <= 4e-4 * scale
          and grad_err["card"] <= 2 * grad_err["cpu"] + 1e-5)
    if not ok:
        raise AssertionError("the card's ResGCN disagrees with the CPU's")
    return res


def phase_resgcn_nb(dev, records, data: str) -> dict:
    """29. NB through ``cli.attack.main --model resgcn`` on a random-weight
    checkpoint (BatchNorm statistics from one forward over 8 blocks),
    ``RESGCN_BLOCKS`` blocks of the Area-5 room in one batch, the
    preset's 50 iterations: exactly 4 kNN
    launches per forward the CLI runs (the clean forward, one per
    iteration, PGD's last and the adversarial prediction's), finite
    output, adversarial accuracy below clean; ms/block, peak memory."""
    from pointsecguard_tpu_torch.cli import attack
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    blocks, _ = resgcn_room_batch(data, RESGCN_BATCH, dev, seed=3)
    log = os.path.join(WORK, "resgcn_log")
    save_checkpoint(log, resgcn_state_dict(0, blocks))
    argv = ["--model", "resgcn", "--attack", "nb", "--data_root", data, "--log_dir", log,
            "--num_point", str(NUM_POINT), "--batch_size", str(RESGCN_BLOCKS),
            "--max_blocks", str(RESGCN_BLOCKS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = attack.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rows = read_tsv(os.path.join(log, "resgcn_nb_area5.tsv"))
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s", "steps")}
    S = int(col["steps"].max())
    stats = {"blocks": len(rows), "nb_iters": S,
             "ms_per_block": float(1e3 * col["time_s"].mean()), "main_wall_s": wall,
             "clean_acc": float(col["clean_acc"].mean()),
             "adv_acc": float(col["adv_acc"].mean()), "l2_mean": float(col["l2"].mean()),
             "clean_miou": clean_m.miou, "adv_miou": adv_m.miou,
             "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": counts}
    print("resgcn nb: " + json.dumps(stats))
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if len(rows) != RESGCN_BLOCKS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"resgcn NB: {len(rows)} rows or a non-finite value")
    if S != 50 or counts["knn"] != 4 * (S + 3):
        raise AssertionError(f"resgcn NB launches {counts} over {S} iterations, want knn "
                             f"4 × ({S} + 3)")
    if any(counts[k] for k in counts if k != "knn"):
        raise AssertionError(f"a kernel off the ResGCN NB path launched: {counts}")
    if not stats["adv_acc"] < stats["clean_acc"]:
        raise AssertionError("the ResGCN NB attack did not lower the mean accuracy")
    records["knn"]["launches_by_path"]["resgcn nb"] = counts["knn"]
    records["knn"]["calls_per_batch"]["resgcn nb"] = f"{counts['knn']} over {S + 3} forwards"
    return stats


def phase_resgcn_nu(dev, records, data: str) -> dict:
    """30. NU through the C&W engine on one batch of 8 blocks with the
    random-weight checkpoint of phase 29, the preset with its steps cut to
    ``RESGCN_NU_STEPS``: one ``bottom_k`` launch a step for the smooth term
    and 4 kNN launches a forward."""
    from pointsecguard_tpu_torch.attacks import attack_preset, cw_color_attack
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    model = resgcn_model(load_checkpoint(os.path.join(WORK, "resgcn_log")), dev)
    model.requires_grad_(False)
    pts, labels = resgcn_room_batch(data, RESGCN_BATCH, dev)
    cfg = attack_preset("resgcn", "nu", steps=RESGCN_NU_STEPS)
    forwards = [0]

    def outputs_fn(p):
        forwards[0] += 1
        return model(p)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = cw_color_attack(outputs_fn, pts, labels, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    S = int(res.steps)
    stats = {"steps": S, "forwards": forwards[0], "ms_per_step": 1e3 * wall / max(S, 1),
             "l2_mean": res.l2_dist.mean().item(), "acc": res.acc.item(), "launches": counts}
    print("resgcn nu: " + json.dumps(stats))
    if not (1 <= S <= RESGCN_NU_STEPS and torch.isfinite(res.points_adv).all()):
        raise AssertionError(f"resgcn NU: {S} steps or a non-finite output")
    if counts["bottom_k"] != S or counts["knn"] != 4 * forwards[0]:
        raise AssertionError(f"resgcn NU launches {counts}, want bottom_k {S} and knn "
                             f"4 × {forwards[0]}")
    records["bottom_k"]["calls_per_batch"]["resgcn nu"] = f"{counts['bottom_k']} over {S} steps"
    records["knn"]["calls_per_batch"]["resgcn nu"] = f"{counts['knn']} over {S} steps"
    return stats


def phase_resgcn_train_step(dev) -> dict:
    """31. One optimizer step of the full-width ResGCN-28 from the same
    weights (flax-style initialisation) and two blocks with random labels,
    on the card and on the CPU, both on the graphs of the card's
    train-mode forward. Tolerances as in ``phase_train_step``: loss 1e-4
    relative; the gradient and Adam's first moment 2e-2 in relative L2 and
    the second moment 4e-2; BatchNorm statistics 1e-3 of the largest; the parameters' move within
    1e-5 where |g| is clear of rounding noise (above a fifth of its
    tensor's largest entry)."""
    from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters
    from pointsecguard_tpu_torch.models.resgcn import ce_loss
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, resgcn_family

    pts = train_blocks(dev, 8)[[1, 6]].contiguous()
    labels = torch.randint(0, 13, pts.shape[:2], generator=torch.Generator().manual_seed(13))
    out, graphs = {}, None
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = DenseDeepGCN()
        init_parameters(model, torch.Generator().manual_seed(3), scale=2.0)
        state = TrainState(model.to(device))
        if graphs is None:  # the card's train-mode graphs; statistics restored
            stats0 = state.stats.clone()
            with torch.no_grad():
                _, graphs = model.train()(pts, collect_graphs=True)
            state.stats.copy_(stats0)
        before = state.params.clone()
        step = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family())
        t0 = time.perf_counter()
        loss = step(state, pts.to(device), labels.to(device), None, 1e-3, None,
                    geometry=tuple(g.to(device) for g in graphs))
        named = [(k, p.numel()) for k, p in model.named_parameters()]
        out[name] = {"loss": loss.item(), "grads": state.grads.cpu(), "mu": state.mu.cpu(),
                     "nu": state.nu.cpu(), "move": (state.params - before).cpu(),
                     "stats": state.stats.cpu(), "seconds": time.perf_counter() - t0}
    card, cpu = out["card"], out["cpu"]
    # BasicConv puts the activation between its Linear and its BatchNorm,
    # so no bias has a gradient of 0 by construction: every entry counts
    clear = torch.cat([g.abs() > 0.2 * g.abs().max()
                       for g in cpu["grads"].split([n for _, n in named])])
    res = {
        "points": list(pts.shape[:2]),
        "loss_card": card["loss"], "loss_cpu": cpu["loss"],
        "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        "grad_rel_l2": _rel_l2(card["grads"], cpu["grads"]),
        "mu_rel_l2": _rel_l2(card["mu"], cpu["mu"]),
        "nu_rel_l2": _rel_l2(card["nu"], cpu["nu"]),
        "move_max_abs_where_clear": (card["move"] - cpu["move"])[clear].abs().max().item(),
        "clear_entries": int(clear.sum()),
        "stats_max_abs": (card["stats"] - cpu["stats"]).abs().max().item(),
        "stats_max": cpu["stats"].abs().max().item(), "cpu_step_s": cpu["seconds"],
    }
    print("resgcn train step, card vs CPU: " + json.dumps(res))
    ok = (math.isfinite(card["loss"]) and res["loss_rel"] <= 1e-4
          and res["grad_rel_l2"] <= 2e-2 and res["mu_rel_l2"] <= 2e-2
          and res["nu_rel_l2"] <= 4e-2 and res["move_max_abs_where_clear"] <= 1e-5
          and res["clear_entries"] > 10_000
          and res["stats_max_abs"] <= 1e-3 * res["stats_max"]
          and card["move"].abs().max().item() > 0)
    if not ok:
        raise AssertionError("the card's ResGCN train step disagrees with the CPU's")
    return res


def phase_resgcn_train(dev, records) -> tuple[str, str, dict]:
    """32. Training through ``cli.train.main --model resgcn`` at full width,
    batch 8 × 4096 on one synthetic train room (12–16 steps an epoch),
    ``RESGCN_TRAIN_EPOCHS`` epochs, then a resumed call with one more:
    every loss finite, no skipped batch, the last epoch's loss below the
    first's, exactly 4 kNN launches per optimizer step, no epoch repeated.
    ms per step on the host's clock and by CUDA events, blocks/s, the
    host's share, peak memory. Returns the data root, the log dir and the
    figures."""
    from pointsecguard_tpu_torch.cli import train as cli
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, make_synthetic_rooms
    from pointsecguard_tpu_torch.models import DenseDeepGCN
    from pointsecguard_tpu_torch.models.resgcn import ce_loss
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, resgcn_family
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

    data = os.path.join(WORK, "resgcn_data")
    make_synthetic_rooms(data, points_per_room=ROOM_POINTS, seed=0)
    log = os.path.join(WORK, "resgcn_train_log")
    sampler = S3DISBlockSampler(RoomSet.load(data, "train", 5), num_point=NUM_POINT)
    steps_per_epoch = -(-len(sampler) // RESGCN_BATCH)
    if not 12 <= steps_per_epoch <= 16:
        raise AssertionError(f"{steps_per_epoch} steps an epoch, want 12-16")

    def argv(epochs):
        return ["--model", "resgcn", "--data_root", data, "--log_dir", log,
                "--npoint", str(NUM_POINT), "--batch_size", str(RESGCN_BATCH),
                "--epochs", str(epochs)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(argv(RESGCN_TRAIN_EPOCHS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    epochs = [e for e in read_events(log) if e["event"] == "epoch"]
    if [e["epoch"] for e in epochs] != list(range(RESGCN_TRAIN_EPOCHS)):
        raise AssertionError(f"epoch lines {[e['epoch'] for e in epochs]}")
    if any(e["batches"] != steps_per_epoch or e["nan_batches"] for e in epochs):
        raise AssertionError(f"steps or skipped batches: {epochs}")
    if not all(math.isfinite(e["loss"]) for e in epochs):
        raise AssertionError("a non-finite epoch loss")
    if not epochs[-1]["loss"] < epochs[0]["loss"]:
        raise AssertionError("the last epoch's mean loss is not below the first's")
    steps = steps_per_epoch * RESGCN_TRAIN_EPOCHS
    if counts["knn"] != 4 * steps or any(counts[k] for k in counts if k != "knn"):
        raise AssertionError(f"resgcn train launches {counts}, want knn 4 × {steps} steps")
    records["knn"]["launches_by_path"]["resgcn train"] = counts["knn"]
    records["knn"]["calls_per_batch"]["resgcn train step"] = 4

    cli.main(argv(RESGCN_TRAIN_EPOCHS + 1))
    events = [e for e in read_events(log) if e["event"] == "epoch"]
    if [e["epoch"] for e in events] != list(range(RESGCN_TRAIN_EPOCHS + 1)):
        raise AssertionError(f"epochs after the resumed call: {[e['epoch'] for e in events]}")
    ckpt = CheckpointManager(os.path.join(log, "checkpoints"))
    latest = ckpt.restore_latest()
    if (latest["epoch"] != RESGCN_TRAIN_EPOCHS + 1 or latest["step"] != steps + steps_per_epoch
            or ckpt.restore_best() is not None):
        raise AssertionError(f"resumed checkpoint: epoch {latest['epoch']}, step "
                             f"{latest['step']}, or a best.pt was written")

    # the step alone on the card: CUDA events around each of 5 steps
    model = DenseDeepGCN()
    state = TrainState(model.to(dev))
    state.load_payload(latest)
    step = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family())
    rng = np.random.default_rng(1)
    pts, labels = next(iter(sampler.batches(rng, RESGCN_BATCH)))
    pts, labels = torch.from_numpy(pts).to(dev), torch.from_numpy(labels).long().to(dev)
    step_ms = cuda_ms(lambda: step(state, pts, labels, None, 1e-5, None), reps=5)
    t0 = time.perf_counter()
    for _ in sampler.batches(rng, RESGCN_BATCH):
        pass
    sampler_ms = 1e3 * (time.perf_counter() - t0) / steps_per_epoch
    warm = events[1:]  # the first epoch pays the one-off CUDA set-up
    host_ms = 1e3 * sum(e["seconds"] for e in warm) / sum(e["batches"] for e in warm)
    stats = {
        "sampler_blocks": len(sampler), "steps_per_epoch": steps_per_epoch,
        "steps": steps + steps_per_epoch, "epoch_loss": [e["loss"] for e in events],
        "ms_per_step_host_clock": host_ms,
        "ms_per_step_host_clock_by_epoch": [1e3 * e["seconds"] / e["batches"] for e in events],
        "ms_per_step_cuda_events": step_ms, "blocks_per_s": 1e3 * RESGCN_BATCH / host_ms,
        "host_share": 1.0 - step_ms / host_ms, "sampler_ms_per_batch_alone": sampler_ms,
        "peak_device_memory_gb": peak / 1e9, "main_wall_s": wall, "launches": counts,
    }
    print("resgcn train: " + json.dumps(stats))
    return data, log, stats


def phase_resgcn_eval(data: str, log: str, records) -> dict:
    """33. ``cli.eval.main --model resgcn --num_votes 1`` on that
    checkpoint at the default batch of 16: accuracy on the Area-5 room at
    or above ``RESGCN_EVAL_ACC_FLOOR``, 4 kNN launches a batch."""
    from pointsecguard_tpu_torch.cli import eval as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    n_blocks = room_block_count(data)
    batches = -(-n_blocks // 16)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    total = cli.main(["--model", "resgcn", "--data_root", data, "--log_dir", log,
                      "--num_point", str(NUM_POINT), "--num_votes", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    stats = {"accuracy": total.accuracy, "miou": total.miou, "blocks": n_blocks,
             "ms_per_block": 1e3 * wall / n_blocks, "launches": counts}
    print(f"resgcn eval: {json.dumps(stats)} (floor {RESGCN_EVAL_ACC_FLOOR}, chance 1/13 = "
          f"{1 / 13:.4f})")
    if not (math.isfinite(total.miou) and total.accuracy >= RESGCN_EVAL_ACC_FLOOR >= 2 / 13):
        raise AssertionError(f"resgcn eval accuracy {total.accuracy} under the floor "
                             f"{RESGCN_EVAL_ACC_FLOOR}")
    if counts["knn"] != 4 * batches:
        raise AssertionError(f"resgcn eval launches {counts}, want knn 4 × {batches} batches")
    records["knn"]["launches_by_path"]["resgcn eval"] = counts["knn"]
    records["knn"]["calls_per_batch"]["resgcn eval batch"] = 4
    return stats


def phase_resgcn_attack_trained(data: str, log: str) -> dict:
    """34. On the trained checkpoint: ``--attack nb --save_adv`` on 8
    blocks at batch 8 (adversarial accuracy below clean), ``cli.eval
    --adv_set`` gives it back to 1e-3; ``--attack tar_nb`` (board →
    table) at batch 1 on up to 2 blocks of the room: the per-cloud gates
    both attack and skip clouds."""
    import logging

    from pointsecguard_tpu_torch.cli import attack, eval as cli_eval

    base = ["--model", "resgcn", "--data_root", data, "--log_dir", log,
            "--num_point", str(NUM_POINT)]
    clean_m, adv_m = attack.main(base + ["--attack", "nb", "--save_adv", "--batch_size",
                                         str(RESGCN_BLOCKS), "--max_blocks", str(RESGCN_BLOCKS)])
    rows = read_tsv(os.path.join(log, "resgcn_nb_area5.tsv"))
    clean = float(np.mean([float(r["clean_acc"]) for r in rows]))
    adv = float(np.mean([float(r["adv_acc"]) for r in rows]))
    m = cli_eval.main(["--model", "resgcn", "--log_dir", log, "--adv_set",
                       os.path.join(log, "resgcn_nb_adv_area5.npz"),
                       "--batch_size", str(RESGCN_BATCH)])

    class Gates(logging.Handler):
        lines: list = []

        def emit(self, record):
            if record.getMessage().startswith("resgcn gates"):
                self.lines.append(record.getMessage())

    handler = Gates()
    logging.getLogger("attack").addHandler(handler)
    try:
        attack.main(base + ["--attack", "tar_nb", "--max_blocks", str(RESGCN_TAR_BLOCKS)])
    finally:
        logging.getLogger("attack").removeHandler(handler)
    tar_rows = read_tsv(os.path.join(log, "resgcn_tar_nb_area5.tsv"))
    found = re.search(r"(\d+) clouds attacked, (\d+) skipped .*, (\d+) with",
                      handler.lines[-1] if handler.lines else "")
    gates = [int(g) for g in found.groups()] if found else []
    stats = {"blocks": len(rows), "clean_acc": clean, "adv_acc": adv,
             "l2_mean": float(np.mean([float(r["l2"]) for r in rows])),
             "ms_per_block": float(np.mean([1e3 * float(r["time_s"]) for r in rows])),
             "clean_miou": clean_m.miou, "adv_miou": adv_m.miou,
             "adv_set_accuracy": m.accuracy, "tar_nb_gates": handler.lines,
             "tar_nb_rows": [{k: r[k] for k in ("block", "clean_acc", "adv_acc", "sr",
                                                "steps")} for r in tar_rows]}
    print("resgcn attack on the trained checkpoint: " + json.dumps(stats))
    if len(rows) != RESGCN_BLOCKS or not adv < clean:
        raise AssertionError("NB did not lower the trained ResGCN's accuracy")
    if abs(m.accuracy - adv) > 1e-3:
        raise AssertionError(f"--adv_set accuracy {m.accuracy} != the attack run's {adv}")
    # gates: [attacked, skipped for origin points, skipped for accuracy]
    if len(gates) != 3 or not (1 <= gates[0] == len(tar_rows) <= RESGCN_TAR_BLOCKS
                               and gates[1] + gates[2] >= 1):
        raise AssertionError(f"tar_nb gates {handler.lines}: want clouds both attacked and "
                             "skipped")
    return stats


def phase_resgcn_fast(dev, records, data: str, log: str, exact: dict) -> dict:
    """80. ``--resgcn_fast`` through the CLIs on the trained ResGCN-28
    (phase 32's checkpoint, in a log of its own): ``cli.attack --attack nb``
    on ``RESGCN_BLOCKS`` blocks in one batch, 28 kNN launches a forward (the clean forward,
    the 50 iterations, PGD's last and the adversarial prediction) and no
    other kernel, adversarial accuracy below clean, ms a block and per NB
    iteration beside phase 34's exact run (``exact``); ``cli.eval
    --num_votes 1``, 28 kNN launches a batch, accuracy beside phase 33's.
    Then one block's forward card against CPU: every graph the CPU builds
    from the card's block inputs equal to the card's but in near-tie rows,
    and the logits on the card's graphs within 4e-4 of the largest (phase
    28's bound)."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.cli import attack, eval as cli_eval
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    fast_log = os.path.join(WORK, "resgcn_fast_log")
    shutil.rmtree(fast_log, ignore_errors=True)
    shutil.copytree(os.path.join(log, "checkpoints"), os.path.join(fast_log, "checkpoints"))
    base = ["--model", "resgcn", "--resgcn_fast", "--data_root", data, "--log_dir", fast_log,
            "--num_point", str(NUM_POINT)]
    kernels.reset_launch_counts()
    clean_m, adv_m = attack.main(base + ["--attack", "nb", "--batch_size", str(RESGCN_BLOCKS),
                                         "--max_blocks", str(RESGCN_BLOCKS)])
    torch.cuda.synchronize()
    nb_counts = kernels.launch_counts()
    rows = read_tsv(os.path.join(fast_log, "resgcn_nb_area5.tsv"))
    S = max(int(r["steps"]) for r in rows)
    ms_block = float(np.mean([1e3 * float(r["time_s"]) for r in rows]))
    clean = float(np.mean([float(r["clean_acc"]) for r in rows]))
    adv = float(np.mean([float(r["adv_acc"]) for r in rows]))
    if len(rows) != RESGCN_BLOCKS or not all(math.isfinite(v) for v in (clean, adv, ms_block)) \
            or not adv < clean:
        raise AssertionError(f"resgcn --resgcn_fast nb: {len(rows)} rows, clean {clean}, "
                             f"adv {adv}")
    if nb_counts["knn"] != RESGCN_FAST_LAUNCHES * (S + 3) or \
            any(v for k, v in nb_counts.items() if k != "knn"):
        raise AssertionError(f"resgcn --resgcn_fast nb launches {nb_counts} over {S} "
                             f"iterations, want knn {RESGCN_FAST_LAUNCHES} × ({S} + 3)")
    n_blocks = room_block_count(data)
    kernels.reset_launch_counts()
    m = cli_eval.main(base + ["--num_votes", "1"])
    torch.cuda.synchronize()
    eval_counts = kernels.launch_counts()
    if not math.isfinite(m.miou) or eval_counts["knn"] != RESGCN_FAST_LAUNCHES * -(-n_blocks // 16):
        raise AssertionError(f"resgcn --resgcn_fast eval: {m}, launches {eval_counts}")
    _record_path(records, "knn", "resgcn nb --resgcn_fast", nb_counts["knn"],
                 "resgcn --resgcn_fast forward", RESGCN_FAST_LAUNCHES)
    _record_path(records, "knn", "resgcn eval --resgcn_fast", eval_counts["knn"])

    # one block, card against CPU
    pts, _ = resgcn_room_batch(data, 1, dev)
    sd = load_checkpoint(fast_log)
    card = resgcn_fast_model(sd, dev)
    cpu = resgcn_fast_model(sd, torch.device("cpu"))
    inputs, graphs = block_inputs(card, pts)
    want = [ops.dense_knn_graph(pts[..., :3].cpu(), card.k)] + [
        cpu.backbone[i](inputs[i].cpu())[1] for i in range(len(card.backbone))]
    feats = [pts[..., :3]] + [inputs[i] for i in range(len(card.backbone))]
    differ = bad = 0
    for x, g, w in zip(feats, graphs, want):
        d, b = near_tie_check(x.cpu(), g.cpu(), w)
        differ, bad = differ + d, bad + b
    with torch.no_grad():
        on_card = card(pts, graphs=graphs).cpu()
        on_cpu = cpu(pts.cpu(), graphs=tuple(g.cpu() for g in graphs))
    scale = on_cpu.abs().max().item()
    logits_err = (on_card - on_cpu).abs().max().item() / scale
    ms_iter = {"fast": ms_block * RESGCN_BLOCKS / S,
               "exact": exact["ms_per_block"] * RESGCN_BLOCKS / S}
    stats = {"nb": {"blocks": len(rows), "iters": S, "clean_acc": clean, "adv_acc": adv,
                    "ms_per_block": ms_block, "ms_per_block_exact": exact["ms_per_block"],
                    "ms_per_nb_iteration": ms_iter, "launches": nb_counts,
                    "clean_miou": clean_m.miou, "adv_miou": adv_m.miou},
             "eval": {"accuracy": m.accuracy, "miou": m.miou, "launches": eval_counts},
             "card_vs_cpu": {"graph_rows": sum(g.shape[1] for g in graphs),
                             "rows_differ": differ, "rows_not_near_tie": bad,
                             "logits_over_largest": logits_err}}
    print("resgcn --resgcn_fast on the trained checkpoint: " + json.dumps(stats))
    print(f"resgcn NB ms per iteration (batch {RESGCN_BLOCKS}, fwd + bwd): --resgcn_fast "
          f"{ms_iter['fast']:.2f} against exact {ms_iter['exact']:.2f}")
    if bad or not logits_err <= 4e-4 or not torch.isfinite(on_card).all():
        raise AssertionError("the card's --resgcn_fast ResGCN disagrees with the CPU's")
    return stats


def room_block_count(data: str) -> int:
    """The Area-5 room's count of 4096-point blocks (cli.eval's)."""
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks

    return WholeSceneBlocks(RoomSet.load(data, "test", 5), block_points=NUM_POINT
                            ).room_blocks(0, np.random.default_rng(0))[0].shape[0]


# --- the attack CLIs' protocol flags (phases 42-46) -----------------------

# batches of 8 blocks a protocol run (2 until the script's wall neared its
# limit, the second timed warm; the SSG is warm from phases 17-19 by then)
PROTOCOL_BATCHES = 1
STEPS_FLAGS = ["--attack", "nb", "--control", "--log_steps"]  # phase 43's, again in 81
STEPS_TSV = os.path.join(WORK, "one_process_steps.tsv")  # its _steps.tsv, for phase 81
RESAMPLE_K = 8  # --defense_knn's default: the resample defense's self-kNN


def phase_resample_knn(dev, records, xyz) -> dict:
    """42. The D = 3 kNN kernel at the shapes of ``--defense resample``:
    the self-kNN over xyz of a batch of 8 × 4096-point blocks and of a
    RandLA batch of 4 × 40960-point clouds, k = 8. Values and indices equal
    to the plain version (and ``resample_neighbors``'s indices to the
    kernel's); card, eager and plain ms, bound and share (a kernel phase)."""
    from pointsecguard_tpu_torch.attacks.defenses import resample_neighbors
    from pointsecguard_tpu_torch.ops.cuda import bounds, knn

    shapes = {f"blocks [{BATCH}, {NUM_POINT}, 3] k={RESAMPLE_K}":
              slice_blocks(dev)[..., :3].contiguous(),
              f"randla [{RANDLA_BATCH}, {RANDLA_POINTS}, 3] k={RESAMPLE_K}": xyz}
    out = {}
    for what, x in shapes.items():
        err = _equal(f"knn resample {what}", knn.knn(x, x, RESAMPLE_K),
                     knn.knn_plain(x, x, RESAMPLE_K))
        if not torch.equal(resample_neighbors(x, RESAMPLE_K), knn.knn(x, x, RESAMPLE_K)[1]):
            raise AssertionError(f"resample_neighbors {what} != the kernel's indices")
        ms = device_ms(lambda: knn.knn(x, x, RESAMPLE_K), reps=10)
        eager = cuda_ms(lambda: knn.knn(x, x, RESAMPLE_K), reps=10)
        plain = cuda_ms(lambda: knn.knn_plain(x, x, RESAMPLE_K), reps=3, warmup=1)
        work = bounds.knn(x.shape[0], x.shape[1], x.shape[1], 3, RESAMPLE_K)
        out[what] = {"ms": ms, "eager_ms": eager, "plain_ms": plain,
                     "bound_ms": work.bound_ms, "bound_by": work.bound_by,
                     "share": work.bound_ms / ms, "max_abs_err": err}
        print(f"knn resample {what}: values and indices equal; kernel {ms:.4f} ms on the card "
              f"({eager:.4f} ms eager), plain {plain:.4f} ms, bound {work.bound_ms:.4f} ms "
              f"({work.bound_by}; share {work.bound_ms / ms:.3f})")
    records["knn"]["resample"] = out
    return out


def _protocol_run(data: str, log: str, flags: list, model: str = "pointnet2") -> dict:
    """``PROTOCOL_BATCHES`` batches of 8 blocks through ``cli.attack.main``
    with ``flags``, the launch counts set to 0 just before and read just
    after: the counts, ms a block of the last (warm) batch and the run's
    wall; accuracies and L2 over every block."""
    from pointsecguard_tpu_torch.cli import attack
    from pointsecguard_tpu_torch.ops import cuda as kernels

    argv = ["--model", model, "--data_root", data, "--log_dir", log,
            "--num_point", str(NUM_POINT), "--batch_size", str(BATCH),
            "--max_blocks", str(PROTOCOL_BATCHES * BATCH), *flags]
    name = flags[flags.index("--attack") + 1] if "--attack" in flags else "nb"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    attack.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rows = read_tsv(os.path.join(log, f"{model}_{name}_area5.tsv"))
    if len(rows) != PROTOCOL_BATCHES * BATCH:
        raise AssertionError(f"{flags}: {len(rows)} TSV rows, want {PROTOCOL_BATCHES * BATCH}")
    col = {c: np.array([float(r[c]) for r in rows]) for c in rows[0] if c != "room"}
    if not all(np.isfinite(v).all() for v in col.values()):
        raise AssertionError(f"{flags}: a non-finite value in the TSV")
    stats = {"flags": " ".join(flags),
             "ms_per_block": float(1e3 * col["time_s"][-BATCH:].mean()),
             "ms_per_block_first_batch": float(1e3 * col["time_s"][:BATCH].mean()),
             "main_wall_s": wall, "clean_acc": float(col["clean_acc"].mean()),
             "adv_acc": float(col["adv_acc"].mean()), "l2_mean": float(col["l2"].mean()),
             "steps": int(col["steps"].max()), "launches": counts}
    if "rand_acc" in col:
        stats["rand_acc"] = float(col["rand_acc"].mean())
    return stats


def phase_protocol_blocks(data: str, log: str, records) -> list[dict]:
    """43. The protocol flags on the trained full-width SSG (phase 17's
    checkpoint), ``PROTOCOL_BATCHES`` batches of 8 × 4096 blocks each (ms a
    block of the last), through ``cli.attack.main``: NB without flags (the yardstick), NB ``--control
    --log_steps`` (the attack must beat its equal-norm control, as
    ``tools/run_demo.py``'s verdict requires), NB ``--control --log_steps
    --defense resample --eot 2 --visual`` (exactly 2 + 2 × 11 + 1 = 25 kNN
    launches a batch: the clean, adversarial and control forwards of the
    deployed defense, and two EoT draws for each of the 10 attack forwards
    and PGD's last; 10 steps rows a batch; the room's visual files), ``--defense bit_depth``,
    ``jitter`` and ``jpeg`` (no kNN), and ``--attack random``."""
    runs = []
    for flags in (["--attack", "nb"],
                  STEPS_FLAGS,
                  ["--attack", "nb", "--control", "--log_steps", "--defense", "resample",
                   "--eot", "2", "--visual"],
                  ["--attack", "nb", "--defense", "bit_depth"],
                  ["--attack", "nb", "--defense", "jitter"],
                  ["--attack", "nb", "--defense", "jpeg"],
                  ["--attack", "random", "--noise_norm", "1.0"]):
        stats = _protocol_run(data, log, flags)
        counts, n = stats["launches"], PROTOCOL_BATCHES
        resample = "resample" in flags
        want_knn = n * (2 + 2 * (stats["steps"] + 1) + 1) if resample else 0
        if (counts["fps"], counts["bottom_k"], counts["knn"]) != (4 * n, 8 * n, want_knn):
            raise AssertionError(f"{flags}: launches {counts}, want fps {4 * n}, bottom_k "
                                 f"{8 * n}, knn {want_knn}")
        if "--log_steps" in flags:
            steps = read_tsv(os.path.join(log, "pointnet2_nb_area5_steps.tsv"))
            if len(steps) != 10 * n or stats["steps"] != 10:
                raise AssertionError(f"{flags}: {len(steps)} steps rows, want {10 * n}")
            stats["steps_rows"] = len(steps)
            if flags == STEPS_FLAGS:  # phase 81's one-process run
                shutil.copy(os.path.join(log, "pointnet2_nb_area5_steps.tsv"), STEPS_TSV)
        if "--visual" in flags:
            vis = sorted(os.listdir(os.path.join(log, "visual")))
            if len(vis) != 6:
                raise AssertionError(f"--visual wrote {vis}, want 6 files for the room")
            stats["visual_files"] = vis
            stats["visual_host_s"] = stats["main_wall_s"] - 1e-3 * BATCH * (
                stats["ms_per_block"] + stats["ms_per_block_first_batch"])
        if "random" in flags and stats["l2_mean"] != 1.0:
            raise AssertionError(f"--attack random: l2 {stats['l2_mean']}, want 1.0")
        print("protocol blocks: " + json.dumps(stats))
        runs.append(stats)
    control = runs[1]
    if not control["adv_acc"] < control["rand_acc"]:
        raise AssertionError(f"NB adv acc {control['adv_acc']} does not beat its equal-norm "
                             f"control {control['rand_acc']}")
    records["knn"]["launches_by_path"]["pointnet2 nb --defense resample"] = \
        runs[2]["launches"]["knn"]
    records["knn"]["calls_per_batch"]["pointnet2 nb --defense resample --eot 2"] = \
        runs[2]["launches"]["knn"] / PROTOCOL_BATCHES
    print("protocol blocks ms/block: " + json.dumps(
        {r["flags"]: round(r["ms_per_block"], 3) for r in runs}))
    return runs


def _near_half_boundary(color: torch.Tensor, quality: int, block: int = 64) -> torch.Tensor:
    """[B, N, 3] bool: the points of every (block, channel) of the JPEG
    defense with a DCT coefficient whose coeffs / step lies within 1e-5 of
    a .5 boundary, in float64 (tests/test_torch_defenses.py's rule: there
    two float32 einsums may round to different steps)."""
    x = color.double().cpu()
    B, N, C = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, (-N) % block)).reshape(B, -1, block, C)
    k = torch.arange(block, dtype=torch.float64)
    D = torch.cos(math.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * block)) * math.sqrt(2 / block)
    D[0] /= math.sqrt(2.0)
    scale = (5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality) / 100.0
    step = torch.clamp((16.0 + 4.0 * k) * scale / 255.0 * math.sqrt(block / 2.0), min=1e-6)
    ratio = torch.einsum("fk,bnkc->bnfc", D, x) / step[None, None, :, None]
    near = ((ratio - torch.floor(ratio) - 0.5).abs() < 1e-5).any(dim=2)
    return near.repeat_interleave(block, dim=1)[:, :N]


def phase_defense_reference(dev) -> dict:
    """44. The defenses card vs CPU on two blocks of 4096 points: bit depth
    and resample (the same CPU-drawn pick; the kNN kernel against its plain
    version) equal exactly, jitter (the same draw) exactly, JPEG at quality
    95 and 10 within 1e-6 outside the rounding-boundary rule of the tests;
    then one NB run with its trajectory on both devices, the calibrated
    full-width SSG in float64 on the card's geometry: per-step accuracy,
    success rate and L2 within 1e-4."""
    from pointsecguard_tpu_torch import attacks
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS

    pts = slice_blocks(dev)[[0, 4]].contiguous()
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    choice = torch.randint(0, RESAMPLE_K, (2, NUM_POINT, 1), generator=gen)
    noise = torch.randn((2, NUM_POINT, 3), generator=gen)
    res = {}
    for name, fn in (
        ("bit_depth", lambda p: attacks.bit_depth_reduction(p, 4)),
        ("resample", lambda p: attacks.random_color_resample(p, RESAMPLE_K, choice=choice)),
        ("jitter", lambda p: attacks.random_color_jitter(p, 0.02, noise=noise)),
    ):
        card, host = fn(pts).cpu(), fn(pts.cpu())
        if not torch.equal(card, host):
            raise AssertionError(f"{name}: the card's defended output != the CPU's")
        res[name] = "equal"
    for q in (95, 10):
        card, host = attacks.jpeg_color_compression(pts, q).cpu(), \
            attacks.jpeg_color_compression(pts.cpu(), q)
        near = _near_half_boundary(pts[..., 3:6], q)
        diff = (card - host)[..., 3:6].abs()
        outside = diff[~near].max().item()
        res[f"jpeg q{q}"] = {"max_abs_outside": outside, "max_abs": diff.max().item(),
                             "exempt_points": int(near.any(-1).sum())}
        if outside > 1e-6:
            raise AssertionError(f"jpeg q{q}: card vs CPU {outside} outside the boundary rule")
    model_cls, family = POINTNET_MODELS["pointnet2"]
    net = model_cls()
    net.load_state_dict(calibrated_state_dict(1, dev, "pointnet2"))
    net.eval().requires_grad_(False)
    geo = family.plan(pts)
    labels = torch.randint(0, 13, pts.shape[:2], generator=torch.Generator().manual_seed(5))
    cfg = attacks.attack_preset("pointnet2", "nb")
    traj = {}
    for name, device in (("card", dev), ("cpu", cpu)):
        m = net.to(device=device, dtype=torch.float64)
        g = _to_device(geo, device, torch.float64)
        _, t = attacks.pgd_color_attack(
            lambda p: family.head(family.apply(m, p, g)), pts.to(device, torch.float64),
            labels.to(device), cfg, trajectory=True)
        traj[name] = {k: v.double().cpu() for k, v in t.items()}
    err = {k: (traj["card"][k] - traj["cpu"][k]).abs().max().item() for k in traj["card"]}
    res["nb_trajectory_float64_max_abs"] = err
    res["nb_trajectory_l2_last"] = traj["card"]["l2"][-1].tolist()
    print("defenses card vs CPU: " + json.dumps(res))
    if max(err.values()) > 1e-4:
        raise AssertionError(f"NB trajectory card vs CPU {err}, want within 1e-4")
    return res


def phase_randla_protocol(prep: str, log: str, records) -> dict:
    """45. On the trained RandLA checkpoint (phase 24): NB on one batch of
    4 clouds with ``--defense resample --control --log_steps``: exactly 10
    + 14 kNN launches (the pyramid; the resample defense's self-kNN of the
    clean, adversarial and control forwards, the 10 attack forwards and
    PGD's last), the control's and the steps TSV's rows; then ``cli.eval
    --model randla --visual --save_preds``: the Area-5 cloud's label
    clouds, viewer and prediction PLY at full resolution, which
    ``cli.cv6fold`` scores against the ``original_ply`` to eval's own
    accuracy and mIoU."""
    from pointsecguard_tpu_torch.cli import cv6fold
    from pointsecguard_tpu_torch.cli import eval as cli_eval
    from pointsecguard_tpu_torch.data.ply import read_ply

    stats = run_randla_cli(prep, log, "nb", False, RANDLA_BATCH,
                           extra=("--defense", "resample", "--control", "--log_steps"),
                           knn_per_batch=10 + 14)
    rows = read_tsv(os.path.join(log, "randla_nb_area5.tsv"))
    stats["rand_acc"] = float(np.mean([float(r["rand_acc"]) for r in rows]))
    steps = read_tsv(os.path.join(log, "randla_nb_area5_steps.tsv"))
    if len(steps) != 10 * RANDLA_BATCH:
        raise AssertionError(f"{len(steps)} RandLA steps rows, want {10 * RANDLA_BATCH}")
    records["knn"]["launches_by_path"]["randla nb --defense resample"] = \
        stats["launches"]["knn"]
    records["knn"]["calls_per_batch"]["randla nb --defense resample"] = stats["launches"]["knn"]
    preds = os.path.join(WORK, "randla_preds")
    t0 = time.perf_counter()
    m = cli_eval.main(["--model", "randla", "--randla_dir", prep, "--log_dir", log,
                       "--num_clouds", str(RANDLA_EVAL_CLOUDS), "--batch_size",
                       str(RANDLA_BATCH), "--visual", "--save_preds", preds])
    stats["eval_visual_save_preds_s"] = time.perf_counter() - t0
    stats["eval_accuracy"] = m.accuracy
    plys = sorted(os.listdir(preds))
    cv = cv6fold.main(["--results_dir", preds, "--original_dir",
                       os.path.join(WORK, "original_ply")])
    stats["cv6fold"] = {"accuracy": cv.accuracy, "miou": cv.miou}
    vis = [f for f in os.listdir(os.path.join(log, "visual")) if not f.startswith("cloud")]
    stats.update(save_preds=plys, eval_visual=sorted(vis))
    print("randla protocol: " + json.dumps(stats))
    if not plys or len(vis) != 3 * len(plys):
        raise AssertionError(f"cli.eval --save_preds / --visual wrote {plys}, {vis}")
    n = len(read_ply(os.path.join(preds, plys[0]))["pred"])
    with open(os.path.join(prep, plys[0][: -len(".ply")] + "_proj.pkl"), "rb") as f:
        import pickle

        if n != len(np.asarray(pickle.load(f)[1]).reshape(-1)):
            raise AssertionError("the prediction PLY is not at the cloud's full resolution")
    if abs(cv.accuracy - m.accuracy) > 1e-12 or abs(cv.miou - m.miou) > 1e-12:
        raise AssertionError(f"cv6fold on the saved predictions: {cv.accuracy} / {cv.miou}, "
                             f"eval {m.accuracy} / {m.miou}")
    return stats


def phase_resgcn_fixed(data: str, records, dynamic: dict) -> dict:
    """46. ResGCN NB with ``--resgcn_fixed_graphs`` on phase 29's
    checkpoint and blocks: exactly 12 kNN launches (4 a forward: the graph
    collection on the clean input, the clean and the adversarial forwards
    of the dynamic model; none in the surrogate's 51), ms a block and
    adversarial accuracy beside phase 29's dynamic run."""
    from pointsecguard_tpu_torch.cli import attack
    from pointsecguard_tpu_torch.ops import cuda as kernels

    log = os.path.join(WORK, "resgcn_log")
    argv = ["--model", "resgcn", "--attack", "nb", "--data_root", data, "--log_dir", log,
            "--num_point", str(NUM_POINT), "--batch_size", str(RESGCN_BLOCKS),
            "--max_blocks", str(RESGCN_BLOCKS), "--resgcn_fixed_graphs"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = attack.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rows = read_tsv(os.path.join(log, "resgcn_nb_area5.tsv"))
    stats = {"blocks": len(rows),
             "ms_per_block": float(np.mean([1e3 * float(r["time_s"]) for r in rows])),
             "main_wall_s": wall,
             "clean_acc": float(np.mean([float(r["clean_acc"]) for r in rows])),
             "adv_acc": float(np.mean([float(r["adv_acc"]) for r in rows])),
             "l2_mean": float(np.mean([float(r["l2"]) for r in rows])), "launches": counts,
             "dynamic_ms_per_block": dynamic["ms_per_block"],
             "dynamic_adv_acc": dynamic["adv_acc"], "dynamic_clean_acc": dynamic["clean_acc"]}
    print("resgcn nb --resgcn_fixed_graphs: " + json.dumps(stats))
    if len(rows) != RESGCN_BLOCKS or counts["knn"] != 12 or any(
            counts[k] for k in counts if k != "knn"):
        raise AssertionError(f"resgcn fixed graphs: {len(rows)} rows, launches {counts}, "
                             "want knn 12")
    if stats["clean_acc"] != dynamic["clean_acc"]:
        raise AssertionError("the fixed-graph run's clean accuracy is not the dynamic model's")
    records["knn"]["launches_by_path"]["resgcn nb --resgcn_fixed_graphs"] = counts["knn"]
    records["knn"]["calls_per_batch"]["resgcn nb --resgcn_fixed_graphs"] = counts["knn"]
    return stats


# phases 47-51: the ensemble victim and the ares benchmark layer
BENCH_BLOCKS = 8  # one batch of 8 × 4096 blocks per cli.benchmark call
# --samples of phase 48's score-based attacks at --iters SCORE_ITERS
# (nattack: NATTACK_ITERS × 16). At 16 × 10 NES left one training run's SSG
# (phase 17) at accuracy 0.9416 over its clean 0.9406, and the phase's
# check (adversarial accuracy at most clean) failed; at 32 × 20 NES took
# another run's from 0.9637 to 0.9578, SPSA to 0.9540 (an H100 80GB HBM3
# at 700 W)
# (SPSA 16 × 20 and NAttack 50 × 16 since the script's wall neared its limit)
SCORE_BUDGET, SCORE_ITERS = {"nes": 32, "spsa": 16}, 20
NATTACK_ITERS = 25  # phase 48's NAttack iterations (its own default 100; 50 until phases 82-83)
BENCH_CW_STEPS = 100  # 200 until phases 82-83 came
# phase 50's NES / SPSA budget and MIM's iterations
REFERENCE_SAMPLES, REFERENCE_ITERS, REFERENCE_MIM_ITERS = 4, 3, 10


def phase_ensemble(data: str, logs: dict, records) -> dict:
    """47. ``cli.attack --attack nb`` on the trained SSG (phase 17) with
    ``--ensemble pointnet2_msg:<MSG log> --ensemble pointnet:<PointNet
    log>:0.5`` (phases 39), ``PROTOCOL_BATCHES`` batches of 8 × 4096 under ``--ensemble_mode
    probs`` and then ``log_probs``: exactly 4 + 4 FPS and 8 + 12 bottom-k
    launches a batch (each PointNet++ member's geometry once a batch, shared
    by the eval and attack closures), ms a block beside NB alone; then a
    self-ensemble (the SSG twice), whose clean accuracy must equal the
    single model's."""
    n = PROTOCOL_BATCHES
    alone = _protocol_run(data, logs["pointnet2"], ["--attack", "nb"])
    members = ["--ensemble", f"pointnet2_msg:{logs['pointnet2_msg']}",
               "--ensemble", f"pointnet:{logs['pointnet']}:0.5"]
    runs = {"nb alone": alone}
    for mode in ("probs", "log_probs"):
        stats = _protocol_run(data, logs["pointnet2"], ["--attack", "nb", *members,
                                                        "--ensemble_mode", mode])
        counts = stats["launches"]
        if (counts["fps"], counts["bottom_k"], counts["knn"]) != (8 * n, 20 * n, 0):
            raise AssertionError(f"ensemble {mode}: launches {counts}, want fps {8 * n}, "
                                 f"bottom_k {20 * n}, knn 0")
        if not stats["adv_acc"] < stats["clean_acc"]:
            raise AssertionError(f"ensemble {mode}: NB did not lower the mixture's accuracy")
        runs[f"ensemble {mode}"] = stats
    self_ens = _protocol_run(data, logs["pointnet2"], [
        "--attack", "nb", "--ensemble", f"pointnet2:{logs['pointnet2']}"])
    runs["self-ensemble"] = self_ens
    if self_ens["clean_acc"] != alone["clean_acc"]:
        raise AssertionError(f"self-ensemble clean accuracy {self_ens['clean_acc']} != the "
                             f"single model's {alone['clean_acc']}")
    if (self_ens["launches"]["fps"], self_ens["launches"]["bottom_k"]) != (8 * n, 16 * n):
        raise AssertionError(f"self-ensemble launches {self_ens['launches']}")
    for name in ("fps", "bottom_k"):
        records[name]["launches_by_path"]["pointnet2 nb --ensemble"] = \
            runs["ensemble probs"]["launches"][name]
        records[name]["calls_per_batch"]["pointnet2 nb --ensemble msg + pointnet"] = \
            runs["ensemble probs"]["launches"][name] / n
    for k, v in runs.items():
        print(f"ensemble {k}: " + json.dumps(v))
    print("ensemble ms/block: " + json.dumps({k: round(v["ms_per_block"], 3)
                                              for k, v in runs.items()}))
    return runs


def _bench_cli(argv: list, model_cls) -> dict:
    """One ``cli.benchmark.main`` call with the launch counts set to 0 just
    before and read just after; the harness's wall (``AttackBenchmark.run``
    or ``worst_case_run``, synchronised) and the model's forwards."""
    from pointsecguard_tpu_torch.attacks import benchmark as harness
    from pointsecguard_tpu_torch.cli import benchmark as cli_bench
    from pointsecguard_tpu_torch.ops import cuda as kernels

    seconds, forwards = [], [0]
    real_run, real_forward = harness.AttackBenchmark.run, model_cls.forward

    def run(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run(self, *a, **k)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    def forward(self, *a, **k):
        forwards[0] += 1
        return real_forward(self, *a, **k)

    harness.AttackBenchmark.run, model_cls.forward = run, forward
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = cli_bench.main(argv)
        torch.cuda.synchronize()
    finally:
        harness.AttackBenchmark.run, model_cls.forward = real_run, real_forward
    return {"out": out, "main_wall_s": time.perf_counter() - t0,
            "harness_s": sum(seconds), "forwards": forwards[0],
            "launches": kernels.launch_counts()}


def _bench_argv(data: str, log: str, *flags, model: str = "pointnet2") -> list:
    return ["--model", model, "--data_root", data, "--log_dir", log, "--num_point",
            str(NUM_POINT), "--batch_size", str(BATCH), "--max_blocks", str(BENCH_BLOCKS),
            *flags]


def phase_benchmark_registry(data: str, log: str, records) -> dict:
    """48. ``cli.benchmark --model pointnet2`` on the trained SSG, one batch
    of 8 × 4096 a call: ``--mode prediction``, then ``--mode attack`` with
    fgsm, bim, pgd, mim, cw (``--cw_steps 100``), nes and spsa (``--samples
    32`` and ``16 --iters 20``, ``SCORE_BUDGET``) and nattack (16 × ``NATTACK_ITERS``): ms a batch, forwards a
    batch, queries per second for the score-based three (forwards × blocks
    / wall), adversarial accuracy and success rate. 4 FPS and 8 bottom-k
    launches a batch whatever the query count (C&W adds one bottom-k a
    step for its smooth term)."""
    from pointsecguard_tpu_torch.attacks import NAttackConfig
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG

    pred = _bench_cli(_bench_argv(data, log, "--mode", "prediction"), PointNet2SemSegSSG)
    ys, _, preds = pred["out"]
    runs = {"prediction": {"main_wall_s": pred["main_wall_s"], "forwards": pred["forwards"],
                           "acc": float((preds == ys).mean()), "launches": pred["launches"]}}
    outputs = {"prediction": pred["out"]}  # for phase 81
    if pred["forwards"] != 1 or (pred["launches"]["fps"], pred["launches"]["bottom_k"]) != (4, 8):
        raise AssertionError(f"prediction: {pred['forwards']} forwards, {pred['launches']}")
    total = {"fps": 4, "bottom_k": 8}
    for name in ("fgsm", "bim", "pgd", "mim", "cw", "nes", "spsa", "nattack"):
        flags = ["--mode", "attack", "--attack_name", name]
        if name == "cw":
            flags += ["--cw_steps", str(BENCH_CW_STEPS)]
        if name in SCORE_BUDGET:
            flags += ["--samples", str(SCORE_BUDGET[name]), "--iters", str(SCORE_ITERS)]
        if name == "nattack":
            flags += ["--iters", str(NATTACK_ITERS)]
        r = _bench_cli(_bench_argv(data, log, *flags), PointNet2SemSegSSG)
        acc, acc_adv, tot, succ, dist = r["out"]
        counts = r["launches"]
        stats = {"ms_per_batch": 1e3 * r["harness_s"], "forwards_per_batch": r["forwards"],
                 "acc": float(acc.mean()), "adv_acc": float(acc_adv.mean()),
                 "succ": float(succ.sum() / max(tot.sum(), 1)), "dist_mean": float(dist.mean()),
                 "main_wall_s": r["main_wall_s"], "launches": counts}
        if name in ("nes", "spsa", "nattack"):
            stats["queries_per_s"] = r["forwards"] * BENCH_BLOCKS / r["harness_s"]
        # the clean forward, the queries and the final forward
        want_forwards = {"nes": 2 + 2 * SCORE_BUDGET.get("nes", 0) * SCORE_ITERS,
                         "spsa": 2 + 2 * SCORE_BUDGET.get("spsa", 0) * SCORE_ITERS,
                         "nattack": 2 + NAttackConfig(eps=0.0).samples * NATTACK_ITERS}.get(name)
        print(f"benchmark {name}: " + json.dumps(stats))
        if want_forwards is not None and r["forwards"] != want_forwards:
            raise AssertionError(f"{name}: {r['forwards']} forwards, want {want_forwards}")
        if counts["fps"] != 4 or counts["knn"] or (
                counts["bottom_k"] != 8 if name != "cw" else counts["bottom_k"] <= 8):
            raise AssertionError(f"{name}: launches {counts}, want fps 4 and bottom_k 8 "
                                 "(C&W: 8 + one a step)")
        if not all(math.isfinite(v) for v in (stats["adv_acc"], stats["dist_mean"])):
            raise AssertionError(f"{name}: a non-finite result")
        if not stats["adv_acc"] <= stats["acc"]:
            raise AssertionError(f"{name}: adversarial accuracy above clean")
        runs[name] = stats
        outputs[name] = r["out"]
        if name != "cw":
            for k in total:
                total[k] += counts[k]
    for k, v in total.items():
        records[k]["launches_by_path"]["pointnet2 benchmark"] = v
        records[k]["calls_per_batch"]["pointnet2 benchmark (any registry attack)"] = \
            GEOMETRY_LAUNCHES["pointnet2"][k]
    print("benchmark ms/batch: " + json.dumps(
        {k: round(v["ms_per_batch"], 3) for k, v in runs.items() if "ms_per_batch" in v}))
    print("benchmark queries/s: " + json.dumps(
        {k: round(v["queries_per_s"], 1) for k, v in runs.items() if "queries_per_s" in v}))
    return outputs


def phase_benchmark_sweeps(data: str, log: str) -> dict:
    """49. ``cli.benchmark`` sweeps on the trained SSG, one batch of 8 ×
    4096: ``--mode distortion --attack_name pgd`` (the probes and the
    minimal ε; one geometry for all probes), ``--mode iteration
    --attack_name bim`` (10 rows, their L2 and whether it rises
    monotonically), ``--mode worstcase --attack_names pgd,nes`` (one
    geometry a batch and attack)."""
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG

    out = {}
    t0 = time.perf_counter()
    r = _bench_cli(_bench_argv(data, log, "--mode", "distortion", "--attack_name", "pgd"),
                   PointNet2SemSegSSG)
    eps, details = r["out"]
    out["distortion"] = {"epsilon": eps, "probes": details["probes"], "s": time.perf_counter() - t0,
                         "launches": r["launches"]}
    if not details["probes"] or (r["launches"]["fps"], r["launches"]["bottom_k"]) != (4, 8):
        raise AssertionError(f"distortion: {details}, launches {r['launches']}")
    if math.isfinite(eps) and not any(p["success"] and p["eps"] == eps
                                      for p in details["probes"]):
        raise AssertionError(f"distortion: minimal ε {eps} is no successful probe")
    t0 = time.perf_counter()
    r = _bench_cli(_bench_argv(data, log, "--mode", "iteration", "--attack_name", "bim"),
                   PointNet2SemSegSSG)
    rows = r["out"]
    l2 = [p["l2"] for p in rows]
    out["iteration"] = {"rows": rows, "l2_monotone": all(a <= b for a, b in zip(l2, l2[1:])),
                        "s": time.perf_counter() - t0, "launches": r["launches"]}
    if [p["iters"] for p in rows] != list(range(1, 11)) or not l2[-1] > l2[0]:
        raise AssertionError(f"iteration: rows {rows}")
    t0 = time.perf_counter()
    r = _bench_cli(_bench_argv(data, log, "--mode", "worstcase", "--attack_names", "pgd,nes"),
                   PointNet2SemSegSSG)
    robust, per_attack, combined = r["out"]
    out["worstcase"] = {"robust_acc": robust, "per_attack": per_attack,
                        "s": time.perf_counter() - t0, "launches": r["launches"]}
    outputs = {"distortion": (eps, details), "worstcase": r["out"]}
    if (r["launches"]["fps"], r["launches"]["bottom_k"]) != (8, 16):
        raise AssertionError(f"worstcase launches {r['launches']}, want fps 8, bottom_k 16")
    if not robust <= 1.0 - max(v["succ_rate"] for v in per_attack.values()) + 1e-12:
        raise AssertionError(f"worstcase: robust accuracy {robust} above an attack's")
    print("benchmark sweeps: " + json.dumps(out))
    return outputs


def phase_score_reference(dev, log: str) -> dict:
    """50. Card against CPU on two 4096-point blocks of the trained SSG, on
    the card's geometry: NES and SPSA at ``REFERENCE_SAMPLES`` pairs and
    ``REFERENCE_ITERS`` iterations with the same CPU-drawn noise through
    ``noise=``, in float32: how many colour elements took a different step
    (more than 1e-4 apart), by how many α (a sign flip of NES's estimate,
    where the two devices round a near-zero element apart, moves an element
    by 2α; so can SPSA's first Adam step, g / |g|), and how many differ by
    rounding alone. Then why, on NES's first step from the same clean
    colours (``nes_first_step``): every flipped sign lies within the rounding
    bound of the estimate. Then MIM (the registry's decay 1.0,
    ``REFERENCE_MIM_ITERS`` iterations) in float64 within 1e-10.

    The head's logits are float32 on every trunk dtype (as JAX's), so the
    loss queries round at float32 even on a float64 trunk: a float64 NES
    trajectory can flip a sign too, and a flip early on moves the later
    queries, so whole trajectories are counted, not exempted."""
    from pointsecguard_tpu_torch import attacks
    from pointsecguard_tpu_torch.attacks import benchmark as harness
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    model_cls, family = POINTNET_MODELS["pointnet2"]
    net = model_cls()
    net.load_state_dict(load_checkpoint(log))
    net.eval().requires_grad_(False)
    pts = slice_blocks(dev)[[0, 4]].contiguous()
    geo = family.plan(pts)
    labels = torch.argmax(family.head(family.apply(net.to(dev), pts, geo)), -1)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(11)
    shape = (2, NUM_POINT, 3)
    draws = {"nes": [[torch.randn(shape, generator=gen) for _ in range(REFERENCE_SAMPLES)]
                     for _ in range(REFERENCE_ITERS)],
             "spsa": [[(2 * torch.randint(0, 2, shape, generator=gen) - 1).float()
                       for _ in range(REFERENCE_SAMPLES)] for _ in range(REFERENCE_ITERS)]}
    cfgs = {"nes": harness.load_attack("nes", {"eps": 0.1, "alpha": 0.05,
                                               "iters": REFERENCE_ITERS,
                                               "samples": REFERENCE_SAMPLES}),
            "spsa": harness.load_attack("spsa", {"eps": 0.1, "alpha": 0.05,
                                                 "iters": REFERENCE_ITERS,
                                                 "samples": REFERENCE_SAMPLES})}
    out = {}
    for name, dtype in (("nes", torch.float32), ("spsa", torch.float32)):
        adv = {}
        for where, device in (("card", dev), ("cpu", cpu)):
            m = net.to(device=device, dtype=dtype)
            g = _to_device(geo, device, dtype)
            res = harness.run_registered_attack(
                lambda p: family.head(family.apply(m, p, g)), pts.to(device, dtype),
                labels.to(device), cfgs[name],
                noise=lambda it, s: draws[name][it][s].to(device, dtype))
            adv[where] = res.points_adv[..., 3:6].cpu().double()
        diff = (adv["card"] - adv["cpu"]).abs()
        # a different step moves a colour by a share of α (0.05); rounding of
        # the same step by ~1e-7
        differ = diff > 1e-4
        key = f"{name} {str(dtype).split('.')[-1]}"
        out[key] = {"elements": diff.numel(), "differ": int(differ.sum()),
                    "rounding_only": int(((diff > 0) & ~differ).sum()),
                    "max_abs": diff.max().item(),
                    "differ_in_alphas": sorted({round(v / 0.05, 2)
                                                for v in diff[differ].tolist()})[:12]}
        print(f"score attack card vs CPU {key}: " + json.dumps(out[key]))
        limit = 0.05 * diff.numel()
        if out[key]["differ"] > limit:
            raise AssertionError(f"{key}: {out[key]['differ']} colour elements differ card vs "
                                 f"CPU, want at most {limit}")
    out["nes_first_step"] = nes_first_step(dev, net, family, geo, pts, labels,
                                           draws["nes"][0])
    cfg = harness.load_attack("mim", {"eps": 0.1, "alpha": 0.05, "iters": REFERENCE_MIM_ITERS})
    adv = {}
    for where, device in (("card", dev), ("cpu", cpu)):
        m = net.to(device=device, dtype=torch.float64)
        g = _to_device(geo, device, torch.float64)
        adv[where] = attacks.pgd_color_attack(
            lambda p: family.head(family.apply(m, p, g)), pts.to(device, torch.float64),
            labels.to(device), cfg).points_adv.cpu()
    out["mim float64 max_abs"] = (adv["card"] - adv["cpu"]).abs().max().item()
    print("mim float64 card vs CPU: " + json.dumps(out["mim float64 max_abs"]))
    if out["mim float64 max_abs"] > 1e-10:
        raise AssertionError(f"MIM float64 card vs CPU {out['mim float64 max_abs']}")
    return out


def nes_first_step(dev, net, family, geo, pts, labels, draws) -> dict:
    """NES's first step (``REFERENCE_SAMPLES`` pairs of ``draws``) on the
    card and on the CPU from the same clean colours, in float32. Each side's
    estimate g is recomputed from the loss queries its engine made (the
    same sum in the same order, so its signs are the engine's: checked
    against the engine's step, exactly). Where the two signs differ, the
    CPU's |g| must lie within the rounding bound

        Σ_s |Δd_s|·|u_s| / (2·S·σ) + 8·2⁻²⁴·Σ_s |d_s|·|u_s| / (2·S·σ),

    Δd_s the card-vs-CPU gap of pair s's loss difference d_s = lp − lm (and
    the second term the float32 rounding of the sum itself); every query's
    loss must agree within 1e-4 of the largest (the float32 forward's own
    gap is ~1e-6 of its scale: phases 1 and 36; a different computation,
    such as another geometry, moves a loss by percents); and the steps must
    differ at the flipped signs only. The flips are counted, not excused
    beyond the bound."""
    from pointsecguard_tpu_torch.attacks import benchmark as harness
    from pointsecguard_tpu_torch.attacks.common import per_point_ce

    cfg = harness.load_attack("nes", {"eps": 0.1, "alpha": 0.05, "iters": 1,
                                      "samples": REFERENCE_SAMPLES})
    sides = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        m = net.to(device=device, dtype=torch.float32)
        g = _to_device(geo, device, torch.float32)
        seen = []

        def outputs_fn(p, m=m, g=g, seen=seen):
            seen.append(family.head(family.apply(m, p, g)))
            return seen[-1]

        x, ys = pts.to(device), labels.to(device)
        us = [u.to(device) for u in draws]
        res = harness.run_registered_attack(outputs_fn, x, ys, cfg, noise=lambda it, s: us[s])
        losses = [torch.mean(per_point_ce(o, ys), dim=1) for o in seen[:2 * cfg.samples]]
        color0 = x[..., 3:6]
        est = torch.zeros_like(color0)
        for s in range(cfg.samples):
            est = est + (losses[2 * s] - losses[2 * s + 1])[:, None, None] * us[s]
        est = est / (2.0 * cfg.samples * cfg.sigma)
        # the engine's step and projection on this side's signs
        step = color0 + 1.0 * (cfg.alpha * torch.sign(est))
        want = torch.clamp(color0 + torch.clamp(step - color0, -cfg.eps, cfg.eps), *cfg.clip)
        if not torch.equal(res.points_adv[..., 3:6], want):
            raise AssertionError(f"nes first step on the {where}: the engine's step is not "
                                 "the sign of the recomputed estimate")
        sides[where] = {"adv": want.cpu().double(), "est": est.cpu().double(),
                        "loss": torch.stack(losses).cpu().double()}  # [2S, B]
    card, cpu = sides["card"], sides["cpu"]
    d = {k: v["loss"][0::2] - v["loss"][1::2] for k, v in sides.items()}  # [S, B]
    u = torch.stack([v.double() for v in draws]).abs()  # [S, B, N, 3]
    scale = 2.0 * cfg.samples * cfg.sigma
    bound = ((d["card"] - d["cpu"]).abs()[:, :, None, None] * u).sum(0) / scale \
        + 8 * 2.0 ** -24 * (d["cpu"].abs()[:, :, None, None] * u).sum(0) / scale
    flips = torch.sign(card["est"]) != torch.sign(cpu["est"])
    differ = (card["adv"] - cpu["adv"]).abs() > 1e-4
    loss_gap = (card["loss"] - cpu["loss"]).abs().max().item()
    loss_limit = 1e-4 * cpu["loss"].abs().max().item()
    out = {"elements": flips.numel(), "flips": int(flips.sum()),
           "unexplained": int((flips & (cpu["est"].abs() > bound)).sum()),
           "differ_not_flipped": int((differ & ~flips).sum()),
           "loss_gap": loss_gap, "loss_limit": loss_limit,
           "flipped_abs_g_max": cpu["est"].abs()[flips].max().item() if flips.any() else 0.0,
           "bound_median": bound.median().item(),
           "abs_g_median": cpu["est"].abs().median().item()}
    print("nes first step card vs CPU: " + json.dumps(out))
    if out["unexplained"] or out["differ_not_flipped"] or not loss_gap <= loss_limit:
        raise AssertionError(f"nes first step card vs CPU: {out}")
    return out


def phase_benchmark_victims(data: str, prep: str, randla_log: str, resgcn_log: str,
                            records) -> dict:
    """51. ``cli.benchmark --mode attack`` on the other victims: ``--model
    randla --attack_name pgd`` on the trained RandLA (phase 24), one batch of
    4 × 40960 (exactly 10 kNN launches: one pyramid a batch); ``--model
    resgcn --attack_name bim --iters 10`` on phase 29's checkpoint, one batch
    of 8 × 4096 (4 kNN launches a forward: clean, 10 iterations, final)."""
    from pointsecguard_tpu_torch import configs
    from pointsecguard_tpu_torch.models import DenseDeepGCN, RandLANet

    out = {}
    r = _bench_cli(["--model", "randla", "--randla_dir", prep, "--log_dir", randla_log,
                    "--batch_size", str(RANDLA_BATCH), "--max_blocks", str(RANDLA_BATCH),
                    "--mode", "attack", "--attack_name", "pgd"], RandLANet)
    r2 = _bench_cli(["--model", "resgcn", "--data_root", data, "--log_dir", resgcn_log,
                     "--num_point", str(NUM_POINT), "--batch_size", str(RESGCN_BATCH),
                     "--max_blocks", str(RESGCN_BATCH), "--mode", "attack", "--attack_name",
                     "bim", "--iters", "10"], DenseDeepGCN)
    # the pyramid: a neighbour list and an up-sampling list a layer
    pyramid = 2 * configs.RandlaConfig().num_layers
    for name, run, knn_want in (("randla", r, pyramid), ("resgcn", r2, 4 * r2["forwards"])):
        acc, acc_adv, tot, succ, dist = run["out"]
        counts = run["launches"]
        out[name] = {"ms_per_batch": 1e3 * run["harness_s"], "forwards": run["forwards"],
                     "acc": float(acc.mean()), "adv_acc": float(acc_adv.mean()),
                     "succ": float(succ.sum() / max(tot.sum(), 1)),
                     "dist_mean": float(dist.mean()), "launches": counts}
        print(f"benchmark {name}: " + json.dumps(out[name]))
        if counts["knn"] != knn_want or any(counts[k] for k in counts if k != "knn"):
            raise AssertionError(f"{name} benchmark launches {counts}, want knn {knn_want}")
        if not (math.isfinite(out[name]["dist_mean"]) and out[name]["adv_acc"] <= out[name]["acc"]):
            raise AssertionError(f"{name} benchmark: {out[name]}")
        records["knn"]["launches_by_path"][f"{name} benchmark"] = counts["knn"]
        records["knn"]["calls_per_batch"][f"{name} benchmark"] = counts["knn"]
    if r2["forwards"] != 12:
        raise AssertionError(f"resgcn bim: {r2['forwards']} forwards, want 12")
    return out


# --- phases 52-55: RandLA-Net's outdoor presets at full width ------------------
# Semantic3D: the config's batch of 4 × 65536 points, 5 levels, 8 classes;
# SemanticKITTI: 6 × 45056, 4 levels, 19 classes on xyz-only features. The
# raw stand-ins are street scenes written in the datasets' own formats
# (data/synthetic_outdoor.py): three Semantic3D clouds of 160k points over
# 50 × 50 m (each keeps over 65536 points on the 0.06 m grid), four KITTI
# scans of 120k points (sequences 00 × 2, 08, 11)
SEM3D_BATCH, SEM3D_POINTS, SEM3D_RAW_POINTS, SEM3D_EXTENT = 4, 65536, 160_000, 25.0
KITTI_BATCH, KITTI_POINTS, KITTI_RAW_POINTS = 6, 45056, 120_000
SEM3D_STATE_FLOATS = 5_010_816  # the S3DIS model with an 8-class head
KITTI_STATE_FLOATS = 1_250_003  # 4 levels to 512 channels, 3 inputs, 19 classes
# training: a few steps an epoch, one validation batch (the configs' 16 × 65536
# and 20 × 45056 clouds), 2 epochs and one more on resume (Semantic3D)
OUTDOOR_TRAIN_STEPS, OUTDOOR_VAL_STEPS, OUTDOOR_TRAIN_EPOCHS = 8, 1, 2


def phase_prepare_outdoor(data: str) -> dict:
    """52. Raw SemanticKITTI, Semantic3D and S3DIS trees in the datasets'
    formats, then ``cli.prepare`` on each; the clouds must hold the
    presets' sample sizes. Returns the prepared directories."""
    from pointsecguard_tpu_torch.cli import prepare
    from pointsecguard_tpu_torch.data import synthetic_outdoor as synth
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset

    out, seconds = {}, {}
    t0 = time.perf_counter()
    seq, yaml_path = synth.write_raw_semantickitti(os.path.join(WORK, "kitti_raw"),
                                                   points=KITTI_RAW_POINTS, seed=0)
    synth.write_raw_semantic3d(os.path.join(WORK, "sem3d_raw"), points=SEM3D_RAW_POINTS,
                               extent=SEM3D_EXTENT, seed=0)
    rooms = sorted(os.path.join(data, f) for f in os.listdir(data))
    synth.write_raw_s3dis(rooms, os.path.join(WORK, "s3dis_raw"))
    seconds["write raw"] = time.perf_counter() - t0
    for dataset, argv in (
            ("semantickitti", ["--dataset", "semantickitti", "--raw_root", seq,
                               "--kitti_yaml", yaml_path, "--out_root",
                               os.path.join(WORK, "kitti_prep")]),
            ("semantic3d", ["--dataset", "semantic3d", "--raw_root",
                            os.path.join(WORK, "sem3d_raw"), "--out_root",
                            os.path.join(WORK, "sem3d_prep")]),
            ("s3dis", ["--raw_root", os.path.join(WORK, "s3dis_raw"), "--out_root",
                       os.path.join(WORK, "s3dis_rooms"), "--randla_out",
                       os.path.join(WORK, "s3dis_prep", "randla_input_0.040")])):
        t0 = time.perf_counter()
        prepare.main(argv)
        seconds[dataset] = time.perf_counter() - t0
    out["semantickitti"] = os.path.join(WORK, "kitti_prep")
    out["semantic3d"] = os.path.join(WORK, "sem3d_prep", "input_0.060")
    out["semantic3d_original"] = os.path.join(WORK, "sem3d_prep", "original_ply")
    for a, b in zip(rooms, sorted(os.listdir(os.path.join(WORK, "s3dis_rooms")))):
        if np.load(a).shape != np.load(os.path.join(WORK, "s3dis_rooms", b)).shape:
            raise AssertionError(f"cli.prepare collected {b} with another point count")
    sizes = {}
    for dataset, want in (("semantickitti", KITTI_POINTS), ("semantic3d", SEM3D_POINTS)):
        preset = randla_dataset_preset(dataset)
        for split in ("train", "test"):
            clouds = preset.make_sampler(out[dataset], split, want, None).clouds
            if not clouds:
                raise AssertionError(f"cli.prepare left no {dataset} {split} cloud")
            for c in clouds:
                sizes[c.name] = len(c.labels)
                if len(c.labels) < want:
                    raise AssertionError(f"{dataset} cloud {c.name}: {len(c.labels)} points, "
                                         f"fewer than the preset's {want}")
    print(f"phase 52 prepare: seconds {json.dumps(seconds)}; sub-cloud points {sizes}")
    return out


def outdoor_batch(prep: str, dataset: str, split: str, dev, seed: int = 7):
    """One sampler batch of the preset at its config's batch and points:
    features [B, P, 6] (Semantic3D) or [B, P, 3] (SemanticKITTI) and raw
    labels on ``dev``."""
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset

    preset = randla_dataset_preset(dataset)
    cfg = preset.cfg
    sampler = preset.make_sampler(prep, split, cfg.num_points, np.random.default_rng(seed))
    _, feats, labels, _, _ = next(sampler.batches(cfg.batch_size, 1))
    return torch.from_numpy(feats).to(dev), torch.from_numpy(labels).long().to(dev)


def phase_outdoor_knn(dev, records, preps: dict) -> None:
    """53. ``knn`` at every call of one ``build_pyramid`` of Semantic3D's
    [4, 65536] (5 levels, 10 calls) and SemanticKITTI's [6, 45056] (4
    levels, 8 calls) on the samplers' clouds: values and indices equal to
    ``knn_plain`` on the card, the launches of one pyramid counted, median
    kernel and plain times per pyramid against the bound (a kernel phase)."""
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import build_pyramid
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.cuda import bounds, knn

    for dataset in ("semantic3d", "semantickitti"):
        cfg = randla_dataset_preset(dataset).cfg
        feats, _ = outdoor_batch(preps[dataset], dataset, "train", dev)
        xyz = feats[..., :3].contiguous()
        calls = pyramid_knn_inputs(xyz, cfg.sub_sampling_ratio)
        err = 0.0
        for q, p, k in calls:
            err = max(err, _equal(f"knn ({dataset}) {tuple(q.shape)} x {tuple(p.shape)} k={k}",
                                  knn.knn(q, p, k), knn.knn_plain(q, p, k)))
        kernels.reset_launch_counts()
        build_pyramid(xyz, num_layers=cfg.num_layers, k=cfg.k_n,
                      sub_ratios=cfg.sub_sampling_ratio)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["knn"]
        if launches != 2 * cfg.num_layers:
            raise AssertionError(f"{dataset} build_pyramid launched knn {launches} times, "
                                 f"want {2 * cfg.num_layers}")

        def run(f):
            return lambda: [f(q, p, k) for q, p, k in calls]

        work = bounds.total(bounds.knn(q.shape[0], q.shape[1], p.shape[1], q.shape[2], k)
                            for q, p, k in calls)
        unit = f"one build_pyramid of [{cfg.batch_size}, {cfg.num_points}] ({dataset})"
        rec = {"unit": unit, "ms": device_ms(run(knn.knn), reps=3),
               "eager_ms": cuda_ms(run(knn.knn), reps=10),
               "plain_ms": cuda_ms(run(knn.knn_plain), reps=2, warmup=1),
               "bound_ms": work.bound_ms, "bound_by": work.bound_by, "library_ms": None,
               "launches": launches, "max_abs_err": err}
        print(f"knn ({dataset}): kernel {rec['ms']:.4f} ms on the card ({rec['eager_ms']:.4f} "
              f"ms as eager calls, median), plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {work.bytes} bytes, "
              f"{work.operations} operations; share {rec['bound_ms'] / rec['ms']:.3f}) per "
              f"{unit}, {launches} launches; values and indices equal to plain at all "
              f"{len(calls)} calls")
        for q, p, k in calls:
            ms = device_ms(lambda: knn.knn(q, p, k), reps=3)
            b = bounds.knn(q.shape[0], q.shape[1], p.shape[1], q.shape[2], k)
            print(f"  knn {tuple(q.shape)} x {tuple(p.shape)} k={k}: {ms:.4f} ms "
                  f"(bound {b.bound_ms:.4f} ms, {b.bound_by})")
        records["knn"][f"{dataset}_pyramid"] = rec
    outdoor_attentive(dev, records)


def outdoor_attentive(dev, records) -> None:
    """The fused attentive pair at one Semantic3D attack pass under
    ``--fused_ap``: 2 × [16, 4 · 65536, 8] and 2 × [16, 65536, 32], forward
    and backward without dW within tolerance of plain (values and the fn /
    fx gradients), timed per pass against the bound."""
    from pointsecguard_tpu_torch.ops.attentive import attentive_pool_fused_plain as plain
    from pointsecguard_tpu_torch.ops.cuda import attentive, bounds

    gen = torch.Generator(device=dev).manual_seed(4)
    M = SEM3D_BATCH * SEM3D_POINTS
    shapes = [(16, M, 8), (16, M, 8), (16, M // 4, 32), (16, M // 4, 32)]
    calls = [attentive_case(*shape, gen, dev) for shape in shapes]
    cots = [tuple(torch.randn((2, m, d), generator=gen, device=dev)) for _, m, d in shapes]
    res, errs = {}, [0.0, 0.0]
    for name, f in (("kernel", attentive.attentive_pool_fused), ("plain", plain)):
        timer = cuda_ms if name == "plain" else device_ms
        with torch.no_grad():
            eager_f = cuda_ms(lambda: [f(*c) for c in calls], reps=10)
            dev_f = timer(lambda: [f(*c) for c in calls], reps=5)
        leaves = [(fn.clone().requires_grad_(True), fx.clone().requires_grad_(True), w)
                  for fn, fx, w in calls]
        outs = [o for lv in leaves for o in f(*lv)]
        flat = [t for lv in leaves for t in lv[:2]]
        cot = [g for c in cots for g in c]
        grads = torch.autograd.grad(outs, flat, cot, retain_graph=True)
        eager_b = cuda_ms(lambda: torch.autograd.grad(outs, flat, cot, retain_graph=True),
                          reps=10)
        dev_b = timer(lambda: torch.autograd.grad(outs, flat, cot, retain_graph=True), reps=5)
        res[name] = (eager_f, dev_f, eager_b, dev_b, [o.detach() for o in outs], grads)
        del leaves, outs, flat
    (ef, kf, eb, kb, ko, kg), (_, pf, _, pb, po, pg) = res["kernel"], res["plain"]
    for a, b in zip(ko, po):
        if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=2e-5, atol=2e-6)):
            raise AssertionError(f"attentive fwd at {tuple(a.shape)}: "
                                 f"max |diff| {(a - b).abs().max().item():.3e}")
        errs[0] = max(errs[0], (a - b).abs().max().item())
    for a, b in zip(kg, pg):
        errs[1] = max(errs[1], grad_err(f"attentive bwd {tuple(a.shape)}", a, b))
    for name, f, ms, eager, plain_ms, err in (
            ("attentive_fwd", bounds.attentive_fwd, kf, ef, pf, errs[0]),
            ("attentive_bwd", bounds.attentive_bwd, kb, eb, pb, errs[1])):
        work = bounds.total(f(*shape) for shape in shapes)
        records[name]["semantic3d_pass"] = {
            "unit": f"4 calls of one Semantic3D pass: 2 x [16, {M}, 8], 2 x [16, {M // 4}, 32]",
            "ms": ms, "eager_ms": eager, "plain_ms": plain_ms, "bound_ms": work.bound_ms,
            "bound_by": work.bound_by, "library_ms": None, "max_abs_err": err}
        print(f"{name} (semantic3d pass, 4 calls): kernel {ms:.4f} ms on the card "
              f"({eager:.4f} ms as eager calls, median), plain {plain_ms:.4f} ms, bound "
              f"{work.bound_ms:.4f} ms ({work.bound_by}; share {work.bound_ms / ms:.3f}); "
              f"within tolerance of plain (max |diff| {err:.3e})")


def _outdoor_train(dataset: str, prep: str, records, epochs: int, resume: bool) -> dict:
    """``cli.train.main --model randla --randla_dataset <dataset>`` at the
    preset's batch and points, ``OUTDOOR_TRAIN_STEPS`` steps and one
    validation batch an epoch, then (``resume``) one more epoch; the
    launches of the first call counted (2 × levels a train step and a
    validation batch)."""
    from pointsecguard_tpu_torch.cli import train as cli
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = randla_dataset_preset(dataset).cfg
    log = os.path.join(WORK, f"{dataset}_train_log")

    def argv(n):
        return ["--model", "randla", "--randla_dataset", dataset, "--randla_dir", prep,
                "--log_dir", log, "--steps_per_epoch", str(OUTDOOR_TRAIN_STEPS),
                "--val_steps", str(OUTDOOR_VAL_STEPS), "--epochs", str(n)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(argv(epochs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    events = read_events(log)
    ep = [e for e in events if e["event"] == "epoch"]
    ev = [e for e in events if e["event"] == "eval"]
    if [e["epoch"] for e in ep] != list(range(epochs)) or len(ev) != epochs:
        raise AssertionError(f"{dataset} epoch lines {[e['epoch'] for e in ep]}, {len(ev)} evals")
    if any(e["batches"] != OUTDOOR_TRAIN_STEPS or e["nan_batches"] for e in ep):
        raise AssertionError(f"{dataset} steps or skipped batches: {ep}")
    if not all(math.isfinite(e["loss"]) for e in ep):
        raise AssertionError(f"{dataset}: a non-finite epoch loss")
    per_batch = 2 * cfg.num_layers
    batches = OUTDOOR_TRAIN_STEPS * epochs + OUTDOOR_VAL_STEPS * epochs
    if counts["knn"] != per_batch * batches or any(counts[k] for k in counts if k != "knn"):
        raise AssertionError(f"{dataset} train launches {counts}, want knn {per_batch} × "
                             f"{batches} batches and nothing else")
    records["knn"]["launches_by_path"][f"randla {dataset} train"] = counts["knn"]
    records["knn"]["calls_per_batch"][f"randla {dataset} train step"] = per_batch
    if resume:
        cli.main(argv(epochs + 1))
        resumed = [e["epoch"] for e in read_events(log) if e["event"] == "epoch"]
        latest = CheckpointManager(os.path.join(log, "checkpoints")).restore_latest()
        if resumed != list(range(epochs + 1)) or latest["epoch"] != epochs + 1:
            raise AssertionError(f"{dataset} epochs after the resumed call: {resumed}")
    warm = ep[1:]  # the first epoch pays the one-off set-up
    host_ms = 1e3 * sum(e["seconds"] for e in warm) / sum(e["batches"] for e in warm)
    return {"log": log, "batch": [cfg.batch_size, cfg.num_points],
            "epoch_loss": [e["loss"] for e in ep], "val_accuracy": [e["accuracy"] for e in ev],
            "val_miou": [e["miou"] for e in ev], "ms_per_step_host_clock": host_ms,
            "clouds_per_sec": 1e3 * cfg.batch_size / host_ms,
            "peak_device_memory_gb": peak / 1e9, "main_wall_s": wall, "launches": counts}


def _outdoor_step_ms(dataset: str, prep: str, log: str, dev) -> float:
    """ms of one optimizer step alone on the card (CUDA events around each
    of 5 steps on a batch that already lies there), on the trained state."""
    from functools import partial

    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import RandLANet, weighted_softmax_ce_loss
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, randla_family
    from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager

    preset = randla_dataset_preset(dataset)
    cfg = preset.cfg
    model = RandLANet(num_classes=preset.num_classes, d_out=cfg.d_out,
                      d_in=6 if preset.has_colors else 3)
    state = TrainState(model.to(dev))
    state.load_payload(CheckpointManager(os.path.join(log, "checkpoints")).restore_latest())
    table = torch.from_numpy(preset.label_table()).to(dev)
    step = make_train_step(model, partial(weighted_softmax_ce_loss, label_table=table),
                           weight_decay=0.0, family=randla_family(cfg))
    feats, labels = outdoor_batch(prep, dataset, "train", dev, seed=1)
    weights = torch.from_numpy(get_class_weights(preset.weights_key)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cuda_ms(lambda: step(state, feats, labels, weights, 1e-4, None, gen), reps=5)


def _outdoor_eval(dataset: str, prep: str, log: str, records, extra=()) -> dict:
    """``cli.eval.main`` on the trained checkpoint: two batches of the
    preset's training batch size voted; 2 × levels kNN launches a batch."""
    from pointsecguard_tpu_torch.cli import eval as cli
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.ops import cuda as kernels

    cfg = randla_dataset_preset(dataset).cfg
    clouds = 2 * cfg.batch_size
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m = cli.main(["--model", "randla", "--randla_dataset", dataset, "--randla_dir", prep,
                  "--log_dir", log, "--num_clouds", str(clouds),
                  "--batch_size", str(cfg.batch_size), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = 2 * cfg.num_layers * 2
    if counts["knn"] != want or not (math.isfinite(m.miou) and 0.0 <= m.accuracy <= 1.0):
        raise AssertionError(f"{dataset} eval: launches {counts} (want knn {want}), "
                             f"accuracy {m.accuracy}, mIoU {m.miou}")
    records["knn"]["launches_by_path"][f"randla {dataset} eval"] = counts["knn"]
    return {"accuracy": m.accuracy, "miou": m.miou, "class_iou": list(m.class_iou),
            "clouds": clouds, "ms_per_cloud": 1e3 * wall / clouds, "launches": counts}


def phase_semantic3d(dev, records, preps: dict) -> dict:
    """54. Semantic3D at full width: ``cli.train`` 4 × 65536 (2 epochs + 1
    on resume), the step alone by CUDA events; ``cli.eval`` (voting,
    reprojection through ``_proj.pkl``) with ``--save_preds``, a
    prediction for every point of the original cloud; NB through ``cli.attack`` on 4
    clouds at batch 4 on a calibrated random model, with and without
    ``--fused_ap`` (10 kNN a batch, the fused kernels' launches, ignored
    points' colours unchanged, mean accuracy lowered); the 5-layer 8-class
    model and the ignored-label loss card vs CPU against float64."""
    from pointsecguard_tpu_torch.data.ply import read_ply
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    prep, out = preps["semantic3d"], {}
    t0 = time.perf_counter()
    train = _outdoor_train("semantic3d", prep, records, OUTDOOR_TRAIN_EPOCHS, resume=True)
    train["ms_per_step"] = _outdoor_step_ms("semantic3d", prep, train["log"], dev)
    train["host_share"] = 1.0 - train["ms_per_step"] / train["ms_per_step_host_clock"]
    print("semantic3d train: " + json.dumps({k: v for k, v in train.items() if k != "log"}))
    preds = os.path.join(WORK, "semantic3d_preds")
    ev = _outdoor_eval("semantic3d", prep, train["log"], records, ("--save_preds", preds))
    plys = sorted(os.listdir(preds))
    for name in plys:
        n = len(read_ply(os.path.join(preds, name))["pred"])
        want = len(read_ply(os.path.join(preps["semantic3d_original"], name))["class"])
        if n != want:
            raise AssertionError(f"{name}: {n} predictions for {want} original points")
    if not plys:
        raise AssertionError("cli.eval --save_preds wrote no Semantic3D prediction")
    print(f"semantic3d eval: {json.dumps(ev)}; predictions {plys} at the original clouds' "
          "resolution")
    out.update(train={k: v for k, v in train.items() if k != "log"}, eval=ev)

    # NB on a calibrated random model: trained for 24 steps, BatchNorm's
    # running statistics are still mostly the initial ones
    feats, _ = outdoor_batch(prep, "semantic3d", "test", dev, seed=3)
    sd = randla_state_dict(0, dev, feats, floats=SEM3D_STATE_FLOATS, num_classes=8)
    log = os.path.join(WORK, "semantic3d_attack_log")
    save_checkpoint(log, sd)
    runs = []
    for fused in (False, True):
        stats = run_randla_cli(prep, log, "nb", fused, SEM3D_BATCH,
                               extra=("--randla_dataset", "semantic3d", "--save_adv"),
                               points=SEM3D_POINTS)
        with np.load(os.path.join(log, "randla_nb_adv_area5.npz")) as npz:
            adv, raw = npz["points"], npz["labels"]
        sampler = randla_dataset_preset("semantic3d").make_sampler(
            prep, "test", SEM3D_POINTS, np.random.default_rng(0))
        clean = next(sampler.batches(SEM3D_BATCH, 1))[1]
        ignored = raw == 0
        if not ignored.any() or not np.array_equal(adv[ignored], clean[ignored]):
            raise AssertionError("NB moved the colour of an ignored point "
                                 f"({int(ignored.sum())} ignored)")
        if not stats["adv_acc"] < stats["clean_acc"]:
            raise AssertionError(f"semantic3d NB did not lower the mean accuracy: {stats}")
        stats["ignored_points"] = int(ignored.sum())
        print("semantic3d nb: " + json.dumps(stats))
        runs.append(stats)
    records["knn"]["launches_by_path"]["randla semantic3d nb"] = runs[0]["launches"]["knn"]
    records["knn"]["calls_per_batch"]["randla semantic3d nb"] = runs[0]["launches"]["knn"]
    for name in ("attentive_fwd", "attentive_bwd"):
        records[name]["calls_per_batch"]["randla semantic3d nb --fused_ap"] = \
            runs[1]["launches"][name]
    out["nb"] = runs
    out["reference"] = outdoor_reference(dev, prep)
    print(f"phase 54: {time.perf_counter() - t0:.1f} s")
    return out


def outdoor_reference(dev, prep: str) -> dict:
    """The 5-layer 8-class model's logits and the ignored-label loss on one
    8192-point Semantic3D cloud (CPU's pyramid, on both devices), each
    against the CPU's float64 run: the float64 run on the card within 5e-7
    of the largest logit and of the loss (the attentive scores' softmax and
    the head's logits are float32 on every trunk dtype, as in the JAX
    model: a few float32 ulps apart; on the H100 it read 2.0e-7, where a
    float32 run reads 1.2e-6 to 1.5e-6, so a float64 run that computed in
    float32 fails), each device's float32 run within 1e-5."""
    from pointsecguard_tpu_torch.data.class_weights import get_class_weights
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid, weighted_softmax_ce_loss

    preset = randla_dataset_preset("semantic3d")
    sampler = preset.make_sampler(prep, "test", 8192, np.random.default_rng(5))
    _, feats, labels, _, _ = next(sampler.batches(1, 1))
    feats, labels = torch.from_numpy(feats), torch.from_numpy(labels).long()
    sd = randla_state_dict(2, dev, feats.to(dev), floats=SEM3D_STATE_FLOATS, num_classes=8)
    pyr = build_pyramid(feats[..., :3])
    table = torch.from_numpy(preset.label_table())
    w = torch.from_numpy(get_class_weights(preset.weights_key))
    got = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        for dtype in (torch.float32, torch.float64):
            model = RandLANet(num_classes=8)
            model.load_state_dict(sd)
            model.to(device=device, dtype=dtype).eval()
            p = {k: [t.to(device, dtype) if t.is_floating_point() else t.to(device)
                     for t in v] for k, v in pyr.items()}
            with torch.no_grad():
                lg = model(feats.to(device, dtype), p)
                loss = weighted_softmax_ce_loss(lg, labels.to(device), w.to(device, dtype),
                                                label_table=table.to(device))
            got[(where, dtype)] = (lg.double().cpu(), float(loss))
    ref_lg, ref_loss = got[("cpu", torch.float64)]
    scale = ref_lg.abs().max().item()
    errs = {f"{d} {str(t)[6:]}": ((lg - ref_lg).abs().max().item() / scale,
                                  abs(loss - ref_loss) / abs(ref_loss))
            for (d, t), (lg, loss) in got.items()}
    print(f"semantic3d model card vs CPU against CPU float64 (relative to the largest logit "
          f"{scale:.4f}; loss {ref_loss:.6f} over {int((labels > 0).sum())} valid of "
          f"{labels.numel()} points): {json.dumps(errs)}")
    if not (errs["card float64"][0] <= 5e-7 and errs["card float64"][1] <= 5e-7
            and all(e[0] <= 1e-5 and e[1] <= 1e-5 for e in errs.values())):
        raise AssertionError(f"the Semantic3D model disagrees card vs CPU: {errs}")
    return errs


def phase_semantickitti(dev, records, preps: dict) -> dict:
    """55. SemanticKITTI at full width: ``cli.train`` 6 × 45056 on xyz-only
    features (2 epochs, 8 kNN launches a step), ``cli.eval`` at sub-cloud
    resolution, and ``cli.attack --randla_dataset semantickitti`` refused
    for the xyz-only reason."""
    from pointsecguard_tpu_torch.cli import attack as cli_attack
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    prep = preps["semantickitti"]
    t0 = time.perf_counter()
    train = _outdoor_train("semantickitti", prep, records, OUTDOOR_TRAIN_EPOCHS, resume=False)
    sd = load_checkpoint(train["log"])
    floats = sum(t.numel() for t in sd.values())
    if sd["fc0.weight"].shape != (8, 3) or floats != KITTI_STATE_FLOATS:
        raise AssertionError(f"SemanticKITTI model: fc0 {tuple(sd['fc0.weight'].shape)}, "
                             f"{floats} floats")
    train["ms_per_step"] = _outdoor_step_ms("semantickitti", prep, train["log"], dev)
    train["host_share"] = 1.0 - train["ms_per_step"] / train["ms_per_step_host_clock"]
    print("semantickitti train: " + json.dumps({k: v for k, v in train.items() if k != "log"}))
    ev = _outdoor_eval("semantickitti", prep, train["log"], records)
    print(f"semantickitti eval (sub-cloud resolution): {json.dumps(ev)}")
    try:
        cli_attack.main(["--model", "randla", "--randla_dataset", "semantickitti",
                         "--randla_dir", prep, "--log_dir", train["log"]])
    except SystemExit as refusal:
        if "xyz-only" not in str(refusal):
            raise AssertionError(f"cli.attack semantickitti stopped otherwise: {refusal}")
        print(f"semantickitti attack refused: {refusal}")
    else:
        raise AssertionError("cli.attack --randla_dataset semantickitti was not refused")
    print(f"phase 55: {time.perf_counter() - t0:.1f} s")
    return {"train": {k: v for k, v in train.items() if k != "log"}, "eval": ev}


# ModelNet classification (phases 56-59): a synthetic ModelNet of 2048-point
# shapes (the loader takes the first 1024, as of ModelNet40's 10k), the
# three classifiers at full width
CLS_POINTS, CLS_BATCH, CLS_TRAIN_BATCH = 1024, 16, 24
CLS_FILE_POINTS, CLS_TRAIN_PER_CLASS, CLS_TEST_PER_CLASS = 2048, 24, 8
CLS_MODELS = ("pointnet2_cls", "pointnet2_cls_msg", "pointnet_cls")
# (12 epochs until the script's wall neared its limit: instance accuracy
# 1.0 from the eval after epoch 8 on)
CLS_TRAIN_EPOCHS, CLS_EVAL_EVERY, CLS_TRAIN_LR = 8, 4, 0.003
# instance accuracy the trained classifiers must reach on the 32 test
# shapes of the 4-class fixture, set before the first run: twice chance
CLS_EVAL_ACC_FLOOR = 0.5
# kernel launches of one classifier forward: two FPS levels and the ball
# queries of k ≤ 48 (SSG: k = 32 at level 1, k = 64 takes the stable sort;
# MSG: k = 16, 32 at level 1 and 32 at level 2, k = 64 and 128 the sort)
CLS_LAUNCHES = {"pointnet2_cls": {"fps": 2, "bottom_k": 1},
                "pointnet2_cls_msg": {"fps": 2, "bottom_k": 3},
                "pointnet_cls": {"fps": 0, "bottom_k": 0}}
CLS_STATE_FLOATS = {"pointnet2_cls": 1_482_536, "pointnet2_cls_msg": 1_756_872,
                    "pointnet_cls": 3_483_761}  # 40 classes, normals
# phase 57's bounds, the card against the CPU's float64: log-probabilities
# over the largest and the xyz gradient in relative L2, in float32 and in
# float64. Set from this phase's readings on an H100 80GB HBM3 at 700 W:
# float32 log-probabilities 1.67e-6 / 1.95e-6 / 1.31e-5 and gradients
# 1.61e-3 / 2.37e-3 / 3.39e-3 (SSG / MSG / PointNet); float64 9.6e-8 /
# 9.3e-8 / 9.0e-8 and 1.7e-8 / 1.9e-8 / 1.4e-8, not 1e-12: the head's
# logits are float32 in a float64 model, as in JAX. The float64 bounds sit
# 3 and 4 decades below the float32 readings, so a float64 run that ran
# in float32 fails them
CLS_REFERENCE_BOUNDS = {
    "pointnet2_cls": ({"log_probs": 1e-5, "grad": 1e-2}, {"log_probs": 5e-7, "grad": 1e-7}),
    "pointnet2_cls_msg": ({"log_probs": 1e-5, "grad": 1e-2},
                          {"log_probs": 5e-7, "grad": 1e-7}),
    "pointnet_cls": ({"log_probs": 5e-5, "grad": 2e-2}, {"log_probs": 5e-7, "grad": 1e-7}),
}
CLS_NU_STEPS = 10  # the NU run cuts C&W's 200 steps to this
CLS_BENCH_BUDGET = {"nes": ["--samples", "16", "--iters", "10"],
                    "spsa": ["--samples", "16", "--iters", "10"],
                    "nattack": ["--samples", "16", "--iters", "20"],
                    "cw": ["--cw_steps", "50"]}


def cls_data() -> str:
    """The synthetic ModelNet of phases 56-59 (4 classes; 24 train and 8
    test shapes a class of 2048 points), written once."""
    from pointsecguard_tpu_torch.data.modelnet import make_synthetic_modelnet

    root = os.path.join(WORK, "modelnet")
    if not os.path.exists(os.path.join(root, "modelnet40_test.txt")):
        make_synthetic_modelnet(root, points_per_shape=CLS_FILE_POINTS,
                                train_per_class=CLS_TRAIN_PER_CLASS,
                                test_per_class=CLS_TEST_PER_CLASS, seed=0)
    return root


def cls_shapes(dev, n: int = CLS_BATCH, split: str = "test") -> torch.Tensor:
    """[n, 1024, 6] shapes of the fixture (every class), on ``dev``."""
    from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset

    ds = ModelNetDataset(cls_data(), split, num_point=CLS_POINTS)
    idx = np.arange(n) * len(ds) // n  # spread over the classes
    return torch.from_numpy(np.stack([ds.load(int(i))[0] for i in idx])).to(dev)


def cls_geometry_inputs(xyz: torch.Tensor, spec, starts):
    """The FPS and ball-query inputs of one classifier geometry (``spec``:
    ``CLS_SSG_SPEC`` or ``CLS_MSG_SPEC``) from the given starts: per level
    the cloud and its start, and per radius the index values with the
    sentinel N outside the radius, and the group size."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.ops.cuda import fps

    fps_in, bq_in, cur = [], [], xyz
    for (npoint, radii, nsamples), start in zip(spec, starts):
        n = cur.shape[1]
        fps_in.append((cur, npoint, start))
        centers = ops.gather_points(cur, fps.fps(cur, npoint, start))
        sqr = ops.square_distance(centers, cur)
        arange = torch.arange(n, dtype=torch.float32, device=cur.device)
        for radius, nsample in zip(radii, nsamples):
            bq_in.append((torch.where(sqr > radius * radius, float(n), arange), nsample))
        cur = centers
    return fps_in, bq_in


def phase_cls_kernels(dev, records) -> dict:
    """56. The kernels at the classifiers' shapes (a kernel phase): FPS of
    [16, 1024] → 512 and [16, 512] → 128 from index 0 (attack and eval)
    and of [24, 1024] / [24, 512] from random starts (a train step); the
    ball queries of SSG and MSG on bottom-k (k = 32 on [16, 512, 1024];
    MSG's k = 16 and 32 there and k = 32 on [16, 128, 512]); SOR's self-kNN
    of [16, 1024, 3] with k = 11 on the D = 3 kNN kernel. Each equal to its
    plain version; card, eager and plain ms, bound, share and
    ``torch.topk``'s ms for bottom-k. The ball queries of k = 64 and 128
    take the stable sort, as JAX sends them to ``lax.top_k``: timed beside
    the bottom-k kernel (equal indices) and ``torch.topk`` (equal values)
    as a ``selection`` record."""
    from pointsecguard_tpu_torch.models.pointnet2_cls import (
        CLS_MSG_SPEC, CLS_SSG_SPEC, build_geometry_cls, build_geometry_cls_msg,
    )
    from pointsecguard_tpu_torch.ops import knn as route_knn
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bounds, fps, knn
    from pointsecguard_tpu_torch.ops.selection import KERNEL_MAX_K

    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = cls_shapes(dev)
    xyz = shapes[..., :3].contiguous()
    train_xyz = cls_shapes(dev, CLS_TRAIN_BATCH, "train")[..., :3].contiguous()

    def rows_of(v):
        return v.numel() // v.shape[-1]

    sort_rows = []
    for key, x, spec, build, random_starts in (
            ("cls_attack", xyz, CLS_SSG_SPEC, build_geometry_cls, False),
            ("cls_msg_attack", xyz, CLS_MSG_SPEC, build_geometry_cls_msg, False),
            ("cls_train_step", train_xyz, CLS_SSG_SPEC, build_geometry_cls, True)):
        b = x.shape[0]
        starts = [torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
                  if random_starts else torch.zeros(b, dtype=torch.int32, device=dev)
                  for n in (x.shape[1], spec[0][0])]
        fps_in, bq_in = cls_geometry_inputs(x, spec, starts)
        geo = build(x, start_idx=starts)
        for li, (cur, npoint, st) in enumerate(fps_in):
            got = fps.fps(cur, npoint, st)
            if not torch.equal(got, fps.fps_plain(cur, npoint, st)):
                raise AssertionError(f"fps kernel != plain at {tuple(cur.shape)}->{npoint}")
            if not torch.equal(got, geo["fps"][li]):
                raise AssertionError(f"{key}: the geometry's FPS != the kernel's, level {li}")
        kernel_in, sort_in = [], []
        for j, (vals, k) in enumerate(bq_in):
            want = geo["sa"][j // len(spec[0][1])][1]
            want = want[j % len(spec[0][1])] if isinstance(want, tuple) else want
            if k <= KERNEL_MAX_K:
                gv, gi = bottomk.bottom_k(vals, k)
                wv, wi = bottomk.bottom_k_plain(vals, k)
                if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
                    raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
                if not torch.equal(topk_library(vals, k)[0], gv):
                    raise AssertionError(f"torch.topk values != bottom_k at {tuple(vals.shape)}")
                kernel_in.append((vals, k))
            else:
                gv, _ = bottomk.bottom_k_plain(vals, k)
                sort_in.append((vals, k))
            n = vals.shape[-1]
            g = gv.to(torch.int32)
            if not torch.equal(torch.where(g == n, g[..., :1], g), want):
                raise AssertionError(f"{key}: the geometry's groups != the route's ({j})")
        torch.cuda.synchronize()
        print(f"{key} [{b}, {x.shape[1]}]: fps at 2 levels and bottom_k on "
              f"{len(kernel_in)} ball queries equal to plain, the geometry's groups equal")

        def run_fps(f, fps_in=fps_in):
            return lambda: [f(cur, n, st) for cur, n, st in fps_in]

        def run_bk(f, kernel_in=kernel_in):
            return lambda: [f(v, k) for v, k in kernel_in]

        work = {
            "fps": bounds.total(bounds.fps(c.shape[0], c.shape[1], n) for c, n, _ in fps_in),
            "bottom_k": bounds.total(bounds.bottom_k(rows_of(v), v.shape[-1], k)
                                     for v, k in kernel_in),
        }
        unit = (f"one {'MSG' if spec is CLS_MSG_SPEC else 'SSG'} classifier geometry of "
                f"[{b}, {x.shape[1]}]" + (", random starts" if random_starts else ""))
        for name, kern, plain, fn in (("fps", fps.fps, fps.fps_plain, run_fps),
                                      ("bottom_k", bottomk.bottom_k, bottomk.bottom_k_plain,
                                       run_bk)):
            if name == "bottom_k" and random_starts:
                continue  # the train step's ball queries: the attack's shapes
            rec = {"unit": unit, "ms": device_ms(fn(kern)),
                   "eager_ms": cuda_ms(fn(kern), reps=20),
                   "plain_ms": cuda_ms(fn(plain), reps=5),
                   "bound_ms": work[name].bound_ms, "bound_by": work[name].bound_by,
                   "library_ms": device_ms(run_bk(topk_library)) if name == "bottom_k"
                   else None,
                   "calls": len(fps_in) if name == "fps" else len(kernel_in)}
            rec["share"] = rec["bound_ms"] / rec["ms"]
            print(f"{name} ({key}): kernel {rec['ms']:.4f} ms on the card "
                  f"({rec['eager_ms']:.4f} ms eager), plain {rec['plain_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; share {rec['share']:.3f}), "
                  f"library {rec['library_ms']} ms per {unit}")
            records[name][key] = rec
        for cur, n, st in fps_in:
            ms = device_ms(lambda: fps.fps(cur, n, st))
            print(f"  fps {tuple(cur.shape)} -> {n}: {ms:.4f} ms "
                  f"({1e6 * ms / (n - 1):.0f} ns per step)")
        for v, k in kernel_in:
            ms = device_ms(lambda: bottomk.bottom_k(v, k))
            print(f"  bottom_k {tuple(v.shape)} k={k}: {ms:.4f} ms (bound "
                  f"{bounds.bottom_k(rows_of(v), v.shape[-1], k).bound_ms:.4f} ms, library "
                  f"{device_ms(lambda: topk_library(v, k)):.4f} ms)")
        if not random_starts:
            for v, k in sort_in:
                vs, i_s = bottomk.bottom_k_plain(v, k)
                vb, i_b = bottomk.bottom_k(v, k)
                if not (torch.equal(i_b, i_s) and torch.equal(vb, vs)
                        and torch.equal(topk_library(v, k)[0], vs)):
                    raise AssertionError(f"large-k ball query k={k}: bottom_k or torch.topk "
                                         "!= the sort")
                sort_rows.append({
                    "geometry": key, "shape": list(v.shape), "k": k,
                    "sort_ms": device_ms(lambda: bottomk.bottom_k_plain(v, k), reps=5),
                    "bottom_k_ms": device_ms(lambda: bottomk.bottom_k(v, k), reps=5),
                    "topk_ms": device_ms(lambda: topk_library(v, k), reps=5),
                    "bottom_k_bound_ms": bounds.bottom_k(rows_of(v), v.shape[-1], k).bound_ms})

    # SOR's self-kNN: k + 1 = 11 neighbours of each of [16, 1024] points
    gv, gi = knn.knn(xyz, xyz, 11)
    wv, wi = knn.knn_plain(xyz, xyz, 11)
    if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
        raise AssertionError("knn kernel != plain at SOR's [16, 1024, 3] k=11")
    if not torch.equal(route_knn(xyz, xyz, 11)[1], gi):
        raise AssertionError("the kNN route != the kernel at SOR's shape")
    w = bounds.knn(xyz.shape[0], xyz.shape[1], xyz.shape[1], 3, 11)
    rec = {"unit": f"SOR's self-kNN of [{CLS_BATCH}, {CLS_POINTS}, 3], k = 11",
           "ms": device_ms(lambda: knn.knn(xyz, xyz, 11)),
           "eager_ms": cuda_ms(lambda: knn.knn(xyz, xyz, 11), reps=20),
           "plain_ms": cuda_ms(lambda: knn.knn_plain(xyz, xyz, 11), reps=5),
           "bound_ms": w.bound_ms, "bound_by": w.bound_by, "library_ms": None}
    rec["share"] = rec["bound_ms"] / rec["ms"]
    records["knn"]["sor"] = rec
    print(f"knn (SOR): kernel {rec['ms']:.4f} ms ({rec['eager_ms']:.4f} eager), plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; share "
          f"{rec['share']:.3f}); indices and distances equal to plain")
    sums = {key: sum(r[key] for r in sort_rows) for key in ("sort_ms", "bottom_k_ms", "topk_ms")}
    print("classifier large-k ball queries (k = 64, 128) a forward pair (SSG + MSG): "
          + json.dumps(sums) + "; per call: " + json.dumps(sort_rows))
    return {"name": "cls_large_k_selection",
            "route": "torch.sort (stable): bottom_k_plain, not a kernel of the port",
            "replaces": "pointsecguard_tpu/ops/selection.py:138-151 (lax.top_k, not a "
                        "Pallas kernel)",
            "timed_beside": ["bottom_k kernel", "torch.topk"],
            "per_forward_pair": sums, "per_call": sort_rows}


def cls_state_dict(model: str, seed: int, dev) -> dict:
    """Full-width weights of a classifier at 40 classes with normals, from
    ``init_parameters`` of a seeded generator (the flax initialisers), with
    BatchNorm statistics from one train-mode forward over 16 fixture shapes
    (keep fraction 0), so that the predictions vary from shape to shape."""
    from pointsecguard_tpu_torch.models import init_parameters
    from pointsecguard_tpu_torch.train.trainer import cls_model

    net, family = cls_model(model, 40)
    init_parameters(net, torch.Generator().manual_seed(seed))
    n = sum(t.numel() for t in net.state_dict().values())
    if n != CLS_STATE_FLOATS[model]:
        raise AssertionError(f"{model} holds {n} floats, want {CLS_STATE_FLOATS[model]}")
    net.to(dev).train()
    with torch.no_grad():
        pts = cls_shapes(dev)
        family.apply(net, pts, family.plan(pts), 1.0,
                     generator=torch.Generator(device=dev).manual_seed(0))
    return net.state_dict()


def phase_cls_reference(dev, model: str) -> dict:
    """57. Card vs CPU for a classifier at 40 classes, calibrated seeded
    weights, on 8 × 1024 × 6 fixture shapes (16 until the part-seg phases
    came; the CPU's float64 runs are most of the phase): the geometry built on both
    (FPS equal, group indices in agreement), then, on the card's indices
    with the centres regathered from the leaf (the coordinate attacks'
    moving geometry), the log-probabilities and the xyz gradient of the
    summed NLL of random labels on the card and on the CPU, each in float32
    and in float64, against the CPU's float64."""
    from pointsecguard_tpu_torch.models.pointnet2_cls import regather
    from pointsecguard_tpu_torch.train.trainer import cls_model

    net, _ = cls_model(model, 40)
    net.load_state_dict(cls_state_dict(model, 1, dev))
    net.eval()
    pts = cls_shapes(dev, CLS_BATCH // 2)
    build = getattr(net, "build_geometry", None)
    geo, agree = None, [1.0]
    if build is not None:
        geo = build(pts[..., :3])
        geo_cpu = build(pts[..., :3].cpu())
        for li in range(2):
            if not torch.equal(geo["fps"][li].cpu(), geo_cpu["fps"][li]):
                raise AssertionError(f"{model}: FPS differs card vs CPU at level {li}")
        agree = []
        for (_, g), (_, c) in zip(geo["sa"], geo_cpu["sa"]):
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            c if isinstance(c, tuple) else (c,)):
                agree.append((a.cpu() == b).float().mean().item())
        if min(agree) < 0.999:
            raise AssertionError(f"{model}: card/CPU group agreement {min(agree)} < 0.999")
    labels = torch.randint(0, 40, (pts.shape[0],), generator=torch.Generator().manual_seed(5))
    out = {}
    cpu = torch.device("cpu")
    for name, device, dtype in (("card", dev, torch.float32), ("card64", dev, torch.float64),
                                ("cpu", cpu, torch.float32), ("float64", cpu, torch.float64)):
        m = net.to(device=device, dtype=dtype)
        p = pts.to(device=device, dtype=dtype).clone().requires_grad_(True)
        plan = None if geo is None else regather(_to_device(geo, device, dtype), p[..., :3])
        lp = m(p) if plan is None else m(p, geometry=plan)
        lp = lp[0]
        (-torch.gather(lp, 1, labels.to(device)[:, None]).sum()).backward()
        out[name] = (lp.detach().double().cpu(), p.grad[..., :3].double().cpu())
    ref_lp, ref_grad = out["float64"]
    scale = ref_lp.abs().max().item()
    err = {n: (out[n][0] - ref_lp).abs().max().item() / scale for n in ("card", "card64", "cpu")}
    gerr = {n: _rel_l2(out[n][1], ref_grad) for n in ("card", "card64", "cpu")}
    res = {"group_agreement_min": min(agree), "largest_log_prob": scale,
           "log_probs_card_vs_cpu_over_largest":
               (out["card"][0] - out["cpu"][0]).abs().max().item() / scale,
           "log_probs_vs_cpu_float64_over_largest": err,
           "xyz_grad_card_vs_cpu_rel_l2": _rel_l2(out["card"][1], out["cpu"][1]),
           "xyz_grad_vs_cpu_float64_rel_l2": gerr,
           "pred_spread": int(torch.unique(ref_lp.argmax(1)).numel())}
    print(f"{model} card vs CPU: " + json.dumps(res))
    bound32, bound64 = CLS_REFERENCE_BOUNDS[model]
    ok = (torch.isfinite(out["card"][0]).all() and out["card"][0].shape == (len(pts), 40)
          and err["card64"] <= bound64["log_probs"] and gerr["card64"] <= bound64["grad"]
          and err["card"] <= bound32["log_probs"] and gerr["card"] <= bound32["grad"]
          and res["pred_spread"] > 1)
    if not ok:
        raise AssertionError(f"the card's {model} disagrees with the CPU's")
    return res


def _cls_counts_check(model: str, counts: dict, forwards: int, what: str) -> None:
    """Exactly ``CLS_LAUNCHES[model]`` FPS and bottom-k launches a forward,
    ``forwards`` forwards, and no kNN."""
    want = {k: n * forwards for k, n in CLS_LAUNCHES[model].items()}
    got = {k: counts[k] for k in want}
    if got != want or counts["knn"]:
        raise AssertionError(f"{model} {what}: launches {counts}, want {want} "
                             f"({forwards} forwards)")


def phase_cls_train_eval(dev, records, model: str, normals: bool = True,
                         epochs: int = CLS_TRAIN_EPOCHS, eval_every: int = CLS_EVAL_EVERY,
                         lr: float = CLS_TRAIN_LR) -> tuple[str, dict]:
    """58 (first part). ``cli.train`` of a classifier at full width on the
    fixture (24 a batch, 4 steps an epoch, an eval every 4 epochs and
    after the last, lr 3e-3), then ``cli.eval --num_votes 1`` (instance
    accuracy at or above ``CLS_EVAL_ACC_FLOOR``, the trainer's figure):
    one geometry's launches a train step and an eval batch, ms a step.
    ``normals=False`` trains on xyz alone (``--no_normals``) into a log
    dir of its own, for the attacks' efficacy check; its launches are
    checked, not recorded by path."""
    from pointsecguard_tpu_torch.cli import eval as cli_eval
    from pointsecguard_tpu_torch.cli import train as cli_train
    from pointsecguard_tpu_torch.ops import cuda as kernels

    data = cls_data()
    xyz_only = [] if normals else ["--no_normals"]
    log = os.path.join(WORK, f"cls_log_{model}" + ("" if normals else "_xyz"))
    steps = CLS_TRAIN_PER_CLASS * 4 // CLS_TRAIN_BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, best = cli_train.main(["--model", model, "--data_root", data, "--log_dir", log,
                              "--batch_size", str(CLS_TRAIN_BATCH), "--epochs", str(epochs),
                              "--eval_every", str(eval_every), "--learning_rate", str(lr),
                              *xyz_only])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    events = read_events(log)
    n_epochs = epochs
    epochs = [e for e in events if e["event"] == "epoch"]
    evals = [e for e in events if e["event"] == "eval"]
    eval_batches = -(-CLS_TEST_PER_CLASS * 4 // CLS_TRAIN_BATCH)
    if [e["epoch"] for e in epochs] != list(range(n_epochs)) or any(
            e["batches"] != steps or e["nan_batches"] or not math.isfinite(e["loss"])
            for e in epochs):
        raise AssertionError(f"{model} train epochs: {epochs}")
    forwards = steps * n_epochs + len(evals) * eval_batches
    _cls_counts_check(model, counts, forwards, "train")
    warm = epochs[1:]
    stats = {"steps": steps * n_epochs, "epoch_loss": [e["loss"] for e in epochs],
             "eval_instance_accuracy": [e["instance_accuracy"] for e in evals],
             "best": best, "main_wall_s": wall, "launches": counts,
             "ms_per_step_host_clock": 1e3 * sum(e["seconds"] for e in warm)
             / sum(e["batches"] for e in warm)}
    kernels.reset_launch_counts()
    inst, cls_acc = cli_eval.main(["--model", model, "--data_root", data, "--log_dir", log,
                                   "--num_votes", "1", *xyz_only])
    eval_counts = kernels.launch_counts()
    _cls_counts_check(model, eval_counts, -(-CLS_TEST_PER_CLASS * 4 // CLS_BATCH), "eval")
    stats.update(eval_instance_accuracy_cli=inst, eval_class_accuracy_cli=cls_acc,
                 eval_launches=eval_counts)
    print(f"{model}{'' if normals else ' --no_normals'} train + eval: " + json.dumps(stats))
    if not epochs[-1]["loss"] < epochs[0]["loss"]:
        raise AssertionError(f"{model}: the loss did not fall")
    if abs(inst - evals[-1]["instance_accuracy"]) > 1e-9:
        raise AssertionError(f"{model}: cli.eval {inst} != the trainer's {evals[-1]}")
    if inst < CLS_EVAL_ACC_FLOOR:
        raise AssertionError(f"{model}: instance accuracy {inst} under {CLS_EVAL_ACC_FLOOR}")
    for name, per in CLS_LAUNCHES[model].items():
        if per and normals:
            records[name]["launches_by_path"][f"{model} train"] = counts[name]
            records[name]["launches_by_path"][f"{model} eval"] = eval_counts[name]
            records[name]["calls_per_batch"][f"{model} train step"] = per
            records[name]["calls_per_batch"][f"{model} eval batch"] = per
    return log, stats


# (path name, flags, shapes): the attack_object runs of phase 58
CLS_ATTACKS = (
    ("nb", ["--attack", "nb"], 2 * CLS_BATCH),
    ("nb --fixed_geometry", ["--attack", "nb", "--fixed_geometry"], 2 * CLS_BATCH),
    ("nu", ["--attack", "nu", "--steps", str(CLS_NU_STEPS)], CLS_BATCH),
    ("tar_nb", ["--attack", "tar_nb", "--target", "1"], CLS_BATCH),
    ("random", ["--attack", "random", "--noise_norm", "1.0"], CLS_BATCH),
    ("nb --control", ["--attack", "nb", "--control"], CLS_BATCH),
    ("nb --defense sor", ["--attack", "nb", "--defense", "sor"], CLS_BATCH),
    ("nb --defense srs --eot 2", ["--attack", "nb", "--defense", "srs", "--eot", "2"],
     CLS_BATCH),
    # the efficacy check, on the SSG trained on xyz alone: the fixture's
    # normals name its four primitives (a disk's all point up), and a
    # coordinate attack never moves them, so on the model with normals NB
    # moved no decision even at ε = 0.3 (accuracy 1.0 → 1.0, L2 9.99, on
    # an H100). On xyz alone NB must fall below clean and below its
    # equal-norm control
    ("nb --no_normals --control", ["--attack", "nb", "--no_normals", "--control"], CLS_BATCH),
)


def phase_cls_attacks(records, log: str, log_xyz: str) -> dict:
    """58 (second part). ``cli.attack_object`` on the trained SSG, each run
    on 16 shapes a batch (NB and NB --fixed_geometry on two batches, the
    second one warm): ms a batch, the launches of each kernel by path,
    accuracy clean / adversarial / control. NB with the moving geometry:
    53 forwards a batch (clean, 50 steps, the engine's last, the
    adversarial), so 106 FPS and 53 bottom-k launches; with
    ``--fixed_geometry`` one geometry a batch; SOR one kNN a forward."""
    from pointsecguard_tpu_torch.cli import attack_object as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    runs = {}
    for path, flags, shapes in CLS_ATTACKS:
        kernels.reset_launch_counts()
        out = cli.main(["--model", "pointnet2_cls", "--data_root", cls_data(), "--log_dir",
                        log_xyz if "--no_normals" in flags else log,
                        "--max_shapes", str(shapes), *flags])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        batches = shapes // CLS_BATCH
        stats = {"shapes": shapes, "ms_per_batch": out["batch_ms"],
                 "clean_acc": out["clean_acc"], "adv_acc": out["adv_acc"],
                 "rand_acc": out["rand_acc"], "l2_mean": out["l2_mean"], "launches": counts}
        print(f"pointnet2_cls {path}: " + json.dumps(stats))
        if counts["fps"] <= 0 or counts["fps"] != 2 * counts["bottom_k"]:
            raise AssertionError(f"{path}: launches {counts}")
        if path == "nb":
            _cls_counts_check("pointnet2_cls", counts, 53 * batches, path)
        if path == "nb --fixed_geometry":
            _cls_counts_check("pointnet2_cls", counts, batches, path)
        if path == "nb --defense sor" and counts["knn"] != counts["bottom_k"]:
            raise AssertionError(f"{path}: one kNN a forward, got {counts}")
        if not all(math.isfinite(v) for v in (out["clean_acc"], out["adv_acc"],
                                             out["l2_mean"])):
            raise AssertionError(f"{path}: a non-finite result")
        if path.startswith("nb") and not out["adv_acc"] <= out["clean_acc"]:
            raise AssertionError(f"{path}: adversarial accuracy above clean")
        for name in ("fps", "bottom_k") + (("knn",) if "sor" in path else ()):
            records[name]["launches_by_path"][f"pointnet2_cls {path}"] = counts[name]
        runs[path] = stats
    nb, fixed = runs["nb"], runs["nb --fixed_geometry"]
    xyz = runs["nb --no_normals --control"]
    if not xyz["adv_acc"] < min(xyz["clean_acc"], xyz["rand_acc"]):
        raise AssertionError("NB did not lower the xyz-only classifier's accuracy below "
                             "clean and below its equal-norm control")
    for name, per in CLS_LAUNCHES["pointnet2_cls"].items():
        records[name]["calls_per_batch"]["pointnet2_cls nb (moving geometry)"] = 53 * per
        records[name]["calls_per_batch"]["pointnet2_cls nb --fixed_geometry"] = per
    print("pointnet2_cls NB ms a batch (warm, the second): moving geometry "
          f"{nb['ms_per_batch'][-1]:.1f}, fixed geometry {fixed['ms_per_batch'][-1]:.1f}")
    return runs


def phase_cls_benchmark(records, log: str) -> dict:
    """59. ``cli.benchmark --task cls --model pointnet2_cls --no_normals``
    on the SSG trained on xyz alone (on the model with normals no attack
    moved a decision and the decision attacks found no start, on an H100:
    the normals name the fixture's classes), one batch of 16 shapes
    a call: every registry name (C&W at 50
    steps, NES and SPSA 16 × 10, NAttack 16 × 20, the decision attacks'
    200 iterations after 20 random-search draws, DeepFool up to 50
    iterations of 4 backwards), then ``--mode distortion --attack_name
    boundary``: ms and forwards a batch, adversarial accuracy (BIM lowers
    it); two FPS and one bottom-k launch a forward (the geometry moves with
    the points; C&W one bottom-k more a step, its smooth term)."""
    from pointsecguard_tpu_torch.models import PointNet2ClsSSG

    base = ["--task", "cls", "--model", "pointnet2_cls", "--no_normals", "--data_root",
            cls_data(), "--log_dir", log, "--batch_size", str(CLS_BATCH), "--max_blocks",
            str(CLS_BATCH)]
    runs, total = {}, {"fps": 0, "bottom_k": 0}
    for name in ("fgsm", "bim", "pgd", "mim", "cw", "deepfool", "nes", "spsa", "nattack",
                 "boundary", "evolutionary"):
        r = _bench_cli([*base, "--mode", "attack", "--attack_name", name,
                        *CLS_BENCH_BUDGET.get(name, [])], PointNet2ClsSSG)
        acc, acc_adv, tot, succ, dist = r["out"]
        counts = r["launches"]
        # the distortion over the shapes the model classifies right: the
        # decision attacks walk a shape it already gets wrong without
        # bound (every candidate is adversarial), in JAX as here
        stats = {"ms_per_batch": 1e3 * r["harness_s"], "forwards_per_batch": r["forwards"],
                 "acc": float(acc.mean()), "adv_acc": float(acc_adv.mean()),
                 "succ": float(succ.sum() / max(tot.sum(), 1)),
                 "dist_mean_eligible": float(dist[tot].mean()) if tot.any() else 0.0,
                 "launches": counts}
        print(f"cls benchmark {name}: " + json.dumps(stats))
        if name == "cw":  # its smooth term selects on bottom-k once a step
            steps = r["forwards"] - 1
            if (counts["fps"], counts["bottom_k"]) != (2 * r["forwards"], r["forwards"] + steps):
                raise AssertionError(f"cls benchmark cw: launches {counts}")
        else:
            _cls_counts_check("pointnet2_cls", counts, r["forwards"], f"benchmark {name}")
        if not all(math.isfinite(v) for v in (stats["adv_acc"], stats["dist_mean_eligible"])):
            raise AssertionError(f"cls benchmark {name}: a non-finite result")
        if name == "bim" and not stats["adv_acc"] < stats["acc"]:
            raise AssertionError("cls benchmark bim did not lower the accuracy")
        runs[name] = stats
        for k in total:
            total[k] += counts[k]
    r = _bench_cli([*base, "--mode", "distortion", "--attack_name", "boundary"],
                   PointNet2ClsSSG)
    eps, details = r["out"]
    runs["distortion boundary"] = {"ms": 1e3 * r["main_wall_s"], "forwards": r["forwards"],
                                   "mean_successful_distortion": eps,
                                   "successes": int(sum(details["success"])),
                                   "launches": r["launches"]}
    print("cls benchmark --mode distortion boundary: " + json.dumps(runs["distortion boundary"]))
    _cls_counts_check("pointnet2_cls", r["launches"], r["forwards"], "distortion")
    for k, v in total.items():
        records[k]["launches_by_path"]["pointnet2_cls benchmark"] = v
        records[k]["calls_per_batch"]["pointnet2_cls benchmark (a forward)"] = \
            CLS_LAUNCHES["pointnet2_cls"][k]
    print("cls benchmark ms/batch: " + json.dumps(
        {k: round(v["ms_per_batch"], 3) for k, v in runs.items() if "ms_per_batch" in v}))
    print("cls benchmark forwards/batch: " + json.dumps(
        {k: v["forwards_per_batch"] for k, v in runs.items() if "forwards_per_batch" in v}))
    return runs


def phase_cls_deepfool_k40(dev) -> dict:
    """59 (second part). DeepFool at ModelNet40's K = 40: one forward and
    40 backwards an iteration, on the SSG with phase 57's calibrated
    40-class weights, 16 × 1024 × 6 fixture shapes labelled with the
    model's own clean predictions (so each shape must cross a boundary),
    at the engine's defaults (50 iterations, overshoot 0.02, xyz). The
    attack's ms a batch on the host's clock (synchronised), its iterations,
    forwards and backwards, and the launches (two FPS and one bottom-k a
    forward: the geometry moves with the points); then one iteration (a
    forward and its backwards) by CUDA events with 40 backwards and with 4
    (phase 59's fixture classes), same weights and inputs."""
    from pointsecguard_tpu_torch.attacks.deepfool import DeepFoolConfig, deepfool_attack
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.train.trainer import cls_model

    classes = 40
    net, _ = cls_model("pointnet2_cls", classes)
    net.load_state_dict(cls_state_dict("pointnet2_cls", 1, dev))
    net.to(dev).eval()
    forwards = [0]

    def outputs_fn(p):
        forwards[0] += 1
        return net(p)[0][:, None, :]

    pts = cls_shapes(dev)
    with torch.no_grad():
        labels = net(pts)[0].argmax(1)[:, None]
    forwards[0] = 0
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = deepfool_attack(outputs_fn, pts, labels, DeepFoolConfig())
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    iters = int(res.steps)
    _cls_counts_check("pointnet2_cls", counts, forwards[0], "deepfool K = 40")
    if forwards[0] != iters + 1:
        raise AssertionError(f"deepfool K = 40: {forwards[0]} forwards for {iters} iterations")

    def iteration(k: int):
        leaf = pts[..., :3].clone().requires_grad_(True)
        logits = net(torch.cat([leaf, pts[..., 3:]], -1))[0]
        for c in range(k):
            torch.autograd.grad(logits[:, c].sum(), leaf, retain_graph=c < k - 1)

    iter_ms = {k: cuda_ms(lambda: iteration(k), reps=3, warmup=1) for k in (classes, 4)}
    stats = {"classes": classes, "shapes": CLS_BATCH, "ms_per_batch": ms,
             "iterations": iters, "forwards": forwards[0], "backwards": classes * iters,
             "backwards_per_iteration": classes,
             "ms_per_iteration_40_backwards": iter_ms[classes],
             "ms_per_iteration_4_backwards": iter_ms[4],
             "adv_acc_vs_clean_pred": float(res.acc), "l2_mean": float(res.l2_dist.mean()),
             "launches": counts}
    print("deepfool K = 40: " + json.dumps(stats))
    if not (iters >= 1 and math.isfinite(stats["l2_mean"])
            and bool(torch.isfinite(res.points_adv).all()) and stats["adv_acc_vs_clean_pred"] < 1):
        raise AssertionError("deepfool K = 40: no decision moved, or a non-finite result")
    return stats


def run_cls_phases(dev, records) -> dict:
    """Phases 57-59 (56 runs with the kernel phases); the trained logs."""
    t0 = time.perf_counter()
    for model in CLS_MODELS:
        phase_cls_reference(dev, model)
    print(f"phase 57: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    logs = {model: phase_cls_train_eval(dev, records, model)[0] for model in CLS_MODELS}
    # xyz alone is the harder task: at 12 epochs and lr
    # 3e-3 its loss swung 0.006 – 0.24 and eval reached 0.34 on an H100;
    # 24 epochs at the JAX CLI's default lr 1e-3 here
    log_xyz, _ = phase_cls_train_eval(dev, records, "pointnet2_cls", normals=False,
                                      epochs=24, eval_every=8, lr=0.001)
    phase_cls_attacks(records, logs["pointnet2_cls"], log_xyz)
    print(f"phase 58: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_cls_benchmark(records, log_xyz)
    phase_cls_deepfool_k40(dev)
    print(f"phase 59: {time.perf_counter() - t0:.1f} s")
    return logs


# ShapeNetPart part segmentation (phases 60-63): a synthetic ShapeNetPart of
# 2500-point shapes in three categories (the loader draws 2048 a shape with
# replacement), the three part-seg nets at full width (50 parts, the
# 16-category one-hot, normals): 21 train, 1 val and 3 test shapes a category
PS_POINTS, PS_BATCH, PS_TRAIN_BATCH = 2048, 8, 16
PS_FILE_POINTS, PS_TRAIN_PER_CLASS, PS_VAL_PER_CLASS, PS_TEST_PER_CLASS = 2500, 21, 1, 3
PS_MODELS = ("pointnet2_part_seg", "pointnet2_part_seg_msg", "pointnet_part_seg")
PS_TRAIN_EPOCHS, PS_EVAL_EVERY, PS_TRAIN_LR = 10, 5, 0.003
# instance mIoU the trained nets must reach on the 9 test shapes, set before
# the first run: the argmax over a category's 2 or 3 parts scores ~0.24 at
# random, and the JAX CLI test holds its fixture to 0.25
PS_MIOU_FLOOR = 0.4
# kernel launches of one part-seg forward: two FPS levels, the k = 32 ball
# query (MSG: its first radius; k = 64 and 128 take the stable sort) and
# the two 3-NN hops
PS_LAUNCHES = {"pointnet2_part_seg": {"fps": 2, "bottom_k": 3},
               "pointnet2_part_seg_msg": {"fps": 2, "bottom_k": 3},
               "pointnet_part_seg": {"fps": 0, "bottom_k": 0}}
PS_STATE_FLOATS = {"pointnet2_part_seg": 1_419_762, "pointnet2_part_seg_msg": 1_751_494,
                   "pointnet_part_seg": 8_357_755}
PS_NU_STEPS = 10  # the NU run cuts C&W's 200 steps to this
# phase 61's bounds against the CPU's float64, in float32 and in float64:
# log-probabilities over the largest, the xyz gradient in relative L2.
# Set before the first run on the card. Both packages compute d² for the
# 3-NN weights in float32 (the float64 model rounds a float64 cross term
# once), and a dense point that is a centre has d² ≈ 0 up to that rounding
# beside the weights' 1e-8: the float32 model's log-probabilities sat
# 6.4e-5 from float64 and its gradient 3.8e-3 on the CPU at 8 × 512 points
# (7.9e-6 on a plan with the weights held fixed)
PS_REFERENCE_BOUNDS = ({"log_probs": 1e-3, "grad": 2e-2}, {"log_probs": 2e-6, "grad": 1e-5})


def partseg_data() -> str:
    """The synthetic ShapeNetPart of phases 60-63, written once."""
    from pointsecguard_tpu_torch.data.shapenet_part import make_synthetic_shapenetpart

    root = os.path.join(WORK, "shapenetpart")
    if not os.path.exists(os.path.join(root, "synsetoffset2category.txt")):
        make_synthetic_shapenetpart(root, points_per_shape=PS_FILE_POINTS,
                                    train_per_class=PS_TRAIN_PER_CLASS,
                                    val_per_class=PS_VAL_PER_CLASS,
                                    test_per_class=PS_TEST_PER_CLASS, seed=0)
    return root


def partseg_batch(dev, n: int = PS_BATCH, split: str = "test"):
    """(points [n, 2048, 6], one-hot [n, 16], part labels [n, 2048]) on
    ``dev``: the first ``n`` shapes of ``split`` as evaluation loads them
    (test), or resampled from a seeded generator (trainval)."""
    from pointsecguard_tpu_torch.data.shapenet_part import ShapeNetPartDataset

    ds = ShapeNetPartDataset(partseg_data(), split, num_point=PS_POINTS)
    rng = None if split == "test" else np.random.default_rng(1)
    loaded = [ds.load(i, rng) for i in range(n)]
    pts = torch.from_numpy(np.stack([l[0] for l in loaded])).to(dev)
    onehot = torch.from_numpy(np.eye(16, dtype=np.float32)[[l[1] for l in loaded]]).to(dev)
    seg = torch.from_numpy(np.stack([l[2] for l in loaded]).astype(np.int64)).to(dev)
    return pts, onehot, seg


def kernel_row(name: str, unit: str, kern, plain, work, calls: int, library=None) -> dict:
    """A kernel's record at one shape: card and eager ms of ``kern()``,
    plain ms, bound, share and the library call's ms (``library()``)."""
    rec = {"unit": unit, "ms": device_ms(kern), "eager_ms": cuda_ms(kern, reps=20),
           "plain_ms": cuda_ms(plain, reps=5), "bound_ms": work.bound_ms,
           "bound_by": work.bound_by,
           "library_ms": None if library is None else device_ms(library),
           "calls_per_batch": calls}
    rec["share"] = rec["bound_ms"] / rec["ms"]
    print(f"{name}: kernel {rec['ms']:.4f} ms on the card ({rec['eager_ms']:.4f} ms eager), "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
          f"share {rec['share']:.3f}), library {rec['library_ms']} ms per {unit}")
    return rec


def phase_partseg_kernels(dev, records) -> dict:
    """60. The kernels at the part-seg nets' shapes (a kernel phase): FPS of
    one attack geometry ([8, 2048] → 512, [8, 512] → 128 from index 0) and
    of one train geometry ([16, 2048], random starts); the k = 32 ball
    query on [8, 512, 2048] (SSG's, and MSG's first radius); the 3-NN hops
    l0 ← l1 ([8, 2048, 512]) and l1 ← l2 ([8, 512, 128]) at k = 3; SOR's
    self-kNN of [8, 2048, 3] at k = 11. Each equal to its plain version,
    the geometry's indices equal to the calls'; card, eager and plain ms,
    bound, share and ``torch.topk``'s ms for bottom-k. The ball queries of
    k = 64 and 128 (SSG's second level, MSG's) take the stable sort: timed
    beside the bottom-k kernel and ``torch.topk`` as a ``selection`` record."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models.pointnet2_cls import (
        PARTSEG_MSG_SPEC, PARTSEG_SSG_SPEC, build_geometry_partseg, build_geometry_partseg_msg,
    )
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bounds, fps, knn
    from pointsecguard_tpu_torch.ops.selection import KERNEL_MAX_K

    gen = torch.Generator(device=dev).manual_seed(12)
    xyz = partseg_batch(dev)[0][..., :3].contiguous()
    train_xyz = partseg_batch(dev, PS_TRAIN_BATCH, "trainval")[0][..., :3].contiguous()

    def equal_bottom_k(vals, k, what):
        gv, gi = bottomk.bottom_k(vals, k)
        wv, wi = bottomk.bottom_k_plain(vals, k)
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"bottom_k kernel != plain at {what} {tuple(vals.shape)} k={k}")
        if not torch.equal(topk_library(vals, k)[0], gv):
            raise AssertionError(f"torch.topk values != bottom_k at {what}")
        return gv, gi

    for key, x, random_starts in (("partseg_attack", xyz, False),
                                  ("partseg_train_step", train_xyz, True)):
        b = x.shape[0]
        starts = [torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
                  if random_starts else torch.zeros(b, dtype=torch.int32, device=dev)
                  for n in (x.shape[1], PARTSEG_SSG_SPEC[0][0])]
        fps_in, bq_in = cls_geometry_inputs(x, PARTSEG_SSG_SPEC, starts)
        geo = build_geometry_partseg(x, start_idx=starts)
        for li, (cur, npoint, st) in enumerate(fps_in):
            got = fps.fps(cur, npoint, st)
            if not torch.equal(got, fps.fps_plain(cur, npoint, st)):
                raise AssertionError(f"fps kernel != plain at {tuple(cur.shape)}->{npoint}")
            if not torch.equal(got, geo["fps"][li]):
                raise AssertionError(f"{key}: the geometry's FPS != the kernel's, level {li}")
        work = bounds.total(bounds.fps(c.shape[0], c.shape[1], n) for c, n, _ in fps_in)
        records["fps"][key] = kernel_row(
            f"fps ({key})", f"one part-seg geometry of [{b}, {PS_POINTS}]"
            + (", random starts" if random_starts else ""),
            lambda: [fps.fps(c, n, st) for c, n, st in fps_in],
            lambda: [fps.fps_plain(c, n, st) for c, n, st in fps_in], work, len(fps_in))
        if random_starts:
            continue
        vals, k = bq_in[0]
        # the ball query's values are the indices (N outside the radius)
        g = equal_bottom_k(vals, k, "the ball query")[0].to(torch.int32)
        n = vals.shape[-1]
        if not torch.equal(torch.where(g == n, g[..., :1], g), geo["sa"][0][1]):
            raise AssertionError("the geometry's ball-query groups != the kernel's")
        records["bottom_k"]["partseg_ball_query"] = kernel_row(
            "bottom_k (part-seg ball query)", f"the k = {k} ball query of [{b}, 512, {n}]",
            lambda: bottomk.bottom_k(vals, k), lambda: bottomk.bottom_k_plain(vals, k),
            bounds.bottom_k(b * 512, n, k), 1, lambda: topk_library(vals, k))
        l1, l2 = geo["sa"][0][0], geo["sa"][1][0]
        for hop, (dst, src), (want_idx, want_w) in (("l0", (x, l1), geo["fp"][1]),
                                                    ("l1", (l1, l2), geo["fp"][0])):
            d = ops.square_distance(dst, src)
            if not torch.equal(equal_bottom_k(d, 3, f"3-NN {hop}")[1], want_idx):
                raise AssertionError(f"the geometry's 3-NN {hop} indices != the kernel's")
            if not torch.equal(ops.three_nn_weights(dst, src, want_idx), want_w):
                raise AssertionError(f"the geometry's 3-NN {hop} weights != the recomputed")
            rows, width = dst.shape[0] * dst.shape[1], d.shape[-1]
            records["bottom_k"][f"partseg_three_nn_{hop}"] = kernel_row(
                f"bottom_k (part-seg 3-NN {hop})",
                f"the 3-NN of {hop} ← {'l1' if hop == 'l0' else 'l2'}, "
                f"[{b}, {dst.shape[1]}, {width}] k = 3",
                lambda d=d: bottomk.bottom_k(d, 3), lambda d=d: bottomk.bottom_k_plain(d, 3),
                bounds.bottom_k(rows, width, 3), 1, lambda d=d: topk_library(d, 3))
    torch.cuda.synchronize()
    # MSG: its first radius's k = 32 groups on the kernel, the rest sorted
    starts = [torch.zeros(PS_BATCH, dtype=torch.int32, device=dev)] * 2
    msg_geo = build_geometry_partseg_msg(xyz)
    sort_rows = []
    for spec, geo_sa, what in ((PARTSEG_SSG_SPEC, None, "ssg"),
                               (PARTSEG_MSG_SPEC, msg_geo["sa"], "msg")):
        _, bq_in = cls_geometry_inputs(xyz, spec, starts)
        for j, (vals, k) in enumerate(bq_in):
            if k <= KERNEL_MAX_K:
                g = equal_bottom_k(vals, k, f"{what} ball query")[0].to(torch.int32)
                n = vals.shape[-1]
                if geo_sa is not None and not torch.equal(torch.where(g == n, g[..., :1], g),
                                                          geo_sa[0][1][0]):
                    raise AssertionError("MSG's first groups != the kernel's")
                continue
            vs, i_s = bottomk.bottom_k_plain(vals, k)
            vb, i_b = bottomk.bottom_k(vals, k)
            if not (torch.equal(i_b, i_s) and torch.equal(vb, vs)
                    and torch.equal(topk_library(vals, k)[0], vs)):
                raise AssertionError(f"large-k ball query k={k}: bottom_k or torch.topk != "
                                     "the sort")
            sort_rows.append({
                "geometry": what, "shape": list(vals.shape), "k": k,
                "sort_ms": device_ms(lambda: bottomk.bottom_k_plain(vals, k), reps=5),
                "bottom_k_ms": device_ms(lambda: bottomk.bottom_k(vals, k), reps=5),
                "topk_ms": device_ms(lambda: topk_library(vals, k), reps=5),
                "bottom_k_bound_ms": bounds.bottom_k(
                    vals.numel() // vals.shape[-1], vals.shape[-1], k).bound_ms})
    # SOR's self-kNN: k + 1 = 11 neighbours of each of [8, 2048] points
    gv, gi = knn.knn(xyz, xyz, 11)
    wv, wi = knn.knn_plain(xyz, xyz, 11)
    if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
        raise AssertionError("knn kernel != plain at SOR's [8, 2048, 3] k=11")
    records["knn"]["partseg_sor"] = kernel_row(
        "knn (part-seg SOR)", f"SOR's self-kNN of [{PS_BATCH}, {PS_POINTS}, 3], k = 11",
        lambda: knn.knn(xyz, xyz, 11), lambda: knn.knn_plain(xyz, xyz, 11),
        bounds.knn(PS_BATCH, PS_POINTS, PS_POINTS, 3, 11), 1)
    sums = {key: sum(r[key] for r in sort_rows) for key in ("sort_ms", "bottom_k_ms", "topk_ms")}
    print("part-seg large-k ball queries (k = 64, 128) a forward pair (SSG + MSG): "
          + json.dumps(sums) + "; per call: " + json.dumps(sort_rows))
    return {"name": "partseg_large_k_selection",
            "route": "torch.sort (stable): bottom_k_plain, not a kernel of the port",
            "replaces": "pointsecguard_tpu/ops/selection.py:138-151 (lax.top_k, not a "
                        "Pallas kernel)",
            "timed_beside": ["bottom_k kernel", "torch.topk"],
            "per_forward_pair": sums, "per_call": sort_rows}


def partseg_state_dict(model: str, seed: int, dev) -> dict:
    """Full-width weights of a part-seg net from ``init_parameters`` of a
    seeded generator (the flax initialisers), BatchNorm statistics from one
    train-mode forward over the 8 test shapes (keep fraction 0), carried
    through the flax layout and back (``utils/convert.py``, the way the JAX
    package's weights arrive)."""
    from pointsecguard_tpu_torch.models import init_parameters
    from pointsecguard_tpu_torch.train.trainer import cls_model
    from pointsecguard_tpu_torch.utils.convert import (
        cls_from_jax_variables,
        cls_to_jax_variables,
    )

    net, family = cls_model(model, 50)
    init_parameters(net, torch.Generator().manual_seed(seed))
    n = sum(t.numel() for t in net.state_dict().values())
    if n != PS_STATE_FLOATS[model]:
        raise AssertionError(f"{model} holds {n} floats, want {PS_STATE_FLOATS[model]}")
    net.to(dev).train()
    pts, onehot, _ = partseg_batch(dev)
    packed = torch.cat([pts, onehot[:, None].expand(-1, PS_POINTS, -1)], -1)
    with torch.no_grad():
        family.apply(net, packed, family.plan(packed), 1.0,
                     generator=torch.Generator(device=dev).manual_seed(0))
    return cls_from_jax_variables(model, cls_to_jax_variables(model, net.state_dict()))


def pinned_moving_plan(plan: dict, xyz: torch.Tensor, detach_weights: bool = False) -> dict:
    """The moving geometry on ``plan``'s indices (FPS, groups, 3-NN): the
    centres regathered from ``xyz`` and the 3-NN weights recomputed from
    them (``three_nn_weights``), both carrying ``xyz``'s gradient, unless
    ``detach_weights``. Pinning the indices holds both devices to one
    function where their roundings could break a near-tie apart."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models.pointnet2_cls import regather

    geo = regather(plan, xyz)
    l1, l2 = geo["sa"][0][0], geo["sa"][1][0]
    fp = []
    for (idx, _), (dst, src) in zip(plan["fp"], ((l1, l2), (xyz, l1))):
        w = ops.three_nn_weights(dst, src, idx)
        fp.append((idx, w.detach() if detach_weights else w))
    return {**geo, "fp": tuple(fp)}


def phase_partseg_reference(dev, model: str) -> dict:
    """61. Card vs CPU for a part-seg net, seeded weights through the flax
    layout, on 4 test shapes of 2048 points (the CPU's float64 runs are
    most of the phase: 29.0 s at 8 on an H100's host): the geometry built on both
    (FPS equal, groups and 3-NN indices in agreement), then, on the card's
    indices with the centres and 3-NN weights recomputed from the leaf (the
    moving geometry), the log-probabilities and the xyz gradient of the NB
    loss (the mean NLL of the part labels) on the card and on the CPU, in
    float32 and float64, against the CPU's float64. The 3-NN weights' share
    of the card's gradient: its distance from the gradient on the same
    plan with the weights detached, which must not be zero."""
    from pointsecguard_tpu_torch.train.trainer import cls_model

    net, _ = cls_model(model, 50)
    net.load_state_dict(partseg_state_dict(model, 1, dev))
    net.eval()
    pts, onehot, seg = partseg_batch(dev, PS_BATCH // 2)
    build = getattr(net, "build_geometry", None)
    plan, agree = None, {}
    if build is not None:
        plan = build(pts[..., :3])
        plan_cpu = build(pts[..., :3].cpu())
        for li in range(2):
            if not torch.equal(plan["fps"][li].cpu(), plan_cpu["fps"][li]):
                raise AssertionError(f"{model}: FPS differs card vs CPU at level {li}")
        groups = [(a.cpu() == b).float().mean().item()
                  for (_, g), (_, c) in zip(plan["sa"], plan_cpu["sa"])
                  for a, b in zip(g if isinstance(g, tuple) else (g,),
                                  c if isinstance(c, tuple) else (c,))]
        nn3 = [(a[0].cpu() == b[0]).float().mean().item()
               for a, b in zip(plan["fp"], plan_cpu["fp"])]
        agree = {"group_agreement_min": min(groups), "three_nn_agreement_min": min(nn3)}
        if min(groups + nn3) < 0.999:
            raise AssertionError(f"{model}: card/CPU index agreement {agree} < 0.999")
    out = {}
    cpu = torch.device("cpu")

    def run(device, dtype, detach_weights=False):
        m = net.to(device=device, dtype=dtype)
        p = pts.to(device=device, dtype=dtype).clone().requires_grad_(True)
        oh = onehot.to(device=device, dtype=dtype)
        if plan is None:
            lp = m(p, oh)[0]
        else:
            lp = m(p, oh, geometry=pinned_moving_plan(_to_device(plan, device, dtype), p[..., :3],
                                                      detach_weights))[0]
        (-torch.gather(lp, -1, seg.to(device)[..., None]).mean()).backward()
        return lp.detach().double().cpu(), p.grad[..., :3].double().cpu()

    for name, device, dtype in (("card", dev, torch.float32), ("card64", dev, torch.float64),
                                ("cpu", cpu, torch.float32), ("float64", cpu, torch.float64)):
        out[name] = run(device, dtype)
    ref_lp, ref_grad = out["float64"]
    scale = ref_lp.abs().max().item()
    err = {n: (out[n][0] - ref_lp).abs().max().item() / scale for n in ("card", "card64", "cpu")}
    gerr = {n: _rel_l2(out[n][1], ref_grad) for n in ("card", "card64", "cpu")}
    res = {**agree, "largest_log_prob": scale,
           "log_probs_card_vs_cpu_over_largest":
               (out["card"][0] - out["cpu"][0]).abs().max().item() / scale,
           "log_probs_vs_cpu_float64_over_largest": err,
           "xyz_grad_card_vs_cpu_rel_l2": _rel_l2(out["card"][1], out["cpu"][1]),
           "xyz_grad_vs_cpu_float64_rel_l2": gerr,
           "pred_spread": int(torch.unique(ref_lp.argmax(-1)).numel())}
    if plan is not None:
        res["three_nn_weight_share_rel_l2"] = _rel_l2(run(dev, torch.float32, True)[1],
                                                      out["card"][1])
    print(f"{model} card vs CPU: " + json.dumps(res))
    bound32, bound64 = PS_REFERENCE_BOUNDS
    ok = (torch.isfinite(out["card"][0]).all() and out["card"][0].shape == (len(pts), PS_POINTS, 50)
          and err["card64"] <= bound64["log_probs"] and gerr["card64"] <= bound64["grad"]
          and err["card"] <= bound32["log_probs"] and gerr["card"] <= bound32["grad"]
          and res["pred_spread"] > 1)
    if not ok:
        raise AssertionError(f"the card's {model} disagrees with the CPU's")
    if plan is not None and not res["three_nn_weight_share_rel_l2"] > 1e-3:
        raise AssertionError(f"{model}: the 3-NN weights carry no share of the xyz gradient")
    return res


def _partseg_counts_check(model: str, counts: dict, forwards: int, what: str,
                          knn_per_forward: int = 0) -> None:
    """Exactly ``PS_LAUNCHES[model]`` FPS and bottom-k launches a forward,
    ``forwards`` forwards, and ``knn_per_forward`` kNN each."""
    want = {k: n * forwards for k, n in PS_LAUNCHES[model].items()}
    want["knn"] = knn_per_forward * forwards
    got = {k: counts[k] for k in want}
    if got != want or forwards <= 0:
        raise AssertionError(f"{model} {what}: launches {counts}, want {want} "
                             f"({forwards} forwards)")


def phase_partseg_train_eval(dev, records, model: str) -> tuple[str, dict]:
    """62. ``cli.train`` of a part-seg net at full width on the fixture (16 a
    batch, 4 steps an epoch, ``PS_TRAIN_EPOCHS`` epochs, an eval every
    ``PS_EVAL_EVERY`` and after the last, lr 3e-3), then ``cli.eval`` (the
    trainer's best figures, instance mIoU at or above ``PS_MIOU_FLOOR``):
    one geometry's launches a train step and an eval batch, ms a step."""
    from pointsecguard_tpu_torch.cli import eval as cli_eval
    from pointsecguard_tpu_torch.cli import train as cli_train
    from pointsecguard_tpu_torch.ops import cuda as kernels

    data = partseg_data()
    log = os.path.join(WORK, f"partseg_log_{model}")
    steps = 3 * (PS_TRAIN_PER_CLASS + PS_VAL_PER_CLASS) // PS_TRAIN_BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, best = cli_train.main(["--model", model, "--data_root", data, "--log_dir", log,
                              "--batch_size", str(PS_TRAIN_BATCH), "--epochs",
                              str(PS_TRAIN_EPOCHS), "--eval_every", str(PS_EVAL_EVERY),
                              "--learning_rate", str(PS_TRAIN_LR)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    events = read_events(log)
    epochs = [e for e in events if e["event"] == "epoch"]
    evals = [e for e in events if e["event"] == "eval"]
    if [e["epoch"] for e in epochs] != list(range(PS_TRAIN_EPOCHS)) or any(
            e["batches"] != steps or e["nan_batches"] or not math.isfinite(e["loss"])
            for e in epochs):
        raise AssertionError(f"{model} train epochs: {epochs}")
    test_batches = -(-3 * PS_TEST_PER_CLASS // PS_TRAIN_BATCH)
    _partseg_counts_check(model, counts, steps * PS_TRAIN_EPOCHS + len(evals) * test_batches,
                          "train")
    warm = epochs[1:]
    stats = {"steps": steps * PS_TRAIN_EPOCHS, "epoch_loss": [e["loss"] for e in epochs],
             "eval_instance_miou": [e["instance_miou"] for e in evals], "best": best,
             "main_wall_s": wall, "launches": counts,
             "ms_per_step_host_clock": 1e3 * sum(e["seconds"] for e in warm)
             / sum(e["batches"] for e in warm)}
    kernels.reset_launch_counts()
    m = cli_eval.main(["--model", model, "--data_root", data, "--log_dir", log])
    eval_counts = kernels.launch_counts()
    _partseg_counts_check(model, eval_counts, test_batches, "eval")
    stats.update(eval_cli={k: v for k, v in m.items() if k != "category_miou"},
                 eval_launches=eval_counts)
    print(f"{model} train + eval: " + json.dumps(stats))
    if not epochs[-1]["loss"] < epochs[0]["loss"]:
        raise AssertionError(f"{model}: the loss did not fall")
    if abs(m["instance_miou"] - best) > 1e-9:
        raise AssertionError(f"{model}: cli.eval {m['instance_miou']} != the trainer's best "
                             f"{best}")
    if m["instance_miou"] < PS_MIOU_FLOOR:
        raise AssertionError(f"{model}: instance mIoU {m['instance_miou']} under "
                             f"{PS_MIOU_FLOOR}")
    for name, per in PS_LAUNCHES[model].items():
        if per:
            records[name]["launches_by_path"][f"{model} train"] = counts[name]
            records[name]["launches_by_path"][f"{model} eval"] = eval_counts[name]
            records[name]["calls_per_batch"][f"{model} train step"] = per
            records[name]["calls_per_batch"][f"{model} eval batch"] = per
    return log, stats


# (model, path name, flags): the attack_object runs of phase 63, each on one
# batch of 8 test shapes
PS_ATTACKS = tuple((m, "nb --control", ["--attack", "nb", "--control"]) for m in PS_MODELS) + (
    ("pointnet2_part_seg", "tar_nb --origin --target",
     ["--attack", "tar_nb", "--origin", "47", "--target", "49"]),
    ("pointnet2_part_seg", "nu", ["--attack", "nu", "--steps", str(PS_NU_STEPS)]),
    ("pointnet2_part_seg", "nb --defense sor", ["--attack", "nb", "--defense", "sor"]),
)


def phase_partseg_attacks(records, logs: dict) -> dict:
    """63. ``cli.attack_object`` on the trained part-seg nets, one batch of
    8 test shapes a run: NB ``--control`` on each, then on the SSG tar_NB
    from the Table's part 47 to its part 49 (only part-47 points move), NU
    cut to ``PS_NU_STEPS`` steps and NB ``--defense sor``. ms a batch,
    forwards, the launches of each kernel by path (the geometry moves with
    the points: 2 FPS and 3 bottom-k a forward, SOR one kNN more), mIoU
    clean / adversarial / control."""
    from pointsecguard_tpu_torch import models
    from pointsecguard_tpu_torch.cli import attack_object as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    classes = {"pointnet2_part_seg": models.PointNet2PartSegSSG,
               "pointnet2_part_seg_msg": models.PointNet2PartSegMSG,
               "pointnet_part_seg": models.PointNetPartSeg}
    runs = {}
    for model, path, flags in PS_ATTACKS:
        forwards, real = [0], classes[model].forward

        def forward(self, *a, _real=real, **k):
            forwards[0] += 1
            return _real(self, *a, **k)

        classes[model].forward = forward
        kernels.reset_launch_counts()
        try:
            out = cli.main(["--model", model, "--data_root", partseg_data(), "--log_dir",
                            logs[model], "--max_shapes", str(PS_BATCH), *flags])
            torch.cuda.synchronize()
        finally:
            classes[model].forward = real
        counts = kernels.launch_counts()
        stats = {"ms_per_batch": out["batch_ms"], "forwards": forwards[0],
                 "clean_miou": out["clean_miou"], "adv_miou": out["adv_miou"],
                 "rand_miou": out["rand_miou"], "l2_mean": out["l2_mean"], "launches": counts}
        print(f"{model} {path}: " + json.dumps(stats))
        _partseg_counts_check(model, counts, forwards[0], path, int("sor" in path))
        if path == "nb --control" and forwards[0] != 54:
            raise AssertionError(f"{model} {path}: {forwards[0]} forwards, want 54 (clean, 50 "
                                 "steps, the engine's last, adversarial, control)")
        if not all(math.isfinite(v) for v in (out["clean_miou"], out["adv_miou"],
                                             out["l2_mean"])) or not out["l2_mean"] > 0:
            raise AssertionError(f"{model} {path}: a non-finite or null result")
        if path.startswith("nb") and not out["adv_miou"] < out["clean_miou"]:
            raise AssertionError(f"{model} {path}: adversarial mIoU not below clean")
        for name in ("fps", "bottom_k", "knn"):
            if counts[name]:
                records[name]["launches_by_path"][f"{model} {path}"] = counts[name]
                records[name]["calls_per_batch"][f"{model} {path}"] = counts[name]
        runs[f"{model} {path}"] = stats
    return runs


def run_partseg_phases(dev, records) -> dict:
    """Phases 61-63 (60 runs with the kernel phases); the trained logs."""
    t0 = time.perf_counter()
    for model in PS_MODELS:
        phase_partseg_reference(dev, model)
    print(f"phase 61: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    logs = {model: phase_partseg_train_eval(dev, records, model)[0] for model in PS_MODELS}
    print(f"phase 62: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_partseg_attacks(records, logs)
    print(f"phase 63: {time.perf_counter() - t0:.1f} s")
    return logs


# --- phases 64-68: the training extras ------------------------------------------------

DS_ROOM_POINTS = 2_500_096  # the largest S3DIS room's count: the widest sampler window
DS_CHECK_BLOCKS = 8  # card vs CPU on the large room: a batch of 8
# phase 65's eval mIoU range: the device-sampled run's within this much of
# the host run's, or within half the host run's figure if that is larger
DS_MIOU_SLACK = 0.1
DS_EPOCHS = 2  # phase 65's epochs a run (13 steps each)
ADV_ITERS, ADV_RANDLA_STEPS = 5, 4
REMAT_LR = 1e-3


def _record_path(records, kernel: str, path: str, launches: int, step: str | None = None,
                 per: int | None = None) -> None:
    records[kernel].setdefault("launches_by_path", {})[path] = launches
    if step is not None:
        records[kernel].setdefault("calls_per_batch", {})[step] = per


def _cli_run(main, argv: list) -> tuple:
    """``main(argv)`` with the launch counters reset before it: (result,
    launch counts, peak device memory in GB, wall s)."""
    from pointsecguard_tpu_torch.ops import cuda as kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    return (out, kernels.launch_counts(), torch.cuda.max_memory_allocated() / 1e9,
            time.perf_counter() - t0)


def _train_cli(argv: list) -> tuple:
    """``_cli_run`` of ``cli.train.main``."""
    from pointsecguard_tpu_torch.cli import train as cli

    return _cli_run(cli.main, argv)


def _epoch_figures(log: str, batch: int, steps: int) -> dict:
    """The epochs of ``log``'s events: ``steps`` steps each, every loss finite,
    none skipped; ms a step and blocks (clouds) a second on the host's clock
    (an epoch's line is written before its eval, so its seconds are training
    alone)."""
    epochs = [e for e in read_events(log) if e["event"] == "epoch"]
    if (not epochs or any(e["nan_batches"] or e["batches"] != steps
                          or not math.isfinite(e["loss"]) for e in epochs)):
        raise AssertionError(f"{log}: want {steps} steps an epoch, finite, none skipped: "
                             f"{epochs}")
    host_ms = 1e3 * sum(e["seconds"] for e in epochs) / sum(e["batches"] for e in epochs)
    evals = [e for e in read_events(log) if e["event"] == "eval"]
    return {"epoch_loss": [e["loss"] for e in epochs], "steps": steps * len(epochs),
            "ms_per_step_host_clock": host_ms, "blocks_per_s": 1e3 * batch / host_ms,
            "ms_per_step_host_clock_by_epoch": [1e3 * e["seconds"] / e["batches"]
                                                for e in epochs],
            "eval_miou": [e["miou"] for e in evals]}


def phase_device_sampler(dev, train_data: str) -> dict:
    """64. The device sampler on the card against its CPU version on the
    card's draws: on phase 17's four rooms (a batch of 32) and on one
    synthetic room of 2,500,096 points (the largest S3DIS room's window, 8
    blocks), with and without replacement and the z-rotation: labels
    equal, features within 1e-6 (CUDA divides by a scalar through its
    reciprocal: a unit in the last place). ms a batch of
    32 × 4096 on the card by CUDA events, with and without
    ``--device_sampler_exact``, and the bytes staged."""
    from pointsecguard_tpu_torch.data import RoomSet, make_synthetic_rooms
    from pointsecguard_tpu_torch.data import device_sampler as ds

    big = os.path.join(WORK, "device_sampler_room")
    t0 = time.perf_counter()
    make_synthetic_rooms(big, points_per_room=DS_ROOM_POINTS, seed=0)
    out = {"large_room_setup_s": time.perf_counter() - t0}
    for name, root, check in (("rooms", train_data, TRAIN_BATCH),
                              ("large_room", big, DS_CHECK_BLOCKS)):
        rooms = RoomSet.load(root, "train", 5)
        t0 = time.perf_counter()
        staged, num_max = ds.stage_rooms(rooms, dev)
        torch.cuda.synchronize()
        rec = {"rooms": len(rooms.names), "points": int(staged.count.sum()),
               "num_max": num_max, "staged_bytes": staged.nbytes,
               "stage_s": time.perf_counter() - t0}
        cpu_staged = ds.StagedRooms(*(t.cpu() for t in staged))
        for exact in (False, True):
            for augment in (False, True):
                sample = ds.make_device_block_sampler(
                    batch_size=check, num_point=NUM_POINT, num_max=num_max,
                    augment_z=augment, replacement=not exact)
                draws = sample.draw(staged, torch.Generator(device=dev).manual_seed(7))
                f, lab = sample(staged, draws=draws)
                t0 = time.perf_counter()
                fc, lc = sample(cpu_staged, draws=ds.BlockDraws(
                    *(None if t is None else t.cpu() for t in draws)))
                err = (f.cpu() - fc).abs().max().item()
                key = "exact" if exact else "replacement"
                rec[f"{key}{'_rotated' if augment else ''}_max_abs_err"] = err
                rec[f"{key}{'_rotated' if augment else ''}_cpu_s"] = time.perf_counter() - t0
                if not torch.equal(lab.cpu(), lc) or err > 1e-6:
                    raise AssertionError(f"device sampler, {name}, {key}, rotation {augment}: "
                                         f"card vs CPU {err}")
            timed = ds.make_device_block_sampler(batch_size=TRAIN_BATCH, num_point=NUM_POINT,
                                                 num_max=num_max, replacement=not exact)
            gen = torch.Generator(device=dev).manual_seed(1)
            rec["ms_per_batch_exact" if exact else "ms_per_batch"] = cuda_ms(
                lambda: timed(staged, gen), reps=5)
        out[name] = rec
        del staged, cpu_staged
    print("device sampler (a batch of 32 x 4096): " + json.dumps(out))
    return out


def phase_device_sampler_train(dev, records, train_data: str) -> dict:
    """65. PointNet++ SSG through ``cli.train`` at 32 × 4096 on phase 17's
    rooms: ``DS_EPOCHS`` epochs on the host sampler, then as many with
    ``--device_sampler --steps_per_call 4``, an eval after the last. The
    same step count (13 an epoch),
    every loss finite, one geometry's launches (4 FPS, 8 bottom-k) a step
    and an eval batch; the device run's eval mIoU within
    ``DS_MIOU_SLACK`` of the host run's (or half of it). Blocks/s on the
    host's clock, ms a step by CUDA events (the host path's step on a
    batch on the card; the device path's sample + step), their ratio the
    host's share."""
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, WholeSceneBlocks
    from pointsecguard_tpu_torch.data import device_sampler as ds
    from pointsecguard_tpu_torch.models import weighted_nll_loss
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS, TrainState, make_train_step

    rooms = RoomSet.load(train_data, "train", 5)
    steps = -(-len(S3DISBlockSampler(rooms, num_point=NUM_POINT)) // TRAIN_BATCH)
    test_blocks = WholeSceneBlocks(RoomSet.load(train_data, "test", 5), block_points=NUM_POINT
                                   ).room_blocks(0, np.random.default_rng(0))[0].shape[0]
    eval_batches = -(-test_blocks // TRAIN_BATCH)
    out = {}
    for name, extra in (("host", []), ("device", ["--device_sampler", "--steps_per_call", "4"])):
        log = os.path.join(WORK, f"ds_train_{name}")
        _, counts, peak, wall = _train_cli([
            "--model", "pointnet2", "--data_root", train_data, "--log_dir", log,
            "--npoint", str(NUM_POINT), "--batch_size", str(TRAIN_BATCH),
            "--epochs", str(DS_EPOCHS), "--eval_every", str(DS_EPOCHS),
            "--learning_rate", str(TRAIN_LR), *extra])
        check_geometry_launches("pointnet2", counts, DS_EPOCHS * steps + eval_batches,
                                f"train {' '.join(extra) or '(host sampler)'}")
        out[name] = {**_epoch_figures(log, TRAIN_BATCH, steps), "peak_device_memory_gb": peak,
                     "main_wall_s": wall, "launches": counts}
        if name == "device":
            for kernel, per in GEOMETRY_LAUNCHES["pointnet2"].items():
                _record_path(records, kernel, "pointnet2 train --device_sampler", counts[kernel],
                             "pointnet2 device-sampled train step", per)

    # the step alone by CUDA events: host path on a batch on the card,
    # device path sampling its own
    net = POINTNET_MODELS["pointnet2"][0]()
    state = TrainState(net.to(dev))
    step = make_train_step(net, weighted_nll_loss, family=POINTNET_MODELS["pointnet2"][1])
    weights = torch.from_numpy(np.asarray(rooms.label_weights, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pts, labels = next(iter(S3DISBlockSampler(rooms, num_point=NUM_POINT).batches(
        np.random.default_rng(1), TRAIN_BATCH)))
    pts, labels = torch.from_numpy(pts).to(dev), torch.from_numpy(labels).to(dev)
    staged, num_max = ds.stage_rooms(rooms, dev)
    sample = ds.make_device_block_sampler(batch_size=TRAIN_BATCH, num_point=NUM_POINT,
                                          num_max=num_max)
    sampled = ds.make_sampled_multi_train_step(step, sample)
    host_step_ms = cuda_ms(lambda: step(state, pts, labels, weights, 1e-4, 0.1, gen), reps=5)
    device_step_ms = cuda_ms(lambda: sampled(state, staged, weights, 1e-4, 0.1, 1, gen), reps=5)
    out["host"].update(ms_per_step_cuda_events=host_step_ms,
                       host_share=1 - host_step_ms / out["host"]["ms_per_step_host_clock"])
    out["device"].update(ms_per_step_cuda_events=device_step_ms,
                         host_share=1 - device_step_ms / out["device"]["ms_per_step_host_clock"])
    out["blocks_per_s_ratio"] = out["device"]["blocks_per_s"] / out["host"]["blocks_per_s"]
    print("pointnet2 train, host vs device sampler: " + json.dumps(out))
    host_miou, dev_miou = out["host"]["eval_miou"][-1], out["device"]["eval_miou"][-1]
    if abs(dev_miou - host_miou) > max(DS_MIOU_SLACK, 0.5 * host_miou):
        raise AssertionError(f"device-sampled eval mIoU {dev_miou} out of the host run's "
                             f"range ({host_miou})")
    return out


def phase_adv_train(dev, records, train_data: str, prep: str) -> dict:
    """66. ``--adv_train nb`` through ``cli.train``: PointNet++ SSG at 32 ×
    4096 (one epoch on phase 17's rooms, ``--adv_iters 5``) and RandLA S3DIS
    at 6 × 40960 (4 steps, one validation cloud). Launches a step: the
    step's train-mode plan and ONE evaluation-mode plan for the attack
    (SSG 8 FPS and 16 bottom-k, RandLA 20 kNN), not one per iteration;
    every loss finite. ms a step by CUDA events with the attack and
    without; the crafted batch within the ε-ball and moved."""
    from pointsecguard_tpu_torch.attacks.pgd import PGDConfig
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, WholeSceneBlocks
    from pointsecguard_tpu_torch.models import RandLANet, weighted_nll_loss, weighted_softmax_ce_loss
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET_MODELS, TrainState, make_adv_train_fn, make_train_step, randla_family,
    )

    out = {}
    rooms = RoomSet.load(train_data, "train", 5)
    steps = -(-len(S3DISBlockSampler(rooms, num_point=NUM_POINT)) // TRAIN_BATCH)
    test_blocks = WholeSceneBlocks(RoomSet.load(train_data, "test", 5), block_points=NUM_POINT
                                   ).room_blocks(0, np.random.default_rng(0))[0].shape[0]
    eval_batches = -(-test_blocks // TRAIN_BATCH)
    log = os.path.join(WORK, "adv_train_pointnet2")
    _, counts, peak, wall = _train_cli([
        "--model", "pointnet2", "--data_root", train_data, "--log_dir", log,
        "--npoint", str(NUM_POINT), "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
        "--learning_rate", str(TRAIN_LR), "--adv_train", "nb", "--adv_iters", str(ADV_ITERS)])
    want = {"fps": 8 * steps + 4 * eval_batches, "bottom_k": 16 * steps + 8 * eval_batches}
    if {k: counts[k] for k in want} != want or any(counts[k] for k in counts if k not in want):
        raise AssertionError(f"adversarial SSG training launches {counts}, want {want}")
    out["pointnet2"] = {**_epoch_figures(log, TRAIN_BATCH, steps), "launches": counts,
                        "fps_per_step": 8, "bottom_k_per_step": 16,
                        "peak_device_memory_gb": peak, "main_wall_s": wall}
    for kernel, per in (("fps", 8), ("bottom_k", 16)):
        _record_path(records, kernel, "pointnet2 train --adv_train nb", counts[kernel],
                     "pointnet2 adversarial train step", per)

    rlog = os.path.join(WORK, "adv_train_randla")
    _, counts, peak, wall = _train_cli([
        "--model", "randla", "--randla_dir", prep, "--log_dir", rlog,
        "--randla_points", str(RANDLA_POINTS), "--batch_size", str(RANDLA_TRAIN_BATCH),
        "--steps_per_epoch", str(ADV_RANDLA_STEPS), "--val_steps", "1", "--epochs", "1",
        "--adv_train", "nb", "--adv_iters", str(ADV_ITERS)])
    want = {"knn": 20 * ADV_RANDLA_STEPS + 10}
    if counts["knn"] != want["knn"] or any(counts[k] for k in counts if k != "knn"):
        raise AssertionError(f"adversarial RandLA training launches {counts}, want {want}")
    out["randla"] = {**_epoch_figures(rlog, RANDLA_TRAIN_BATCH, ADV_RANDLA_STEPS),
                     "launches": counts, "knn_per_step": 20, "peak_device_memory_gb": peak,
                     "main_wall_s": wall}
    _record_path(records, "knn", "randla train --adv_train nb", counts["knn"],
                 "randla adversarial train step", 20)

    # a step with the attack and without, by CUDA events, on one batch
    cfg = PGDConfig(eps=0.1, alpha=0.05, iters=ADV_ITERS)
    pts, labels = next(iter(S3DISBlockSampler(rooms, num_point=NUM_POINT).batches(
        np.random.default_rng(1), TRAIN_BATCH)))
    batches = {"pointnet2": (torch.from_numpy(pts).to(dev), torch.from_numpy(labels).to(dev)),
               "randla": randla_train_batch(prep, dev, RANDLA_TRAIN_BATCH, RANDLA_POINTS, 3)}
    for name in ("pointnet2", "randla"):
        if name == "pointnet2":
            net, family = POINTNET_MODELS["pointnet2"][0](), POINTNET_MODELS["pointnet2"][1]
            loss_fn, wd, weights, bn = weighted_nll_loss, 1e-4, torch.ones(13, device=dev), 0.1
        else:
            net, family = RandLANet(), randla_family()
            loss_fn, wd, weights, bn = weighted_softmax_ce_loss, 0.0, torch.ones(13, device=dev), None
        state = TrainState(net.to(dev))
        adv = make_adv_train_fn(net, family, cfg)
        x, y = batches[name]
        gen = torch.Generator(device=dev).manual_seed(0)
        crafted = adv(x, y, gen)
        delta = (crafted - x)[..., 3:6].abs().max().item()
        if not 0 < delta <= cfg.eps + 1e-6 or not torch.equal(crafted[..., :3], x[..., :3]):
            raise AssertionError(f"{name}: the crafted batch moved {delta}")
        ms = {}
        for what, hook in (("clean", None), ("adv", adv)):
            step = make_train_step(net, loss_fn, weight_decay=wd, family=family, adv_fn=hook)
            ms[what] = cuda_ms(lambda: step(state, x, y, weights, 1e-5, bn, gen), reps=3,
                               warmup=1)
        out[name].update(ms_per_step_cuda_events=ms["adv"],
                         clean_ms_per_step_cuda_events=ms["clean"],
                         adv_over_clean=ms["adv"] / ms["clean"], crafted_max_abs_delta=delta)
    print("--adv_train nb: " + json.dumps(out))
    return out


def phase_remat(dev, records, resgcn_data: str) -> dict:
    """67. ResGCN-28 at 8 × 4096 with and without ``--remat``: two epochs of
    ``cli.train --model resgcn --remat`` on phase 32's room (4 kNN launches a
    step, every loss finite; the first epoch pays the path's first steps,
    the second reads the steady state); then one step of the full-width model from
    the same state on one batch each way: peak device memory
    (``max_memory_allocated``) and ms a step by CUDA events, and the two
    steps' loss (within 1e-6 relative), gradients (relative L2 1e-5),
    BatchNorm statistics (1e-5 of the largest) and parameters (all but
    0.1 % of them within 1e-6: Adam's first step moves a parameter by
    ±lr whatever its gradient's size, so a gradient that rounds to the
    other sign puts that one parameter 2 · lr apart) equal."""
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler
    from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters
    from pointsecguard_tpu_torch.models.resgcn import ce_loss
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, resgcn_family

    rooms = RoomSet.load(resgcn_data, "train", 5)
    sampler = S3DISBlockSampler(rooms, num_point=NUM_POINT)
    steps = -(-len(sampler) // RESGCN_BATCH)
    log = os.path.join(WORK, "remat_train")
    _, counts, peak, wall = _train_cli([
        "--model", "resgcn", "--data_root", resgcn_data, "--log_dir", log,
        "--npoint", str(NUM_POINT), "--batch_size", str(RESGCN_BATCH), "--epochs", "2",
        "--remat"])
    if counts["knn"] != 8 * steps or any(counts[k] for k in counts if k != "knn"):
        raise AssertionError(f"resgcn --remat launches {counts}, want knn 4 × {2 * steps}")
    out = {"cli": {**_epoch_figures(log, RESGCN_BATCH, steps), "launches": counts,
                   "peak_device_memory_gb": peak, "main_wall_s": wall}}
    _record_path(records, "knn", "resgcn train --remat", counts["knn"],
                 "resgcn remat train step", 4)

    pts, labels = next(iter(sampler.batches(np.random.default_rng(1), RESGCN_BATCH)))
    pts, labels = torch.from_numpy(pts).to(dev), torch.from_numpy(labels).long().to(dev)
    init = DenseDeepGCN()
    init_parameters(init, torch.Generator().manual_seed(3), scale=2.0)
    sd = init.state_dict()
    got = {}
    for remat in (False, True):
        model = DenseDeepGCN(remat=remat)
        model.load_state_dict(sd)
        state = TrainState(model.to(dev))
        step = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family())
        before = (state.params.clone(), state.mu.clone(), state.nu.clone(),
                  state.count.clone(), state.stats.clone())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = step(state, pts, labels, None, REMAT_LR, None)
        torch.cuda.synchronize()
        rec = {"loss": loss.item(), "grads": state.grads.clone(), "params": state.params.clone(),
               "stats": state.stats.clone(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_above_state_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        rec["ms"] = cuda_ms(lambda: step(state, pts, labels, None, 1e-7, None), reps=3,
                            warmup=1)
        for t, b in zip((state.params, state.mu, state.nu, state.count, state.stats), before):
            t.copy_(b)
        got[remat] = rec
        del model, state, step
    a, b = got[False], got[True]
    diff = (a["params"] - b["params"]).abs()
    res = {
        "peak_gb": a["peak_gb"], "peak_gb_remat": b["peak_gb"],
        "peak_above_state_gb": a["peak_above_state_gb"],
        "peak_above_state_gb_remat": b["peak_above_state_gb"],
        "ms_per_step": a["ms"], "ms_per_step_remat": b["ms"],
        "loss": a["loss"], "loss_rel": abs(a["loss"] - b["loss"]) / abs(a["loss"]),
        "grad_rel_l2": _rel_l2(b["grads"].cpu(), a["grads"].cpu()),
        "stats_max_abs": (a["stats"] - b["stats"]).abs().max().item(),
        "stats_max": a["stats"].abs().max().item(),
        "params_max_abs": diff.max().item(),
        "params_share_over_1e-6": (diff > 1e-6).float().mean().item(),
    }
    out["step"] = res
    print("resgcn --remat: " + json.dumps(out))
    ok = (math.isfinite(a["loss"]) and res["loss_rel"] <= 1e-6 and res["grad_rel_l2"] <= 1e-5
          and res["stats_max_abs"] <= 1e-5 * res["stats_max"]
          and res["params_share_over_1e-6"] <= 1e-3
          and res["peak_above_state_gb_remat"] < res["peak_above_state_gb"])
    if not ok:
        raise AssertionError("ResGCN's step with --remat disagrees with the step without it, "
                             "or keeps no less memory")
    return out


def phase_profile(records, resgcn_data: str) -> dict:
    """68. ``cli.train --model pointnet2 --profile DIR`` at 32 × 4096 on
    phase 32's one room (one epoch of 4 steps and an eval): the trace of
    the first epoch's training names the FPS and bottom-k kernels, as many
    of each as the counters counted in the steps (4 and 8 a step)."""
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler

    steps = -(-len(S3DISBlockSampler(RoomSet.load(resgcn_data, "train", 5),
                                     num_point=NUM_POINT)) // TRAIN_BATCH)
    trace = os.path.join(WORK, "profile_trace")
    log = os.path.join(WORK, "profile_log")
    _, counts, _, wall = _train_cli([
        "--model", "pointnet2", "--data_root", resgcn_data, "--log_dir", log,
        "--npoint", str(NUM_POINT), "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
        "--eval_every", "99", "--profile", trace])
    path = os.path.join(trace, "epoch_0.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {"fps": sum("fps_kernel" in n for n in kernels),
             "bottom_k": sum("bottom_k_" in n and "chunked" not in n for n in kernels)}
    out = {"trace_bytes": os.path.getsize(path), "events": len(events),
           "kernel_events": len(kernels), "named": named, "steps": steps,
           "launches": counts, "main_wall_s": wall}
    print("--profile: " + json.dumps(out))
    if named != {"fps": 4 * steps, "bottom_k": 8 * steps}:
        raise AssertionError(f"the trace names {named}, want 4 and 8 a step over {steps} steps")
    for kernel in ("fps", "bottom_k"):
        _record_path(records, kernel, "pointnet2 train --profile", counts[kernel])
    return out


def run_training_extras_phases(dev, records, train_data: str, prep: str,
                               resgcn_data: str) -> dict:
    """Phases 64-68; returns phase 65's figures."""
    out = {}
    for number, phase in (
            (64, lambda: phase_device_sampler(dev, train_data)),
            (65, lambda: phase_device_sampler_train(dev, records, train_data)),
            (66, lambda: phase_adv_train(dev, records, train_data, prep)),
            (67, lambda: phase_remat(dev, records, resgcn_data)),
            (68, lambda: phase_profile(records, resgcn_data))):
        t0 = time.perf_counter()
        out[number] = phase()
        print(f"phase {number}: {time.perf_counter() - t0:.1f} s")
    return out[65]


# --- phases 69-71: --precision bfloat16 and cli.import_ckpt --------------------------

BF16 = ["--precision", "bfloat16"]
# phase 69's bound, the card's bf16 against the CPU's bf16 on the same
# weights and pinned geometry: bf16 ulps of the largest centred output (the
# log-probabilities or logits less their mean over the classes), where one
# ulp is 2^(e − 7) at that output's binary exponent e. Measured on an H100
# 80GB HBM3 at 700 W (PERF.md §6): the PointNet family 0.00–2.13 and RandLA
# 2.00, the same on every run (seeded weights); bound 4, the CPU tests'
# port-against-JAX bf16 bound (tests/test_torch_precision.py). ResGCN-28
# runs on phase 32's trained weights, which differ from run to run (the
# card's scatter-add order), through 28 residual blocks that carry a
# rounding on: 2.23, 2.50 and 5.38 on three runs; bound 16, the upper end
# of the range predicted before the first run, where the CPU's own bf16
# sits 12–18 ulps from its float32. Every model but ResGCN-28 is also held
# to JAX's own bf16-against-float32 limits (tests/test_precision.py), 0.05
# on PointNet-family log-probabilities and 0.1 on RandLA's logits; ResGCN's
# trained logits reach 8, where one bf16 ulp is 0.0625, so no bf16
# computation can meet 0.1
BF16_CARD_ULPS = {"resgcn": 16}
BF16_DEFAULT_ULPS = 4
BF16_JAX_LIMITS = {"randla": 0.1}
BF16_LOGP_LIMIT = 0.05
BF16_RANDLA_POINTS = 8192  # phase 69's cloud (13's size: the CPU runs it too)
BF16_MODELS = ("pointnet2", "pointnet2_msg", "pointnet", *CLS_MODELS, *PS_MODELS,
               "randla", "resgcn")
RESGCN_IMPORT_BLOCKS = 4  # phase 71's reference ResGCN
RESGCN_BF16_NB_BLOCKS = 1  # phase 70's ResGCN NB through the CLI, one batch (2 until phases 82-83)


def bf16_state_dict(model: torch.nn.Module, seed: int, scale: float = 1.0) -> dict:
    """``model``'s state from ``init_parameters`` of a seeded generator, with
    every BatchNorm's scale in [0.5, 1.5), bias and mean in [−0.5, 0.5) and
    variance in [0.5, 2) drawn from it too: the recipe of
    ``tests/test_torch_precision.py``. (``calibrated_state_dict``'s
    statistics of one forward leave channels of near-zero variance, which
    multiply any rounding by up to 1/sqrt(ε); phase 36's docstring.)"""
    from pointsecguard_tpu_torch.models import init_parameters
    from pointsecguard_tpu_torch.models.common import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    init_parameters(model, gen, scale=scale)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.mean.shape[0]
                mod.scale.copy_(torch.rand(n, generator=gen) + 0.5)
                mod.bias.copy_(torch.rand(n, generator=gen) - 0.5)
                mod.mean.copy_(torch.rand(n, generator=gen) - 0.5)
                mod.var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
    return model.state_dict()


def bf16_case(name: str, dev, data: str, prep: str, resgcn_log: str):
    """(model(dtype) → the full-width model on the CPU with the case's
    weights, family, points on the card) of a phase-69 model. The weights
    are seeded (``bf16_state_dict``), but ResGCN-28's are phase 32's trained
    checkpoint: its 27 residual additions let seeded weights' logits grow
    by orders of magnitude, where bf16's absolute error has no scale to be
    read against."""
    from pointsecguard_tpu_torch.models import DenseDeepGCN, RandLANet
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET_MODELS,
        cls_model,
        randla_family,
        resgcn_family,
    )

    if name in POINTNET_MODELS:
        family = POINTNET_MODELS[name][1]
        build = lambda dt: POINTNET_MODELS[name][0](dtype=dt)  # noqa: E731
        pts = slice_blocks(dev)[:1].contiguous()
    elif name in CLS_MODELS:
        family = cls_model(name, 40)[1]
        build = lambda dt: cls_model(name, 40, dtype=dt)[0]  # noqa: E731
        pts = cls_shapes(dev, 2)
    elif name in PS_MODELS:
        family = cls_model(name, 50)[1]
        build = lambda dt: cls_model(name, 50, dtype=dt)[0]  # noqa: E731
        p, onehot, _ = partseg_batch(dev, 2)
        pts = torch.cat([p, onehot[:, None].expand(-1, PS_POINTS, -1)], -1)
    elif name == "randla":
        family = randla_family()
        build = lambda dt: RandLANet(dtype=dt)  # noqa: E731
        pts = randla_batch(prep, dev, BF16_RANDLA_POINTS, 1)
    else:
        family = resgcn_family()
        build = lambda dt: DenseDeepGCN(dtype=dt)  # noqa: E731
        pts, _ = resgcn_room_batch(data, 1, dev, seed=2)
    sd = (load_checkpoint(resgcn_log) if name == "resgcn"
          else bf16_state_dict(build(None), 2))

    def model(dtype):
        net = build(dtype)
        net.load_state_dict(sd)
        return net.eval()

    return model, family, pts


def _bf16_ulp(out: torch.Tensor) -> float:
    centred = out - out.mean(dim=-1, keepdim=True)
    return 2.0 ** (math.floor(math.log2(centred.abs().max().item())) - 7)


def phase_bf16_models(dev, records, data: str, prep: str, resgcn_log: str) -> dict:
    """69. The eleven models at full width in bf16 (``dtype=torch.bfloat16``,
    ``--precision bfloat16``): seeded weights (ResGCN: phase 32's trained
    checkpoint; ``bf16_case``), the PointNet family on 1 block of 4096 points, the
    classifiers on 2 shapes of 1024, the part-seg nets on 2 of 2048, RandLA
    on 1 cloud of ``BF16_RANDLA_POINTS``, ResGCN-28 on 1 block of 4096. On
    the card: the model builds its own geometry in float32 and in bf16, each
    with the launch counters reset, and the counts must be equal (the
    geometry stays float32 in bf16, so the same kernels launch as often);
    then the card's bf16 against the CPU's bf16 on the card's float32
    geometry (ResGCN: the float32 forward's graphs): the output float32,
    within ``BF16_CARD_ULPS`` bf16 ulps and JAX's limits (the constants'
    comment says which apply where); and one train-mode
    step in bf16 on the card: every parameter and its gradient float32 and
    finite, every BatchNorm statistic float32."""
    from pointsecguard_tpu_torch.ops import cuda as kernels

    cpu = torch.device("cpu")
    out, failed = {}, []
    for name in BF16_MODELS:
        t0 = time.perf_counter()
        model, family, pts = bf16_case(name, dev, data, prep, resgcn_log)
        counts = {}
        with torch.no_grad():
            for label, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
                net = model(dtype).to(dev)
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                res = family.head(family.apply(net, pts, family.plan(pts)))
                torch.cuda.synchronize()
                counts[label] = kernels.launch_counts()
                if label == "float32":
                    plan = (net(pts, collect_graphs=True)[1] if name == "resgcn"
                            else family.plan(pts))
                if not (res.dtype == torch.float32 and torch.isfinite(res).all()):
                    raise AssertionError(f"{name} {label}: output {res.dtype}, or not finite")
            card = family.head(family.apply(model(torch.bfloat16).to(dev), pts, plan)).cpu()
            host = family.head(family.apply(model(torch.bfloat16), pts.cpu(),
                                            _to_device(plan, cpu, torch.float32)))
            host32 = family.head(family.apply(model(None), pts.cpu(),
                                              _to_device(plan, cpu, torch.float32)))
        net = model(torch.bfloat16).to(dev).train()
        logp = torch.log_softmax(family.head(family.apply(net, pts, family.plan(pts), 0.1)), -1)
        (-logp[..., 0].mean()).backward()
        for key, p in net.named_parameters():
            if p.dtype != torch.float32 or (p.grad is not None and (
                    p.grad.dtype != torch.float32 or not torch.isfinite(p.grad).all())):
                raise AssertionError(f"{name} bf16 step: {key} {p.dtype} / its gradient "
                                     "not float32 and finite")
        if any(b.dtype != torch.float32 for b in net.buffers()):
            raise AssertionError(f"{name} bf16 step: a BatchNorm statistic left float32")
        err = (card - host).abs().max().item()
        ulps = err / _bf16_ulp(host)
        limit = (None if name == "resgcn"
                 else BF16_JAX_LIMITS.get(name, BF16_LOGP_LIMIT))
        out[name] = {"card_vs_cpu_max_abs": err, "card_vs_cpu_bf16_ulps": ulps,
                     "bf16_vs_float32_cpu_max_abs": (host - host32).abs().max().item(),
                     "largest_centred": _bf16_ulp(host) * 128, "jax_limit": limit,
                     "launches": counts["bfloat16"], "s": time.perf_counter() - t0}
        print(f"{name} bf16: " + json.dumps(out[name]))
        if counts["float32"] != counts["bfloat16"]:
            failed.append(f"{name}: bf16 launches {counts['bfloat16']} != float32's "
                          f"{counts['float32']}")
        if (card.dtype != torch.float32 or card.shape != host.shape
                or not (limit is None or err <= limit)):
            failed.append(f"{name}: the card's bf16 {card.dtype} {tuple(card.shape)} is "
                          f"{err} from the CPU's (JAX's limit {limit})")
        bound = BF16_CARD_ULPS.get(name, BF16_DEFAULT_ULPS)
        if not ulps <= bound:
            failed.append(f"{name}: the card's bf16 is {ulps:.2f} bf16 ulps from the CPU's, "
                          f"over the stated {bound}")
        for kernel, n in counts["bfloat16"].items():
            if n:
                _record_path(records, kernel, f"{name} forward --precision bfloat16", n)
        del net
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _step_ms(make_model, dev, pts, labels, loss_fn, family, weights=None) -> dict:
    """One optimizer step of a fresh float32 and bf16 model from the same
    weights on one batch: ms by CUDA events and peak memory above the state."""
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step

    got = {}
    for label, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        net = make_model(dtype)
        state = TrainState(net.to(dev))
        step = make_train_step(net, loss_fn, family=family)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, pts, labels, weights, 1e-7, 0.1, gen)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        ms = cuda_ms(lambda: step(state, pts, labels, weights, 1e-7, 0.1, gen), reps=5)
        got[label] = {"ms_per_step": ms, "peak_above_state_gb": peak}
        del net, state, step
    return got


def _nb_iter_ms(net_fn, dev, pts, labels) -> dict:
    """One NB iteration (a forward and the colour gradient of the summed
    cross-entropy) of a float32 and a bf16 model: ms by CUDA events, peak
    memory."""
    from pointsecguard_tpu_torch.attacks.common import per_point_ce

    got = {}
    for label, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        net = net_fn(dtype).to(dev).requires_grad_(False)

        def it():
            x = pts.clone().requires_grad_(True)
            loss = per_point_ce(net(x), labels).sum()
            return torch.autograd.grad(loss, x)[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        it()
        torch.cuda.synchronize()
        got[label] = {"ms_per_iteration": cuda_ms(it, reps=5),
                      "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del net
    return got


def phase_bf16_clis(dev, records, paths: dict, f32_train: dict) -> dict:
    """70. ``--precision bfloat16`` through the CLIs on the card:
    ``cli.train`` of PointNet++ SSG (32 × 4096, ``DS_EPOCHS`` epochs on
    phase 17's rooms, an eval after the last: one geometry's launches a
    step and an eval batch, as in float32) and of ResGCN-28 (one epoch of
    8 × 4096 on phase 32's room, and one more run with ``--remat``: 4 kNN a
    step), SSG's and the first ResGCN run's checkpoints then through
    ``cli.eval --num_votes 1`` (one geometry / 4 kNN a batch); NB through
    ``cli.attack`` on the trained SSG (8 blocks: one geometry a batch),
    RandLA with the reference pooling (4 clouds: 10 kNN a batch) and ResGCN
    (``RESGCN_BF16_NB_BLOCKS`` blocks: 4 kNN a forward); NB through
    ``cli.attack_object`` on the trained SSG classifier (16 shapes: 53
    forwards of 2 FPS and 1 bottom-k); ``cli.benchmark --attack_name pgd``
    on the trained SSG (8 blocks: one geometry a batch); ``--fused_ap``
    with bf16 refused by name. Beside float32 on the same data: SSG's ms a
    train step by CUDA events and peak memory (and blocks/s on the host's
    clock, float32's from phase 65's host run, the same rooms and flags),
    ResGCN's ms an NB iteration by CUDA events and peak memory."""
    from pointsecguard_tpu_torch.cli import attack as attack_cli
    from pointsecguard_tpu_torch.cli import attack_object as object_cli
    from pointsecguard_tpu_torch.cli import benchmark as bench_cli
    from pointsecguard_tpu_torch.cli import eval as eval_cli
    from pointsecguard_tpu_torch.cli import train as train_cli
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, WholeSceneBlocks
    from pointsecguard_tpu_torch.models import DenseDeepGCN, weighted_nll_loss
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    train_data, resgcn_data = paths["train_data"], paths["resgcn_data"]

    def eval_batches(data, batch):
        blocks = WholeSceneBlocks(RoomSet.load(data, "test", 5), block_points=NUM_POINT
                                  ).room_blocks(0, np.random.default_rng(0))[0].shape[0]
        return -(-blocks // batch)

    # PointNet++ SSG: cli.train, then cli.eval, in bf16
    rooms = RoomSet.load(train_data, "train", 5)
    steps = -(-len(S3DISBlockSampler(rooms, num_point=NUM_POINT)) // TRAIN_BATCH)
    log = os.path.join(WORK, "bf16_train_log")
    _, counts, peak, wall = _cli_run(train_cli.main, [
        "--model", "pointnet2", "--data_root", train_data, "--log_dir", log,
        "--npoint", str(NUM_POINT), "--batch_size", str(TRAIN_BATCH),
        "--epochs", str(DS_EPOCHS), "--eval_every", str(DS_EPOCHS),
        "--learning_rate", str(TRAIN_LR), *BF16])
    check_geometry_launches("pointnet2", counts,
                            DS_EPOCHS * steps + eval_batches(train_data, TRAIN_BATCH),
                            "train --precision bfloat16")
    ssg = {**_epoch_figures(log, TRAIN_BATCH, steps), "peak_device_memory_gb": peak,
           "main_wall_s": wall, "launches": counts}
    for kernel, per in GEOMETRY_LAUNCHES["pointnet2"].items():
        _record_path(records, kernel, "pointnet2 train --precision bfloat16", counts[kernel])
    if any(v.dtype != torch.float32 for v in load_checkpoint(log).values()):
        raise AssertionError("the bf16 run's checkpoint holds a tensor other than float32")
    m, counts, _, wall = _cli_run(eval_cli.main, [
        "--model", "pointnet2", "--data_root", train_data, "--log_dir", log,
        "--num_point", str(NUM_POINT), "--batch_size", str(TRAIN_BATCH), "--num_votes", "1",
        *BF16])
    check_geometry_launches("pointnet2", counts, eval_batches(train_data, TRAIN_BATCH),
                            "eval --precision bfloat16")
    ssg["eval"] = {"miou": m.miou, "accuracy": m.accuracy, "wall_s": wall}
    for kernel in GEOMETRY_LAUNCHES["pointnet2"]:
        _record_path(records, kernel, "pointnet2 eval --precision bfloat16", counts[kernel])
    pts, labels = next(iter(S3DISBlockSampler(rooms, num_point=NUM_POINT).batches(
        np.random.default_rng(1), TRAIN_BATCH)))
    pts, labels = torch.from_numpy(pts).to(dev), torch.from_numpy(labels).to(dev)
    weights = torch.from_numpy(np.asarray(rooms.label_weights, np.float32)).to(dev)
    sd = load_checkpoint(paths["train_log"])

    def ssg_model(dtype):
        net = POINTNET_MODELS["pointnet2"][0](dtype=dtype)
        net.load_state_dict(sd)
        return net

    ssg["step"] = _step_ms(ssg_model, dev, pts, labels, weighted_nll_loss,
                           POINTNET_MODELS["pointnet2"][1], weights)
    ssg["float32_host_run"] = {k: f32_train[k] for k in ("blocks_per_s",
                                                          "ms_per_step_host_clock",
                                                          "peak_device_memory_gb")}
    out["pointnet2 train"] = ssg
    print("pointnet2 --precision bfloat16 train / eval: " + json.dumps(ssg))
    if not (ssg["eval"]["accuracy"] >= 0.0 and math.isfinite(ssg["eval"]["miou"])):
        raise AssertionError("bf16 SSG eval: no finite figure")

    # ResGCN-28: cli.train (and --remat), each then cli.eval
    r_steps = -(-len(S3DISBlockSampler(RoomSet.load(resgcn_data, "train", 5),
                                       num_point=NUM_POINT)) // RESGCN_BATCH)
    r_eval = eval_batches(resgcn_data, RESGCN_BATCH)
    for extra in ([], ["--remat"]):
        path = "resgcn train" + "".join(f" {e}" for e in extra) + " --precision bfloat16"
        log = os.path.join(WORK, "bf16_resgcn_log" + "_remat" * bool(extra))
        _, counts, peak, wall = _cli_run(train_cli.main, [
            "--model", "resgcn", "--data_root", resgcn_data, "--log_dir", log,
            "--npoint", str(NUM_POINT), "--batch_size", str(RESGCN_BATCH), "--epochs", "1",
            *extra, *BF16])
        if counts["knn"] != 4 * r_steps or any(counts[k] for k in counts if k != "knn"):
            raise AssertionError(f"{path}: launches {counts}, want knn 4 × {r_steps}")
        run = {**_epoch_figures(log, RESGCN_BATCH, r_steps), "peak_device_memory_gb": peak,
               "main_wall_s": wall, "launches": counts}
        _record_path(records, "knn", path, counts["knn"])
        if not extra:  # the --remat run's weights are another draw of the same step
            m, counts, _, wall = _cli_run(eval_cli.main, [
                "--model", "resgcn", "--data_root", resgcn_data, "--log_dir", log,
                "--num_point", str(NUM_POINT), "--batch_size", str(RESGCN_BATCH),
                "--num_votes", "1", *BF16])
            if counts["knn"] != 4 * r_eval:
                raise AssertionError(f"resgcn eval --precision bfloat16: launches {counts}, "
                                     f"want knn 4 × {r_eval}")
            run["eval"] = {"miou": m.miou, "accuracy": m.accuracy, "wall_s": wall}
            _record_path(records, "knn", "resgcn eval --precision bfloat16", counts["knn"])
        out[path] = run
        print(f"{path}: " + json.dumps(run))

    # NB: SSG, RandLA (reference pooling), ResGCN; float32's launches: one
    # geometry a batch, one pyramid (10 kNN) a batch, 4 kNN a forward (the
    # clean one, one an iteration, PGD's last and the adversarial one)
    attacks = {}
    for model, log, flags in (
            ("pointnet2", paths["train_log"],
             ["--data_root", train_data, "--num_point", str(NUM_POINT), "--batch_size",
              str(BATCH), "--max_blocks", str(BATCH)]),
            ("randla", paths["randla_log"],
             ["--randla_dir", paths["prep"], "--num_clouds", str(RANDLA_BATCH),
              "--batch_size", str(RANDLA_BATCH)]),
            ("resgcn", paths["resgcn_log"],
             ["--data_root", resgcn_data, "--num_point", str(NUM_POINT), "--batch_size",
              str(RESGCN_BF16_NB_BLOCKS), "--max_blocks", str(RESGCN_BF16_NB_BLOCKS)])):
        (clean_m, adv_m), counts, peak, wall = _cli_run(attack_cli.main, [
            "--model", model, "--attack", "nb", "--log_dir", log, *flags, *BF16])
        rows = read_tsv(os.path.join(log, f"{model}_nb_area5.tsv"))
        steps = max(int(float(r["steps"])) for r in rows)
        want = {"pointnet2": GEOMETRY_LAUNCHES["pointnet2"], "randla": {"knn": 10},
                "resgcn": {"knn": 4 * (steps + 3)}}[model]
        run = {"rows": len(rows),
               "clean_acc": float(np.mean([float(r["clean_acc"]) for r in rows])),
               "adv_acc": float(np.mean([float(r["adv_acc"]) for r in rows])),
               "ms_per_row": float(1e3 * np.mean([float(r["time_s"]) for r in rows])),
               "peak_device_memory_gb": peak, "main_wall_s": wall, "launches": counts}
        attacks[model] = run
        print(f"{model} nb --precision bfloat16: " + json.dumps(run))
        if {k: counts[k] for k in want} != want or any(
                counts[k] for k in counts if k not in want):
            raise AssertionError(f"{model} NB bf16: launches {counts}, want {want} (float32's)")
        if not (math.isfinite(run["adv_acc"]) and run["adv_acc"] <= run["clean_acc"]):
            raise AssertionError(f"{model} NB bf16: adversarial accuracy not below clean")
        for kernel, n in want.items():
            _record_path(records, kernel, f"{model} nb --precision bfloat16", counts[kernel])
    out["nb"] = attacks
    net_sd = load_checkpoint(paths["resgcn_log"])

    def resgcn_net(dtype):
        net = DenseDeepGCN(dtype=dtype)
        net.load_state_dict(net_sd)
        return net.eval()

    blocks, blabels = resgcn_room_batch(resgcn_data, RESGCN_BATCH, dev)
    out["resgcn nb iteration"] = _nb_iter_ms(resgcn_net, dev, blocks, blabels)
    print("resgcn NB iteration, float32 vs bfloat16: " + json.dumps(out["resgcn nb iteration"]))

    # cli.attack_object NB on the trained SSG classifier, one batch of 16
    res, counts, _, wall = _cli_run(object_cli.main, [
        "--model", "pointnet2_cls", "--data_root", cls_data(), "--log_dir",
        os.path.join(WORK, "cls_log_pointnet2_cls"), "--attack", "nb",
        "--batch_size", str(CLS_BATCH), "--max_shapes", str(CLS_BATCH), *BF16])
    _cls_counts_check("pointnet2_cls", counts, 53, "nb --precision bfloat16")
    out["pointnet2_cls nb"] = {"clean_acc": res["clean_acc"], "adv_acc": res["adv_acc"],
                               "ms_per_batch": res["batch_ms"], "launches": counts,
                               "main_wall_s": wall}
    print("pointnet2_cls nb --precision bfloat16: " + json.dumps(out["pointnet2_cls nb"]))
    for kernel in ("fps", "bottom_k"):
        _record_path(records, kernel, "pointnet2_cls nb --precision bfloat16", counts[kernel])

    # cli.benchmark: one attack on the trained SSG
    (acc, acc_adv, total, succ, dist), counts, _, wall = _cli_run(bench_cli.main, [
        "--model", "pointnet2", "--data_root", train_data, "--log_dir", paths["train_log"],
        "--num_point", str(NUM_POINT), "--batch_size", str(BATCH), "--max_blocks", str(BATCH),
        "--attack_name", "pgd", "--iters", "10", *BF16])
    check_geometry_launches("pointnet2", counts, 1, "benchmark pgd --precision bfloat16")
    out["pointnet2 benchmark pgd"] = {"acc": float(np.mean(acc)),
                                      "adv_acc": float(np.mean(acc_adv)),
                                      "dist_mean": float(np.mean(dist)), "wall_s": wall}
    print("pointnet2 benchmark pgd --precision bfloat16: "
          + json.dumps(out["pointnet2 benchmark pgd"]))
    if not np.isfinite(dist).all():
        raise AssertionError("benchmark pgd bf16: a non-finite distance")
    for kernel in ("fps", "bottom_k"):
        _record_path(records, kernel, "pointnet2 benchmark --precision bfloat16", counts[kernel])

    # the fused attentive kernel is float32 only: refused by name
    try:
        attack_cli.main(["--model", "randla", "--attack", "nb", "--fused_ap",
                         "--log_dir", paths["randla_log"], *BF16])
    except SystemExit as e:
        if "--fused_ap with --precision bfloat16" not in str(e):
            raise AssertionError(f"--fused_ap with bf16: refused as '{e}'") from e
        print(f"--fused_ap --precision bfloat16 refused: {e}")
    else:
        raise AssertionError("--fused_ap with --precision bfloat16 ran")
    return out


def _reference_modules():
    """Reference-schema torch modules (the checkpoints ``cli.import_ckpt``
    reads) for PointNet++ SSG semseg and ResGCN of ``RESGCN_IMPORT_BLOCKS``
    blocks: Conv 1×1 + BatchNorm stacks under the reference's names, the
    BatchNorm parameters and statistics drawn from a seed."""
    from torch import nn

    def mlp(cin, outs, conv=nn.Conv2d, bn=nn.BatchNorm2d):
        m = nn.Module()
        m.mlp_convs, m.mlp_bns = nn.ModuleList(), nn.ModuleList()
        for o in outs:
            m.mlp_convs.append(conv(cin, o, 1))
            m.mlp_bns.append(bn(o))
            cin = o
        return m

    torch.manual_seed(0)
    ssg = nn.Module()
    for k, (cin, outs) in enumerate(((12, (32, 32, 64)), (67, (64, 64, 128)),
                                     (131, (128, 128, 256)), (259, (256, 256, 512)))):
        setattr(ssg, f"sa{k + 1}", mlp(cin, outs))
    for name, cin, outs in (("fp4", 768, (256, 256)), ("fp3", 384, (256, 256)),
                            ("fp2", 320, (256, 128)), ("fp1", 128, (128, 128, 128))):
        setattr(ssg, name, mlp(cin, outs, nn.Conv1d, nn.BatchNorm1d))
    ssg.conv1, ssg.bn1 = nn.Conv1d(128, 128, 1), nn.BatchNorm1d(128)
    ssg.conv2 = nn.Conv1d(128, 13, 1)

    def basic(cin, cout, norm=True):
        return nn.Sequential(nn.Conv2d(cin, cout, 1), *([nn.ReLU(), nn.BatchNorm2d(cout)]
                                                        if norm else []))

    def gconv(cin, cout):
        g = nn.Module()
        g.gconv = nn.Module()
        g.gconv.nn = basic(2 * cin, cout)
        return g

    c, nb = 64, RESGCN_IMPORT_BLOCKS
    resgcn = nn.Module()
    resgcn.head = gconv(9, c)
    body = []
    for _ in range(nb - 1):
        blk = nn.Module()
        blk.body = gconv(c, c)
        body.append(blk)
    resgcn.backbone = nn.Sequential(*body)
    resgcn.fusion_block = basic(c * nb, 1024)
    resgcn.prediction = nn.Sequential(basic(c * nb + 1024, 512), basic(512, 256), nn.Dropout(),
                                      basic(256, 13, norm=False))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in (*ssg.modules(), *resgcn.modules()):
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.5, 0.5, generator=gen)
    return ssg.state_dict(), {"module." + k: v for k, v in resgcn.state_dict().items()}


def _randla_reference_arrays(seed: int = 3) -> dict:
    """A full-width RandLA TF1 snapshot as ``{tf_variable_name: array}``
    (the fork's schema, ``utils/importers.py:map_randla_vars``): S3DIS's
    6 inputs, 13 classes, d_out (16, 64, 128, 256, 512); Linear weights
    uniform in ±1/sqrt(fan_in), BatchNorm scale in [0.5, 1.5), statistics
    in [−0.5, 0.5) and [0.5, 2)."""
    rng = np.random.default_rng(seed)
    names = {}

    def w(shape, fan_in):
        return (rng.uniform(-1, 1, shape) / math.sqrt(fan_in)).astype(np.float32)

    def bn(scope, c):
        pre = f"{scope}/" if scope else ""
        for leaf, lo, hi in (("gamma", 0.5, 1.5), ("beta", -0.5, 0.5),
                             ("moving_mean", -0.5, 0.5), ("moving_variance", 0.5, 2.0)):
            names[f"{pre}batch_normalization/{leaf}"] = rng.uniform(lo, hi, c).astype(np.float32)

    def conv(scope, cin, cout, with_bn=True, transpose=False):
        names[f"{scope}/weights"] = w((1, 1, cout, cin) if transpose else (1, 1, cin, cout), cin)
        names[f"{scope}/biases"] = w((cout,), cin)
        if with_bn:
            bn(scope, cout)

    names["fc0/kernel"], names["fc0/bias"] = w((6, 8), 6), w((8,), 6)
    bn("", 8)
    f_in, d_out = 8, (16, 64, 128, 256, 512)
    for i, d in enumerate(d_out):
        e = f"Encoder_layer_{i}"
        conv(f"{e}mlp1", f_in, d // 2)
        conv(f"{e}LFAmlp1", 10, d // 2)
        names[f"{e}LFAatt_pooling_1fc/kernel"] = w((d, d), d)
        conv(f"{e}LFAatt_pooling_1mlp", d, d // 2)
        conv(f"{e}LFAmlp2", d // 2, d // 2)
        names[f"{e}LFAatt_pooling_2fc/kernel"] = w((d, d), d)
        conv(f"{e}LFAatt_pooling_2mlp", d, d)
        conv(f"{e}mlp2", d, 2 * d)
        conv(f"{e}shortcut", f_in, 2 * d)
        f_in = 2 * d
    enc = [2 * d_out[0]] + [2 * d for d in d_out]
    conv("decoder_0", enc[-1], enc[-1])
    f = enc[-1]
    for j in range(len(d_out)):
        conv(f"Decoder_layer_{j}", enc[-j - 2] + f, enc[-j - 2], transpose=True)
        f = enc[-j - 2]
    conv("fc1", f, 64)
    conv("fc2", 64, 32)
    conv("fc", 32, 13, with_bn=False)
    return names


def phase_import(dev, paths: dict) -> dict:
    """71. ``cli.import_ckpt`` then ``cli.eval`` on the card: reference
    checkpoints written here (PointNet++ SSG semseg and ResGCN of
    ``RESGCN_IMPORT_BLOCKS`` blocks as ``.pth`` state dicts under the
    reference's names, RandLA as a ``.npz`` of TF variables) go through
    ``cli.import_ckpt``; the checkpoint it writes, restored on the card,
    gives log-probabilities (logits) equal to those of the same weights
    carried in this process through ``utils/importers.py`` and
    ``utils/convert.py``, on one batch; then ``cli.eval`` (no ``--device``:
    the card) restores it and evaluates (SSG and ResGCN on phase 17's and
    32's Area-5 room, RandLA on 4 clouds of phase 7's preparation)."""
    from pointsecguard_tpu_torch.cli import eval as eval_cli
    from pointsecguard_tpu_torch.cli import import_ckpt
    from pointsecguard_tpu_torch.models import DenseDeepGCN, PointNet2SemSegSSG, RandLANet
    from pointsecguard_tpu_torch.models import build_pyramid
    from pointsecguard_tpu_torch.utils import importers
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    root = os.path.join(WORK, "import")
    os.makedirs(root, exist_ok=True)
    ssg_sd, resgcn_sd = _reference_modules()
    torch.save({"model_state_dict": ssg_sd, "epoch": 7, "best_iou": 0.5},
               os.path.join(root, "best_model.pth"))
    torch.save({"state_dict": resgcn_sd, "epoch": 3}, os.path.join(root, "ckpt_best.pth"))
    arrays = _randla_reference_arrays()
    np.savez(os.path.join(root, "snap.npz"), **arrays)
    blocks, _ = resgcn_room_batch(paths["resgcn_data"], 2, dev)
    feats = randla_batch(paths["prep"], dev, RANDLA_POINTS, 1)
    out = {}
    for model, ckpt, raw, extra, build, run, eval_flags in (
            ("pointnet2", "best_model.pth", {"model_state_dict": ssg_sd}, [],
             lambda: PointNet2SemSegSSG(), lambda net: net(blocks)[0],
             ["--data_root", paths["train_data"], "--num_point", str(NUM_POINT)]),
            ("resgcn", "ckpt_best.pth", {"state_dict": resgcn_sd},
             ["--resgcn_blocks", str(RESGCN_IMPORT_BLOCKS)],
             lambda: DenseDeepGCN(n_blocks=RESGCN_IMPORT_BLOCKS),
             lambda net: torch.log_softmax(net(blocks), -1),
             ["--data_root", paths["resgcn_data"], "--num_point", str(NUM_POINT),
              "--resgcn_blocks", str(RESGCN_IMPORT_BLOCKS)]),
            ("randla", "snap.npz", arrays, [], lambda: RandLANet(),
             lambda net: torch.log_softmax(net(feats, build_pyramid(feats[..., :3])), -1),
             ["--randla_dir", paths["prep"], "--num_clouds", str(RANDLA_BATCH)])):
        t0 = time.perf_counter()
        log = os.path.join(root, f"{model}_log")
        import_ckpt.main(["--model", model, "--ckpt", os.path.join(root, ckpt),
                          "--log_dir", log, *extra])
        t_import = time.perf_counter() - t0
        want_sd = importers.state_dict_from_variables(model, importers.reference_variables(
            model, raw, resgcn_blocks=RESGCN_IMPORT_BLOCKS))
        lps = []
        for sd in (load_checkpoint(log), want_sd):
            net = build()
            net.load_state_dict(sd)
            with torch.no_grad():
                lps.append(run(net.to(dev).eval()))
        (m, counts, _, wall) = _cli_run(eval_cli.main, [
            "--model", model, "--log_dir", log, "--batch_size", "8" if model != "randla"
            else str(RANDLA_BATCH), "--num_votes", "1", *eval_flags])
        out[model] = {"import_s": t_import, "log_probs_equal": torch.equal(*lps),
                      "largest_log_prob": lps[0].abs().max().item(),
                      "eval_miou": m.miou, "eval_accuracy": m.accuracy, "eval_wall_s": wall,
                      "eval_launches": counts}
        print(f"{model} cli.import_ckpt -> cli.eval: " + json.dumps(out[model]))
        if not (torch.equal(*lps) and torch.isfinite(lps[0]).all()):
            raise AssertionError(f"{model}: the imported checkpoint's log-probabilities differ "
                                 "from the same weights through utils/convert.py")
        if not (0.0 <= m.accuracy <= 1.0 and math.isfinite(m.miou)):
            raise AssertionError(f"{model}: cli.eval of the import gives no figure")
    return out


# --- phases 72-74: the kernels as custom ops, cli.export ----------------------------

# the launches of one evaluation forward a model's artifact must repeat
EXPORT_LAUNCHES = {**{m: {k: v for k, v in c.items() if v} for m, c in
                      {**GEOMETRY_LAUNCHES, **CLS_LAUNCHES, **PS_LAUNCHES}.items()},
                   "randla": {"knn": 10}, "resgcn": {"knn": 4}}
EXPORT_ATOL = 1e-5  # the round-trip tolerance of both packages' cli.export --check
# the CPU legs of RandLA and ResGCN-28 run artifacts exported again at
# fewer points (RandLA at phase 13's cloud): at full size the plain kNN
# pyramid of 40960 points takes the CPU tens of seconds a forward, and
# ResGCN's 24 stable sorts of [4096, 4096] some 15 s
EXPORT_CPU_CUTS = {"randla": ["--randla_points", "8192"], "resgcn": ["--num_point", "1024"]}
EXPORT_WORKERS = 6  # processes that share the exports (tracing is host work),
# each with 2 CPU threads (``EXPORT_THREADS``): 8 cores on the card's host;
# six, one for each long trace (4 until the several-rank phases came: 83.4
# s on an H100 host, the four long traces' workers the last to finish)
EXPORT_THREADS = "2"
# the CPU leg's threads, the live model's and the artifact's alike: a CPU
# reduction's order, and so its last bits, follows the thread count
EXPORT_CPU_THREADS = 4
# phase 74's processes a leg (card, CPU): one a leg until the several-rank
# phases came, 50.5 and 51.9 s on an H100 host, nearly all of it loads
RELOAD_SPLIT = 2


def phase_opcheck(dev) -> dict:
    """72. ``torch.library.opcheck`` of the six ``psg::`` ops on the card, at
    one slice shape each (schema, autograd registration, fake against the
    kernel, AOT dispatch); the three ops with a gradient on inputs that
    require one. The CUDA implementations run here, so the launch counters
    move; no path reads them from this phase."""
    from pointsecguard_tpu_torch.ops import cuda as kernels  # noqa: F401  (psg::*)

    gen = torch.Generator(device=dev).manual_seed(72)

    def rand(*shape, grad=False):
        return torch.rand(shape, generator=gen, device=dev).requires_grad_(grad)

    K, M = 16, RANDLA_BATCH * RANDLA_POINTS
    cases = {
        "fps": ((rand(BATCH, NUM_POINT, 3), 1024,
                 torch.zeros(BATCH, dtype=torch.int32, device=dev)),
                "SSG's first FPS, [8, 4096] -> 1024"),
        "bottom_k": ((rand(BATCH, 1024, NUM_POINT, grad=True), 32),
                     "SSG's first ball query, [8, 1024, 4096] k = 32"),
        "bottom_k_chunked": ((rand(1, 4096, RANDLA_POINTS, grad=True), 16),
                             "a tiled 40960-wide block, [1, 4096, 40960] k = 16"),
        "knn": ((*(2 * (rand(RANDLA_BATCH, RANDLA_POINTS, 3),)), 16),
                "RandLA's first self-search, [4, 40960, 3] k = 16"),
        "attentive_fwd": ((rand(K, M, 8, grad=True), rand(K, M, 8, grad=True),
                           rand(16, 16, grad=True)), "[16, 163840, 8]"),
        "attentive_bwd": ((rand(K, M, 8), rand(K, M, 8), rand(16, 16), rand(M, 8),
                           rand(M, 8), True), "[16, 163840, 8] with dW"),
    }
    out = {}
    for name, (args, shape) in cases.items():
        t0 = time.perf_counter()
        result = torch.library.opcheck(getattr(torch.ops.psg, name).default, args)
        torch.cuda.synchronize()
        out[name] = {"shape": shape, "s": time.perf_counter() - t0, **result}
        if any(v != "SUCCESS" for v in result.values()):
            raise AssertionError(f"opcheck psg::{name}: {result}")
    print("opcheck: " + json.dumps(out))
    return out


def _export_argv(model: str, log: str, out: str, flags=()) -> list:
    return ["--model", model, "--log_dir", log, "--output", out, "--check", *flags]


def _live_forward(model_name: str, log: str, dev, flags=()):
    """(model, example inputs, call) as ``cli.export`` serves them, with
    the log's checkpoint restored, on ``dev``."""
    from pointsecguard_tpu_torch.cli import export as export_cli
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.runtime import model_dtype

    args = export_cli._parser().parse_args(_export_argv(model_name, log, "-", flags))
    model, example, call = export_cli.served_model(args, model_dtype(args.precision))
    model.load_state_dict(load_checkpoint(log))
    return model.to(dev).eval().requires_grad_(False), example, call


def _run_processes(jobs: list, workers: int, timeout: float, **env_extra) -> list:
    """Run ``jobs`` ([(argv, log path)]) as subprocesses, ``workers`` at a
    time, each writing its output to its log; (return code, wall s) of each,
    in order. Every process is waited for (one past ``timeout`` is killed)."""
    results, running, queue = [None] * len(jobs), {}, list(enumerate(jobs))
    env = {**os.environ, **env_extra, "PYTHONPATH": os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])])}
    while queue or running:
        while queue and len(running) < workers:
            k, (argv, log) = queue.pop(0)
            with open(log, "w") as out:
                proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, cwd=REPO,
                                        env=env)
            running[k] = (proc, time.perf_counter())
        for k, (proc, t0) in list(running.items()):
            if proc.poll() is None and time.perf_counter() - t0 > timeout:
                proc.kill()
            if proc.poll() is not None:
                results[k] = (proc.wait(), time.perf_counter() - t0)
                del running[k]
        time.sleep(0.2)
    return results


def phase_export(dev, records, logs: dict) -> dict:
    """73. ``python -m pointsecguard_tpu_torch.cli.export --check`` (on the
    card) of the eleven models at full width and their task's default
    points, batch 1, from the checkpoints the earlier phases trained
    (``logs``: model → (log dir, flags)), of SSG again with ``--precision
    bfloat16`` and of RandLA and ResGCN again at ``EXPORT_CPU_CUTS``' points
    for the CPU leg of phase 74: ``cli.export.main`` in ``EXPORT_WORKERS``
    processes that share the jobs (seconds of each under that sharing).
    Then, alone on the card, the live model restored as the CLI restores
    it, on the CLI's own probe: its launches of one forward
    (``EXPORT_LAUNCHES``), its ms a forward and its outputs on the card and
    on the CPU, saved beside each artifact for phase 74."""
    from pointsecguard_tpu_torch.cli import export as export_cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    root = os.path.join(WORK, "export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cases = [(m, m, log, flags) for m, (log, flags) in logs.items()]
    cases += [("pointnet2 --precision bfloat16", "pointnet2", logs["pointnet2"][0],
               ["--precision", "bfloat16"])]
    cases += [(f"{m} {cut[-1]}", m, logs[m][0], cut) for m, cut in EXPORT_CPU_CUTS.items()]
    cases = [(label, model, log, [*flags, "--platforms", "cuda,cpu"],
              os.path.join(root, f"art{i}")) for i, (label, model, log, flags) in enumerate(cases)]
    # the jobs dealt round the workers, the longest traces (ResGCN, RandLA,
    # MSG: the most nodes) first
    order = sorted(cases, key=lambda c: -["resgcn", "randla", "pointnet2_msg",
                                           "pointnet2_part_seg_msg"].count(c[1]))
    shares = [order[w::EXPORT_WORKERS] for w in range(EXPORT_WORKERS)]
    logs_w = [os.path.join(root, f"worker{w}.log") for w in range(EXPORT_WORKERS)]
    runs = _run_processes(
        [([sys.executable, "-c", _EXPORT_SCRIPT, json.dumps(
            [(label, _export_argv(model, log, art, flags))
             for label, model, log, flags, art in share])], log_w)
         for share, log_w in zip(shares, logs_w)], EXPORT_WORKERS, timeout=900,
        OMP_NUM_THREADS=EXPORT_THREADS)
    seconds = {}
    for share, log_w, (code, _) in zip(shares, logs_w, runs):
        with open(log_w) as f:
            text = f.read()
        done = [json.loads(line.split(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("EXPORTED ")]
        if code != 0 or len(done) != len(share) or \
                text.count("round-trip check OK") != len(share):
            raise AssertionError(f"cli.export --check of {[c[0] for c in share]} exited "
                                 f"{code}:\n{text[-4000:]}")
        seconds.update({d["label"]: d["s"] for d in done})
    out = {}
    for label, model, log, flags, art in cases:
        net, example, call = _live_forward(model, log, dev, flags)
        probes = export_cli.probes(example)
        cuda_in = [p.to(dev) for p in probes]
        with torch.no_grad():
            call(net, *cuda_in)  # warm
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            live = call(net, *cuda_in)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            ms = cuda_ms(lambda: call(net, *cuda_in), reps=5)
            cpu_leg = model not in EXPORT_CPU_CUTS or EXPORT_CPU_CUTS[model][0] in flags
            threads = torch.get_num_threads()
            torch.set_num_threads(EXPORT_CPU_THREADS)
            t0 = time.perf_counter()
            live_cpu = call(net.cpu(), *probes) if cpu_leg else None
            cpu_s = time.perf_counter() - t0
            torch.set_num_threads(threads)
        np.savez(os.path.join(art, "live.npz"),
                 **{f"in{j}": p.numpy() for j, p in enumerate(probes)},
                 cuda=live.float().cpu().numpy(),
                 **({"cpu": live_cpu.float().numpy()} if cpu_leg else {}))
        out[label] = {"artifact": art, "export_s": seconds[label], "live_ms": ms,
                      "live_cpu_s": cpu_s if cpu_leg else None, "live_launches": counts,
                      "cpu_leg": cpu_leg,
                      "forward_pt2_mb": os.path.getsize(os.path.join(art, "forward.pt2")) / 1e6}
        print(f"{label} cli.export --check: " + json.dumps(out[label]))
        want = EXPORT_LAUNCHES[model]
        if counts != want:
            raise AssertionError(f"{label}: the live forward launched {counts}, want {want}")
    print("export launches of one forward: " + json.dumps(
        {label: r["live_launches"] for label, r in out.items()}))
    return out


_EXPORT_SCRIPT = r"""
import json, sys, time
from pointsecguard_tpu_torch.cli import export
for label, argv in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    export.main(argv)
    print("EXPORTED " + json.dumps({"label": label, "s": time.perf_counter() - t0}), flush=True)
"""

_RELOAD_SCRIPT = r"""
import json, sys, time
import numpy as np, torch
from pointsecguard_tpu_torch.ops import cuda as kernels
from pointsecguard_tpu_torch.utils.export import load_artifact

device, jobs = sys.argv[1], json.loads(sys.argv[2])
if device == "cpu":
    torch.set_num_threads(int(sys.argv[3]))  # the live model's CPU threads

def card_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]

out = {}
for label, art in jobs:
    live = np.load(art + "/live.npz")
    inputs = [torch.from_numpy(live[k]).to(device) for k in sorted(live.files)
              if k.startswith("in")]
    t0 = time.perf_counter()
    forward, meta = load_artifact(art, device)
    rec = {"load_s": time.perf_counter() - t0, "precision": meta["precision"]}
    if device == "cuda":
        forward(*inputs)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = forward(*inputs)
    if device == "cuda":
        torch.cuda.synchronize()
        rec["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
        rec["ms"] = card_ms(lambda: forward(*inputs))
    else:
        rec["forward_s"] = time.perf_counter() - t0
    rec["max_abs_err"] = float(np.abs(got.float().cpu().numpy() - live[device]).max())
    out[label] = rec
out["modules"] = sorted(m for m in sys.modules if m.startswith("pointsecguard_tpu"))
print(json.dumps(out))
"""


def phase_reload(records, exported: dict) -> dict:
    """74. The artifacts of phase 73 reloaded in fresh ``python -c``
    processes that import no model code (``load_artifact`` only; checked on
    their ``sys.modules``), ``RELOAD_SPLIT`` a leg: on the card, where each artifact repeats the
    live forward's launches (``EXPORT_LAUNCHES``) and its outputs within
    ``EXPORT_ATOL``, and beside them on the CPU (``EXPORT_CPU_THREADS``
    threads, as the live model's CPU run; RandLA's 8192-point artifact),
    within ``EXPORT_ATOL`` of the live model's CPU outputs. Load seconds and ms a forward beside the live model's."""
    # each leg in RELOAD_SPLIT processes, all at once (the loads are host work)
    legs = [(dev, part, jobs[part::RELOAD_SPLIT]) for dev, jobs in (
        ("cuda", [(label, r["artifact"]) for label, r in exported.items()]),
        ("cpu", [(label, r["artifact"]) for label, r in exported.items() if r["cpu_leg"]]))
        for part in range(RELOAD_SPLIT)]
    logs = [os.path.join(WORK, "export", f"reload_{dev}_{part}.log") for dev, part, _ in legs]
    runs = _run_processes([([sys.executable, "-c", _RELOAD_SCRIPT, dev, json.dumps(jobs),
                             str(EXPORT_CPU_THREADS)], log)
                           for (dev, _, jobs), log in zip(legs, logs)], len(legs), timeout=900)
    got = {"cuda": {}, "cpu": {}}
    for (dev, part, _), log, (code, wall) in zip(legs, logs, runs):
        with open(log) as f:
            text = f.read()
        if code != 0:
            raise AssertionError(f"the {dev} reload process exited {code}:\n{text[-6000:]}")
        result = json.loads(text.strip().splitlines()[-1])
        modules = result.pop("modules")
        got[dev].update(result)
        print(f"reload process ({dev}, {part}): {wall:.1f} s, modules {modules}")
        if any(m.startswith(("pointsecguard_tpu_torch.models", "pointsecguard_tpu."))
               for m in modules) or "pointsecguard_tpu_torch.utils.export" not in modules:
            raise AssertionError(f"the {dev} reload process imported {modules}")
    out = {}
    for label, live in exported.items():
        card, cpu = got["cuda"][label], got["cpu"].get(label)
        out[label] = {"export_s": live["export_s"], "load_s": card["load_s"],
                      "ms": card["ms"], "live_ms": live["live_ms"],
                      "ms_ratio": card["ms"] / live["live_ms"],
                      "launches": card["launches"], "max_abs_err": card["max_abs_err"],
                      **({"cpu_load_s": cpu["load_s"], "cpu_forward_s": cpu["forward_s"],
                          "live_cpu_forward_s": live["live_cpu_s"],
                          "cpu_max_abs_err": cpu["max_abs_err"]} if cpu else {})}
        print(f"{label} reloaded: " + json.dumps(out[label]))
        if card["launches"] != live["live_launches"]:
            raise AssertionError(f"{label}: the artifact launched {card['launches']}, "
                                 f"the live forward {live['live_launches']}")
        errs = [card["max_abs_err"]] + ([cpu["max_abs_err"]] if live["cpu_leg"] else [])
        if live["cpu_leg"] != (cpu is not None) or not all(
                math.isfinite(e) and e <= EXPORT_ATOL for e in errs):
            raise AssertionError(f"{label}: artifact against the live model {errs} "
                                 f"over {EXPORT_ATOL}")
    print("artifact launches of one forward (card): " + json.dumps(
        {label: r["launches"] for label, r in out.items()}))
    for name, path in (("fps", "pointnet2 export"), ("bottom_k", "pointnet2 export"),
                       ("knn", "randla export")):
        records[name]["launches_by_path"][path] = out[path.split()[0]]["launches"][name]
    return out


# --- several ranks (phases 75-78) ----------------------------------------------
#
# The card's machine has one card, so the ranks of phases 75-77 share
# cuda:0 under gloo (NCCL takes one rank a card); phase 78 runs NCCL at
# the machine's card count. Every rank is a process of its own: ``spawn``
# starts it, and it runs a program of ``parallel/dryrun.py``.
SP_RANKS = (2, 4)  # phase 75's points ranks
# phase 77 (see phase_parallel): the SSG schedule's floor, and the bounds
# the DP run is held to against one process
DP_TRAIN_LR, DP_LOSS_RTOL, DP_EVAL_ATOL = 1e-5, 1e-5, 1e-3


# phase 81: what the two ranks' cli.benchmark and --log_steps runs may part
# from one process's on the card, where each rank's GEMMs are half the size
# and round apart: the share of per-point (per-sample) integer and boolean
# outcomes that differ, and the largest difference of a float (relative
# above 1, absolute below)
DP_BENCH_POINTS, DP_BENCH_FLOAT = 0.02, 0.05
# phase 81's cli.benchmark runs: the flags of phase 48's or 49's run
DP_BENCH_RUNS = {
    "prediction": ["--mode", "prediction"],
    "pgd": ["--mode", "attack", "--attack_name", "pgd"],
    "nes": ["--mode", "attack", "--attack_name", "nes", "--samples", str(SCORE_BUDGET["nes"]),
            "--iters", str(SCORE_ITERS)],
    "distortion": ["--mode", "distortion", "--attack_name", "pgd"],
    "worstcase": ["--mode", "worstcase", "--attack_names", "pgd,nes"]}


def result_gap(got, want) -> dict:
    """How far two nested results of one harness lie apart, over every
    leaf of their dicts, lists and tuples: ``points``, the largest share of
    the integer and boolean entries of a leaf that differ; ``float``, the
    largest |a − b| / max(|b|, 1) of a float entry (equal infinities
    equal); ``shape``, whether the two differ in structure or length."""
    gap = {"points": 0.0, "float": 0.0, "shape": False}

    def walk(g, w):
        if isinstance(w, dict):
            if not isinstance(g, dict) or sorted(g) != sorted(w):
                gap["shape"] = True
                return
            for k in w:
                walk(g[k], w[k])
        elif isinstance(w, (list, tuple)) and not all(
                isinstance(v, (int, float, bool, np.generic)) for v in w):
            if not isinstance(g, (list, tuple)) or len(g) != len(w):
                gap["shape"] = True
                return
            for a, b in zip(g, w):
                walk(a, b)
        elif w is None or isinstance(w, str):
            gap["shape"] |= g != w
        else:
            a, b = np.asarray(g), np.asarray(w)
            if a.shape != b.shape:
                gap["shape"] = True
            elif b.size and b.dtype.kind in "biu":
                gap["points"] = max(gap["points"], float((a != b).mean()))
            elif b.size:
                same = (a == b) | (np.isnan(a) & np.isnan(b))
                with np.errstate(invalid="ignore"):
                    d = np.where(same, 0.0, np.abs(a - b) / np.maximum(np.abs(b), 1.0))
                gap["float"] = max(gap["float"], float(np.nan_to_num(d, nan=np.inf).max()))

    walk(got, want)
    return gap


def _gloo_mesh(n: int, points: int = 1):
    from pointsecguard_tpu_torch.parallel import make_mesh

    return make_mesh(["cuda:0"] * n, points_axis=points, backend="gloo")


def _check_pyramid(res: dict, one: dict, n: int, shape) -> None:
    """A rank's points-sharded pyramid against the one-process pyramid."""
    for f in ("neigh_idx", "sub_idx", "interp_idx"):
        for lvl, (got, want) in enumerate(zip(res[f], one[f])):
            if not np.array_equal(got, want):
                raise AssertionError(f"{n} ranks: {f} level {lvl} differs from the "
                                     "one-process pyramid")
    if res["launches"] != 10 or list(res["query_shape"]) != list(shape):
        raise AssertionError(f"{n} ranks: {res['launches']} kNN launches on "
                             f"{res['query_shape']}, want 10 on {shape}")


def _train_events(log: str) -> tuple:
    events = read_events(log)
    return ([e for e in events if e["event"] == "epoch"],
            [e for e in events if e["event"] == "eval"])


def phase_parallel(dev, records, prep: str, train_data: str, train_log: str,
                   one_process: dict) -> dict:
    """Phases 75–77 and 81. The one-process runs come first, in this
    process (phase 81's were made by phases 43, 48 and 49: ``one_process``)
    while one start of four ranks on the card gets ready (they wait for
    ``ranks_go`` before they run anything on it); then these ranks carry every
    multi-rank program: as 2 × 2 phase 75's 1 × 4 pyramid (on a points view of them)
    and phase 76's dry run, then on the first two ranks alone
    (``dryrun.programs``' ``ranks``; the other two wait) phase 75's 1 × 2
    pyramid, phase 77's RandLA NB with ``--shard_points 2`` and, on a data
    view of the two, its SSG ``cli.train --devices 2`` and phase 81's runs.
    Each phase prints its seconds: its one-process runs and its programs on
    the ranks (the slowest rank); the start-up prints its own.

    75. ``knn_points_sharded`` at RandLA's pyramid shapes: the pyramid of
        one sampler batch of [4, 40960] clouds built with the points axis
        over 2 and over 4 ranks, every level's index tables bit-equal to the
        one-process ``psg::knn`` pyramid, 10 launches a rank, each on its
        query shard; the card ms of the top level's self-kNN on a rank's
        query shard beside the whole cloud's, with its bound and its plain
        version's time (``sharded_query``).
    76. ``parallel.dryrun``'s six programs on 2 × 2 ranks held to their
        one-process runs (``check_dryrun``).
    77. The slice at full width through the CLI bodies
        (``parallel.dryrun.cli_program``: ``cli.train._train`` and
        ``cli.attack._attack``, as ``--devices N`` starts them one card
        each). SSG ``cli.train`` at 32 × 4096, one epoch (13 steps) and its
        eval, data-parallel over 2 ranks, against the one-process run of
        the same arguments: the epoch loss within ``DP_LOSS_RTOL``, the
        eval accuracy and mIoU within ``DP_EVAL_ATOL``, 4 FPS and 8 bottom-k
        launches a rank a step and eval batch. The lr is ``DP_TRAIN_LR``
        (the floor of the SSG schedule): Adam turns the gradients' rounding
        (the ranks sum in another order, and the random-initialised network
        amplifies it; ``parallel/dryrun.py``) into ±lr steps, which at the
        training lr would part the two runs whatever the code, and the
        eval's argmax of a net this far from trained sits near ties that
        the ranks' half-size GEMMs round apart. RandLA NB on 4 × 40960
        clouds with ``--devices 2 --shard_points 2`` against the one-process
        run of the same clouds and checkpoint (phase 7's, the reference
        pooling), both under ``torch.use_deterministic_algorithms``: the TSV
        equal, ``time_s`` aside; 10 kNN launches a rank a batch.
    81. ``cli.benchmark --devices 2`` (``cli.benchmark._benchmark`` on the
        data view) on the trained SSG, one batch of 8 × 4096, each run
        with phase 48's or 49's arguments and held to its one-process
        result there (``result_gap``: at most ``DP_BENCH_POINTS`` of the
        per-point outcomes differ, floats within ``DP_BENCH_FLOAT``):
        ``--mode prediction`` (ys equal), ``attack`` pgd and nes, ``distortion``
        pgd and ``worstcase`` pgd,nes; 4 FPS and 8 bottom-k launches a rank
        and batch, whatever the queries (8 and 16 for the worst case). And
        ``cli.attack --attack nb --control --log_steps --devices 2`` on two
        batches, held to phase 43's run of the same flags: the
        ``_steps.tsv`` rank 0 writes has its rows, acc and sr within
        ``DP_BENCH_FLOAT``, l2 within ``DP_BENCH_FLOAT`` relative."""
    from pointsecguard_tpu_torch.ops.cuda import bounds, knn
    from pointsecguard_tpu_torch.parallel import spawn
    from pointsecguard_tpu_torch.parallel import dryrun

    seconds = {75: 0.0, 76: 0.0, 77: 0.0, 81: 0.0}
    # the ranks' inputs first: the ranks start up (imports, CUDA, groups)
    # while this process makes the one-process runs, and wait for a file
    # before they touch the card
    xyz = randla_batch(prep, dev)[..., :3].contiguous()
    xyz_np = xyz.cpu().numpy()
    B, N, _ = xyz_np.shape
    inp = dryrun.dryrun_inputs(2, 4)
    log1, log2 = (os.path.join(WORK, f"dp_train_{n}") for n in (1, 2))
    train_argv = ["--model", "pointnet2", "--data_root", train_data, "--npoint",
                  str(NUM_POINT), "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
                  "--learning_rate", str(DP_TRAIN_LR)]
    ref_log, sp_log = (os.path.join(WORK, d) for d in ("randla_dp_ref_log", "randla_sp_log"))
    for d in (ref_log, sp_log):
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(WORK, "randla_log", "checkpoints"),
                        os.path.join(d, "checkpoints"))
    attack_argv = ["--model", "randla", "--attack", "nb", "--randla_dir", prep,
                   "--num_clouds", str(RANDLA_CLOUDS), "--batch_size", str(RANDLA_BATCH)]
    # phase 81's arguments: phase 48's and 49's runs, and phase 43's
    # --control --log_steps in a log of its own
    steps_log = os.path.join(WORK, "dp_steps_log")
    shutil.rmtree(steps_log, ignore_errors=True)
    shutil.copytree(os.path.join(train_log, "checkpoints"), os.path.join(steps_log, "checkpoints"))
    two = ["--devices", "2"]
    bench_argv = {name: _bench_argv(train_data, train_log, *flags, *two)
                  for name, flags in DP_BENCH_RUNS.items()}
    bench_argv["prediction"] += ["--output", os.path.join(WORK, "dp_predictions.npz")]
    steps_argv = ["--model", "pointnet2", "--data_root", train_data, "--log_dir", steps_log,
                  "--num_point", str(NUM_POINT), "--batch_size", str(BATCH), "--max_blocks",
                  str(PROTOCOL_BATCHES * BATCH), *STEPS_FLAGS, *two]
    go = os.path.join(WORK, "ranks_go")
    # four ranks, 2 × 2; then the first two alone
    pair = {"ranks": 2}
    data_pair = {"ranks": 2, "view": "data"}
    calls = [("wait_program", (go,), {}),
             ("pyramid_timing_program", (xyz_np,), {"view": "points"}),
             ("dryrun_programs", (inp, "cuda"), {}),
             ("pyramid_timing_program", (xyz_np,), pair),
             ("cli_program", ("attack", attack_argv + ["--log_dir", sp_log, *two,
                                                       "--shard_points", "2"], True), pair),
             ("cli_program", ("train", train_argv + ["--log_dir", log2, *two]), data_pair),
             *(("cli_program", ("benchmark", argv), data_pair) for argv in bench_argv.values()),
             ("cli_program", ("attack", steps_argv), data_pair)]
    box: dict = {}

    def run_ranks():
        try:
            box["ranks"] = spawn(dryrun.timed_programs, _gloo_mesh(4, 2), (calls,))
        except BaseException as e:  # raised again below, in this thread
            box["error"] = e

    spawned = time.perf_counter()
    ranks_thread = threading.Thread(target=run_ranks)
    ranks_thread.start()
    try:
        # the one-process runs
        t0 = time.perf_counter()
        one = dryrun.pyramid_timing_program(None, xyz_np)
        if one["launches"] != 10:
            raise AssertionError(f"one-process pyramid: {one['launches']} kNN launches, "
                                 "want 10")
        plain = {n: cuda_ms(lambda: knn.knn_plain(xyz[:, : N // n].contiguous(), xyz, 16),
                            reps=1, warmup=0) for n in (1, *SP_RANKS)}
        seconds[75] += time.perf_counter() - t0
        t0 = time.perf_counter()
        one_dry = dryrun.dryrun_programs(None, inp, "cuda")
        seconds[76] += time.perf_counter() - t0
        t0 = time.perf_counter()
        _, counts1 = dryrun.cli_program(None, "train", train_argv + ["--log_dir", log1])
        # RandLA NB, one process and ranks alike under deterministic
        # algorithms: the gathers' backward otherwise adds with atomics, in
        # an order that moves PGD's sign steps from one run to the next on
        # one process too
        dryrun.cli_program(None, "attack", attack_argv + ["--log_dir", ref_log], True)
        seconds[77] += time.perf_counter() - t0
    finally:
        # the ranks share the card with this process: its cached blocks go
        # first
        torch.cuda.empty_cache()
        open(go, "w").close()
        ranks_thread.join()
    if "error" in box:
        raise box["error"]
    wall = time.perf_counter() - spawned
    ranks = [r[1:] for r in box["ranks"]]
    waited = max(r[0][0] for r in box["ranks"])
    start = wall - waited - max(sum(t for _, t in r) for r in ranks)
    ranks4, ranks2 = ranks, [r[2:] for r in ranks[:2]]
    seconds[75] += max(r[0][1] for r in ranks4) + max(r[0][1] for r in ranks2)
    seconds[76] += max(r[1][1] for r in ranks4)
    seconds[77] += max(r[1][1] + r[2][1] for r in ranks2)
    seconds[81] += max(sum(t for _, t in r[3:]) for r in ranks2)

    # 75
    t0 = time.perf_counter()
    rows = [{"ranks": 1, "query": [B, N, 3], "points": [B, N, 3], "ms": one["device_ms"],
             "bound_ms": bounds.knn(B, N, N, 3, 16).bound_ms,
             "bound_by": bounds.knn(B, N, N, 3, 16).bound_by, "plain_ms": plain[1],
             "launches_per_rank": one["launches"]}]
    for n, res in ((2, [r[0][0] for r in ranks2]), (4, [r[0][0] for r in ranks4])):
        for r in res:
            _check_pyramid(r, one, n, [B, N // n, 3])
        work = bounds.knn(B, N // n, N, 3, 16)
        row = {"ranks": n, "query": [B, N // n, 3], "points": [B, N, 3],
               "ms": [r["device_ms"] for r in res], "bound_ms": work.bound_ms,
               "bound_by": work.bound_by, "plain_ms": plain[n],
               "launches_per_rank": [r["launches"] for r in res]}
        rows.append(row)
        _record_path(records, "knn", f"randla pyramid --shard_points {n}",
                     sum(r["launches"] for r in res))
        print(f"knn_points_sharded, {n} ranks of cuda:0 (gloo): every level bit-equal to "
              f"the one-process pyramid; per rank {row['launches_per_rank']} psg::knn "
              f"launches on [{B}, {N // n}, 3] query shards, the top level "
              f"{[round(m, 4) for m in row['ms']]} ms a rank against {one['device_ms']:.4f} "
              f"ms whole (bound {work.bound_ms:.4f} ms, plain {plain[n]:.1f} ms)")
    records["knn"]["sharded_query"] = rows
    seconds[75] += time.perf_counter() - t0

    # 76
    t0 = time.perf_counter()
    diffs = dryrun.check_dryrun([r[1][0] for r in ranks4], one_dry, 2)
    print("dryrun_multichip, 2 x 2 ranks of cuda:0 (gloo): " + json.dumps(
        {"ssg_loss": float(one_dry["ssg_float32"][0][0]),
         "resgcn_loss": float(one_dry["resgcn_float32"][0][0]), "diffs": diffs}))
    seconds[76] += time.perf_counter() - t0

    # 77
    t0 = time.perf_counter()
    (ep1, va1), (ep2, va2) = _train_events(log1), _train_events(log2)
    if len(ep2) != 1 or ep2[0]["batches"] != ep1[0]["batches"] or ep2[0]["nan_batches"]:
        raise AssertionError(f"--devices 2 epochs: {ep2}")
    if abs(ep2[0]["loss"] - ep1[0]["loss"]) > DP_LOSS_RTOL * abs(ep1[0]["loss"]):
        raise AssertionError(f"--devices 2 epoch loss {ep2[0]['loss']} against one "
                             f"process's {ep1[0]['loss']}")
    if len(va2) != len(va1) or any(abs(a[k] - b[k]) > DP_EVAL_ATOL for a, b in zip(va1, va2)
                                   for k in ("accuracy", "miou")):
        raise AssertionError(f"--devices 2 eval {va2} against one process's {va1}")
    steps = ep1[0]["batches"]
    eval_batches = (counts1["fps"] - 4 * steps) // 4
    train_counts = [r[2][0][1] for r in ranks2]
    for r, counts in enumerate(train_counts):
        for name, per in (("fps", 4), ("bottom_k", 8)):
            if counts[name] != per * (steps + eval_batches):
                raise AssertionError(f"rank {r}: {counts[name]} {name} launches, want {per} a "
                                     f"step and eval batch ({steps} + {eval_batches})")
    for name in ("fps", "bottom_k"):
        _record_path(records, name, "pointnet2 train --devices 2",
                     sum(c[name] for c in train_counts))
    out = {"train": {"steps": steps, "eval_batches": eval_batches,
                     "loss": [ep1[0]["loss"], ep2[0]["loss"]],
                     "eval": [[(e["accuracy"], e["miou"]) for e in va] for va in (va1, va2)],
                     "rank_s": [r[2][1] for r in ranks2],
                     "launches_per_rank": train_counts}}
    print("cli.train._train --devices 2 (2 ranks of cuda:0, gloo, a data view) against one "
          "process: " + json.dumps(out["train"]))
    want, got = (read_tsv(os.path.join(d, "randla_nb_area5.tsv")) for d in (ref_log, sp_log))
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time_s"} for r in rows]
    if strip(got) != strip(want) or len(got) != RANDLA_CLOUDS:
        raise AssertionError("randla nb --devices 2 --shard_points 2: the TSV differs from "
                             f"the one-process run's:\n{got}\n{want}")
    batches = RANDLA_CLOUDS // RANDLA_BATCH
    attack_counts = [r[1][0][1] for r in ranks2]
    for r, counts in enumerate(attack_counts):
        if counts["knn"] != 10 * batches:
            raise AssertionError(f"rank {r}: {counts['knn']} kNN launches, want 10 a batch")
    _record_path(records, "knn", "randla nb --devices 2 --shard_points 2",
                 sum(c["knn"] for c in attack_counts))
    out["randla_nb"] = {"rows": len(got), "rank_s": [r[1][1] for r in ranks2],
                        "ms_per_cloud": [1e3 * float(r["time_s"]) for r in got],
                        "ms_per_cloud_one_process": [1e3 * float(r["time_s"]) for r in want],
                        "launches_per_rank": attack_counts}
    print("cli.attack._attack --model randla --devices 2 --shard_points 2 (2 ranks of "
          "cuda:0, gloo): TSV equal to the one-process run's, time_s aside; "
          + json.dumps(out["randla_nb"]))
    seconds[77] += time.perf_counter() - t0

    # 81
    t0 = time.perf_counter()
    gaps, bench_counts = {}, {"fps": 0, "bottom_k": 0}
    for i, name in enumerate(bench_argv):
        for r, rank in enumerate(ranks2):
            (result, counts), _ = rank[3 + i]
            per = 2 if name == "worstcase" else 1
            if (counts["fps"], counts["bottom_k"], counts["knn"]) != (4 * per, 8 * per, 0):
                raise AssertionError(f"benchmark {name} --devices 2, rank {r}: launches "
                                     f"{counts}, want fps {4 * per} and bottom_k {8 * per}")
            for k in bench_counts:
                bench_counts[k] += counts[k]
            gap = result_gap(result, one_process["benchmark"][name])
            gaps.setdefault(name, []).append(gap)
            if gap["shape"] or gap["points"] > DP_BENCH_POINTS or gap["float"] > DP_BENCH_FLOAT:
                raise AssertionError(f"benchmark {name} --devices 2, rank {r}: {gap} from the "
                                     f"one-process run (bounds {DP_BENCH_POINTS}, "
                                     f"{DP_BENCH_FLOAT})")
    ys_one = one_process["benchmark"]["prediction"][0]
    with np.load(os.path.join(WORK, "dp_predictions.npz")) as f:
        if not np.array_equal(f["ys"], ys_one):
            raise AssertionError("benchmark prediction --devices 2: rank 0's ys differ")
    for k, v in bench_counts.items():
        _record_path(records, k, "pointnet2 benchmark --devices 2", v)
    steps_counts = [r[8][0][1] for r in ranks2]
    for r, counts in enumerate(steps_counts):
        if (counts["fps"], counts["bottom_k"]) != (4 * PROTOCOL_BATCHES, 8 * PROTOCOL_BATCHES):
            raise AssertionError(f"nb --log_steps --devices 2, rank {r}: launches {counts}")
    for k in ("fps", "bottom_k"):
        _record_path(records, k, "pointnet2 nb --log_steps --devices 2",
                     sum(c[k] for c in steps_counts))
    got = read_tsv(os.path.join(steps_log, "pointnet2_nb_area5_steps.tsv"))
    want = read_tsv(one_process["steps_tsv"])
    steps_gap = {c: max((abs(float(a[c]) - float(b[c])) / max(abs(float(b[c])), 1.0)
                         for a, b in zip(got, want)), default=0.0) for c in ("acc", "sr", "l2")}
    if len(got) != len(want) or len(got) != 10 * PROTOCOL_BATCHES or \
            [(a["block"], a["iter"]) for a in got] != [(b["block"], b["iter"]) for b in want] \
            or max(steps_gap.values()) > DP_BENCH_FLOAT:
        raise AssertionError(f"nb --log_steps --devices 2: {len(got)} steps rows against "
                             f"{len(want)}, gaps {steps_gap}")
    out["benchmark"] = {"gaps": gaps, "rank_s": {
        name: [r[3 + i][1] for r in ranks2] for i, name in enumerate(bench_argv)},
        "launches": bench_counts}
    out["log_steps"] = {"rows": len(got), "gaps": steps_gap, "rank_s": [r[8][1] for r in ranks2],
                        "launches_per_rank": steps_counts}
    print("cli.benchmark._benchmark --devices 2 (2 ranks of cuda:0, gloo, a data view) "
          "against phases 48-49's one-process runs: " + json.dumps(out["benchmark"]))
    print("cli.attack._attack nb --control --log_steps --devices 2 against phase 43's run: "
          + json.dumps(out["log_steps"]))
    seconds[81] += time.perf_counter() - t0
    print(f"rank start-up and teardown: 4 ranks, once, {start:.1f} s beside this process's "
          f"one-process runs, for which the ranks then waited {waited:.1f} s")
    for number, sec in seconds.items():
        print(f"phase {number}: {sec:.1f} s")
    return {"rows": rows, "diffs": diffs, **out}


def phase_nccl(dev, records, prep: str) -> dict:
    """An NCCL group at ``world_size = torch.cuda.device_count()`` ranks,
    one card each: one all-reduce and ``knn_points_sharded`` over the
    group on the top level of a RandLA batch, its indices against the
    one-process kNN."""
    from pointsecguard_tpu_torch.ops.cuda import knn
    from pointsecguard_tpu_torch.parallel import make_mesh, spawn
    from pointsecguard_tpu_torch.parallel import dryrun

    n = torch.cuda.device_count()
    xyz = randla_batch(prep, dev)[..., :3].contiguous()
    _, want = knn.knn(xyz, xyz, 16)
    want = want.cpu().numpy()
    # one rank runs in this process (parallel.spawn)
    ranks = spawn(dryrun.collective_program,
                  make_mesh([f"cuda:{i}" for i in range(n)], points_axis=n, backend="nccl"),
                  (xyz.cpu().numpy(),))
    shard = xyz.shape[1] // n
    for r, (ids, _, idx, launches) in enumerate(ranks):
        if not np.all(ids == sum(range(n))):
            raise AssertionError(f"NCCL all-reduce on rank {r}: {ids}")
        if not np.array_equal(idx, want[:, r * shard : (r + 1) * shard]) or launches != 1:
            raise AssertionError(f"NCCL knn_points_sharded on rank {r} differs "
                                 f"({launches} launches)")
    _record_path(records, "knn", "knn_points_sharded nccl", sum(r[3] for r in ranks))
    note = ("" if n > 1 else "; NCCL across cards not run: this machine has one card")
    print(f"NCCL group of {n} rank(s), one card each: all-reduce and knn_points_sharded "
          f"on [{xyz.shape[0]}, {xyz.shape[1]}, 3] equal to one process{note}")
    return {"ranks": n}


# FPS above 8192 points (phase 82): (B, N, npoint, start, kernel, what).
# The first two are the first levels of a ModelNet classifier at 10,000
# points and of a 16,384-point block; 8192 / 8193 the seam between the
# register kernel and the cluster kernel, 131072 / 131073 the one between
# the cluster kernel's capacity (16 CTAs of 8192) and the streaming kernel
# (``kernel``: the counter of the kernel the contract gives that N,
# ``csrc/fps.cu``'s ``psg_fps_route``)
FPS_LARGE_SHAPES = (
    (16, 10000, 512, "zero", "fps_cluster", "a ModelNet 10k classifier's first level"),
    (8, 16384, 1024, "random", "fps_cluster", "a 16,384-point block's first level"),
    (2, 8192, 256, "random", "fps", "the seam: the register kernel's last N"),
    (2, 8193, 256, "random", "fps_cluster", "the seam: the cluster kernel's first N"),
    (2, 131072, 256, "random", "fps_cluster", "the seam: the cluster kernel's capacity"),
    (2, 131073, 256, "random", "fps_stream", "the seam: the streaming kernel's first N"),
)
# phase 82's NB: one batch of 16 test shapes written at 10,000 points
CLS_10K_POINTS, CLS_10K_PER_CLASS = 10_000, 4
CLS_10K_PATH = "pointnet2_cls nb --num_point 10000"
# and one of 2 shapes past the cluster kernel's capacity: the streaming FPS
CLS_WIDE_POINTS, CLS_WIDE_SHAPES = 131_104, 2
CLS_WIDE_PATH = f"pointnet2_cls nb --num_point {CLS_WIDE_POINTS}"


def _fps_took(before: dict, after: dict) -> str:
    """The counter of the FPS kernel that one ``psg::fps`` call took."""
    for name in ("fps_stream", "fps_cluster"):
        if after[name] > before[name]:
            return name
    return "fps"


def phase_fps_large_kernels(dev, records) -> dict:
    """82 (kernels). ``psg::fps`` above 8192 points against ``fps_plain`` on
    the card, indices equal, at ``FPS_LARGE_SHAPES`` (N = 8192 takes the
    register kernel, 8193 up to the cluster's capacity of 131,072 the
    cluster kernel, 131,073 and above the streaming one: the launch
    counters say which ran), with card, eager, bound, share and plain ms a
    call; then the edges, on whichever kernel takes them: identical points
    (every step a tie of all N), rounded coordinates (ties across warps and
    CTAs), npoint > N (wrap onto index 0), the start at N − 1, N = 2²² (the
    ceiling), a start outside the cloud (−1) on both kernels; N = 2²² + 1
    refused."""
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.cuda import bounds, fps

    gen = torch.Generator(device=dev).manual_seed(82)
    rows = {}
    for b, n, npoint, kind, kernel, what in FPS_LARGE_SHAPES:
        cloud = torch.rand((b, n, 3), generator=gen, device=dev)
        start = (torch.zeros(b, dtype=torch.int32, device=dev) if kind == "zero" else
                 torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32))
        before = kernels.launch_counts()
        got = fps.fps(cloud, npoint, start)
        took = _fps_took(before, kernels.launch_counts())
        want = fps.fps_plain(cloud, npoint, start)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fps kernel != plain at [{b}, {n}] -> {npoint}")
        if took != kernel:
            raise AssertionError(f"fps [{b}, {n}]: took {took}, the contract gives {kernel}")
        key = f"[{b}, {n}] -> {npoint}"
        rec = kernel_row(f"fps {key} ({what})", f"one call of [{b}, {n}] -> {npoint}",
                         lambda: fps.fps(cloud, npoint, start),
                         lambda: fps.fps_plain(cloud, npoint, start),
                         bounds.fps(b, n, npoint), calls=1)
        rec.update(kernel=f"{took}_kernel", ns_per_step=1e6 * rec["ms"] / (npoint - 1),
                   max_abs_err=0)
        print(f"  fps {key}: indices equal, {rec['kernel']}, "
              f"{rec['ns_per_step']:.0f} ns per step on the card")
        rows[key] = rec
    wide = fps.CLUSTER_MAX_N
    edges = [(10000, 64, 5, "same"), (12345, 300, 0, "rounded"), (8193, 8200, 17, "rand"),
             (9000, 128, 8999, "rand"), (wide, 64, wide - 1, "rounded"),
             (wide + 1, 64, 5, "same"), (wide + 1, 300, 0, "rounded"),
             (1 << 22, 16, 3, "rand")]
    took = []
    for n, npoint, s, kind in edges:
        cloud = torch.rand((2, n, 3), generator=gen, device=dev)
        if kind == "same":
            cloud = cloud[:, :1].expand(2, n, 3).contiguous()
        elif kind == "rounded":
            cloud = torch.round(cloud * 4) / 4
        st = torch.full((2,), s, dtype=torch.int32, device=dev)
        before = kernels.launch_counts()
        got = fps.fps(cloud, npoint, st)
        took.append(_fps_took(before, kernels.launch_counts()))
        if not torch.equal(got, fps.fps_plain(cloud, npoint, st)):
            raise AssertionError(f"fps kernel != plain at N={n} npoint={npoint} ({kind})")
        if npoint > n and not (got[:, n:] == 0).all():
            raise AssertionError("fps: npoint > N must wrap onto index 0")
    if took != ["fps_cluster"] * 5 + ["fps_stream"] * 3:
        raise AssertionError(f"fps edges took {took}")
    for n in (9000, wide + 1):  # the cluster kernel, the streaming one
        outside = torch.tensor([n, -1], dtype=torch.int32, device=dev)
        if not (fps.fps(cloud[:, :n].contiguous(), 8, outside) == -1).all():
            raise AssertionError(f"fps at N={n}: a start outside [0, N) must give -1")
    try:
        fps.fps(torch.zeros((1, fps.MAX_N + 1, 3), device=dev), 4, outside[:1])
    except ValueError:
        pass
    else:
        raise AssertionError("fps took N past its ceiling")
    print(f"fps cluster and streaming kernels: {len(edges)} edge cases (identical and rounded "
          f"points, npoint > N, start at N - 1, N = 2^22; kernels {took}) equal to plain; a "
          f"start outside the cloud gives -1 on both; N = 2^22 + 1 refused")
    for name, (b, n, npoint) in (("fps_cluster", FPS_LARGE_SHAPES[0][:3]),
                                 ("fps_stream", FPS_LARGE_SHAPES[-1][:3])):
        main = rows[f"[{b}, {n}] -> {npoint}"]
        records[name].update(
            {k: main[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by")},
            max_abs_err=0, ns_per_step=main["ns_per_step"],
            shapes={k: r for k, r in rows.items() if r["kernel"] == f"{name}_kernel"})
    return rows


def _cls_nb(root: str, log: str, num_point: int, shapes: int, path: str) -> tuple:
    """``cli.attack_object`` NB with phase 58's SSG classifier on one batch
    of ``shapes`` at ``num_point``: the result and the launch counts;
    adversarial accuracy at most clean, every shape's L2 above 0."""
    from pointsecguard_tpu_torch.cli import attack_object as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    out = cli.main(["--model", "pointnet2_cls", "--data_root", root, "--log_dir", log,
                    "--num_point", str(num_point), "--batch_size", str(shapes),
                    "--max_shapes", str(shapes), "--attack", "nb"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if not all(math.isfinite(v) for v in (out["clean_acc"], out["adv_acc"], out["l2_mean"])):
        raise AssertionError(f"{path}: a non-finite result")
    if not out["adv_acc"] <= out["clean_acc"]:
        raise AssertionError(f"{path}: adversarial accuracy above clean")
    # the attack moved every shape (the trained SSG may hold its accuracy)
    l2 = [float(row["l2"]) for row in read_tsv(out["tsv"])]
    if len(l2) != shapes or not all(v > 0 for v in l2):
        raise AssertionError(f"{path}: per-shape L2 {l2}: a shape left unperturbed")
    return out, counts


def phase_cls_10k(dev, records, log: str) -> dict:
    """82 (NB at 10,000 points). ``cli.attack_object --model pointnet2_cls
    --num_point 10000`` NB on a synthetic ModelNet written at 10,000 points
    a shape (one batch of 16), with phase 58's trained SSG classifier: the
    first forward's FPS indices and ball-query groups (``build_geometry_cls``
    from index 0) equal on the card and on the CPU; the wide-row bottom-k at
    its ball query ([16, 512, 10000] k = 32) equal to plain on its own rows
    (those with fewer than k points in radius counted) and on the rows
    built from them (``ball_query_edge_rows``: none in radius, few, all
    equal, and one that takes the exact branch, reported), timed beside
    ``torch.topk``; then the CLI run: 53 forwards of 2 FPS (one on the
    cluster kernel, none streaming) and 1 wide-row bottom-k a batch (the
    second ball query, k = 64, takes the stable sort), adversarial accuracy
    at most clean, every shape's L2 above 0, the batch's ms. Last, the same
    NB on 2 shapes of 131,104 points, past the cluster's capacity: 53 FPS
    on the streaming kernel."""
    from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset, make_synthetic_modelnet
    from pointsecguard_tpu_torch.models import build_geometry_cls
    from pointsecguard_tpu_torch.models.pointnet2_cls import CLS_SSG_SPEC
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked, bounds

    root = os.path.join(WORK, "modelnet_10k")
    make_synthetic_modelnet(root, points_per_shape=CLS_10K_POINTS, train_per_class=1,
                            test_per_class=CLS_10K_PER_CLASS, seed=1)
    ds = ModelNetDataset(root, "test", num_point=CLS_10K_POINTS)
    xyz = torch.from_numpy(np.stack([ds.load(i)[0][:, :3] for i in range(len(ds))]))
    shapes = xyz.shape[0]
    card = build_geometry_cls(xyz.to(dev))
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    cpu = build_geometry_cls(xyz)
    torch.set_num_threads(threads)
    for level, (a, b) in enumerate(zip(card["fps"], cpu["fps"])):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"10k geometry: FPS level {level} differs card vs CPU")
    for level, ((_, a), (_, b)) in enumerate(zip(card["sa"], cpu["sa"])):
        if not torch.equal(a.cpu(), b):
            rows_apart = int((a.cpu() != b).any(-1).sum())
            raise AssertionError(f"10k geometry: level {level}'s groups differ card vs CPU "
                                 f"in {rows_apart} rows")
    print(f"[{shapes}, {CLS_10K_POINTS}] build_geometry_cls: FPS indices and groups of both "
          f"levels equal card vs CPU")
    starts = [torch.zeros(shapes, dtype=torch.int32, device=dev)] * 2
    _, bq_in = cls_geometry_inputs(xyz.to(dev), CLS_SSG_SPEC, starts)
    vals, k = bq_in[0]
    in_radius = (vals < vals.shape[-1]).sum(-1)
    print(f"the ball query {list(vals.shape)} k={k}: {int((in_radius < k).sum())} rows with "
          f"fewer than k points in radius, {int((in_radius == 0).sum())} with none; in radius "
          f"{int(in_radius.min())} .. {int(in_radius.max())} a row")
    overflow = check_chunked_rows(f"{list(vals.shape)} k={k}",
                                  {"its rows": vals, **ball_query_edge_rows(vals, k)}, k)
    rows = vals.numel() // vals.shape[-1]
    chunked = kernel_row(f"bottom_k_chunked {tuple(vals.shape)} k={k}",
                         f"the ball query of one 10k-point classifier forward, "
                         f"{list(vals.shape)} k={k}",
                         lambda: bottomk_chunked.bottom_k_chunked(vals, k),
                         lambda: bottomk.bottom_k_plain(vals, k),
                         bounds.bottom_k_chunked(rows, vals.shape[-1], k), calls=1,
                         library=lambda: topk_library(vals, k))
    chunked.update(max_abs_err=0.0, exact_branch_rows=overflow["its rows"])
    records["bottom_k_chunked"]["cls_10k_ball_query"] = chunked

    out, counts = _cls_nb(root, log, CLS_10K_POINTS, shapes, CLS_10K_PATH)
    stats = {"shapes": shapes, "ms_per_batch": out["batch_ms"], "clean_acc": out["clean_acc"],
             "adv_acc": out["adv_acc"], "l2_mean": out["l2_mean"], "launches": counts}
    print(f"{CLS_10K_PATH}: " + json.dumps(stats))
    forwards = 53
    want = {"fps": 2 * forwards, "fps_cluster": forwards, "fps_stream": 0, "bottom_k": 0,
            "bottom_k_chunked": forwards, "knn": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{CLS_10K_PATH}: launches {counts}; want {want}")
    for name in ("fps", "fps_cluster", "bottom_k_chunked"):
        _record_path(records, name, CLS_10K_PATH, counts[name], f"{CLS_10K_PATH} batch",
                     counts[name])

    wide = os.path.join(WORK, "modelnet_wide")
    make_synthetic_modelnet(wide, points_per_shape=CLS_WIDE_POINTS, train_per_class=1,
                            test_per_class=1, seed=2)
    out, counts = _cls_nb(wide, log, CLS_WIDE_POINTS, CLS_WIDE_SHAPES, CLS_WIDE_PATH)
    want = {"fps": 2 * forwards, "fps_cluster": 0, "fps_stream": forwards, "bottom_k": 0,
            "bottom_k_chunked": forwards, "knn": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{CLS_WIDE_PATH}: launches {counts}; want {want}")
    print(f"{CLS_WIDE_PATH}: " + json.dumps(
        {"shapes": CLS_WIDE_SHAPES, "ms_per_batch": out["batch_ms"], "launches": counts}))
    for name in ("fps", "fps_stream", "bottom_k_chunked"):
        _record_path(records, name, CLS_WIDE_PATH, counts[name], f"{CLS_WIDE_PATH} batch",
                     counts[name])
    return stats


# phase 83: the sparse GCN library (models/gcn_sparse.py) on one block
GCN_K, GCN_WIDTH, GCN_BLOCKS, GCN_STEPS = 16, 64, 4, 10
# card vs CPU on the same state dict: in float32 the outputs within 1e-4 of
# the largest magnitude (set before the first run on the card) and the
# input gradient within 1e-4 relative L2 (set from three runs on an H100,
# which read 1.2e-6 to 1.7e-6 at most over the eleven layers: about 60
# times that, a float32 fault of the gradient on the card above 0.01 %
# fails); in float64 on both devices the gradient within 1e-9
GCN_FORWARD_TOL, GCN_GRAD_TOL, GCN_GRAD64_TOL = 1e-4, 1e-4, 1e-9
# the first optimizer step's parameters card vs CPU within GCN_PARAM_TOL:
# everywhere for radam (its first step is the momentum alone, lr·g); for
# adamw, whose first step is lr·g / (|g| + eps), about lr·sign(g), where |g|
# is clear of rounding noise (above a fifth of its tensor's largest entry),
# as phases 16, 22 and 31 compare Adam's move (set after the first run on
# an H100: one entry's sign, and so its move, differed by 2·lr)
GCN_PARAM_TOL = 1e-5
GCN_LR = {"radam": 1e-2, "adamw": 1e-3}


def gcn_layers(width: int) -> dict:
    """JAX's ``test_forward_shapes`` configurations and both blocks, at
    ``width`` in and out (GAT: 8 heads of width / 8)."""
    from pointsecguard_tpu_torch.models import gcn_sparse as g

    return {
        "GENConv": lambda: g.GENConv(width, width),
        "GENConv powermean learn_p": lambda: g.GENConv(width, width, aggr="powermean",
                                                       learn_p=True),
        "GENConv msg_norm learn_t": lambda: g.GENConv(width, width, msg_norm=True,
                                                      learn_t=True),
        "SparseEdgeConv": lambda: g.SparseEdgeConv(width, width),
        "SparseMRConv": lambda: g.SparseMRConv(width, width),
        "SparseGAT": lambda: g.SparseGAT(width, width // 8, heads=8),
        "SparseSAGE": lambda: g.SparseSAGE(width, width),
        "SparseGIN": lambda: g.SparseGIN(width, width),
        "SemiGCN": lambda: g.SemiGCN(width, width),
        "ResGraphBlock": lambda: g.ResGraphBlock(g.SparseEdgeConv(width, width)),
        "DenseGraphBlock": lambda: g.DenseGraphBlock(g.SparseEdgeConv(width, width)),
    }


class GCNStack(torch.nn.Module):
    """A small segmentation net of the library's layers, for phase 83 only:
    ``SparseMLP`` 9 → 64, ``GCN_BLOCKS`` × ``ResGraphBlock(SparseEdgeConv(64))``,
    a linear head to 13 classes."""

    def __init__(self, width: int = GCN_WIDTH, classes: int = 13):
        from pointsecguard_tpu_torch.models import gcn_sparse as g

        super().__init__()
        self.embed = g.SparseMLP(9, (width,))
        self.blocks = torch.nn.ModuleList(g.ResGraphBlock(g.SparseEdgeConv(width, width))
                                          for _ in range(GCN_BLOCKS))
        self.head = torch.nn.Linear(width, classes)

    def forward(self, x, edge_index):
        h = self.embed(x)
        for block in self.blocks:
            h = block(h, edge_index)
        return self.head(h)


def _gcn_fwd_bwd(layer, x, edge_index, cot):
    x = x.detach().clone().requires_grad_(True)
    out = layer(x, edge_index)
    (out * cot).sum().backward()
    return out.detach(), x.grad


def phase_gcn_sparse(dev, records, train_data: str) -> dict:
    """83. The sparse GCN library on one 4096-point block of phase 17's
    rooms: ``knn_edge_index`` over xyz (k = 16; the D = 3 kNN kernel) and
    over 64 features of a seeded ``SparseMLP`` (the any-D kernel): 2
    ``psg::knn`` launches, each graph equal to ``knn_plain``'s but in
    near-tie rows. Every layer of ``gcn_layers(64)`` on the xyz graph in
    training mode, forward and backward, card against CPU on the same
    state dict (float32, and float64 for the gradient; ``GCN_*_TOL``) and
    the card's ms. Then ``GCN_STEPS`` steps each of ``radam`` and ``adamw``
    on ``GCNStack`` with ``smooth_cross_entropy`` on the block's labels:
    the loss falls, the first step's parameters lie within
    ``GCN_PARAM_TOL`` of the CPU's (adamw's where the gradient is clear of
    rounding noise), ms a step by CUDA events."""
    from pointsecguard_tpu_torch.models import init_parameters
    from pointsecguard_tpu_torch.models import gcn_sparse as g
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.cuda import knn
    from pointsecguard_tpu_torch.train import optimizers as topt

    blocks, labels = resgcn_room_batch(train_data, 1, dev)
    x9, lab = blocks[0], labels[0]
    gen = torch.Generator().manual_seed(83)
    embed = g.SparseMLP(9, (GCN_WIDTH,))
    init_parameters(embed, gen)
    embed.to(dev).eval()
    with torch.no_grad():
        feats = embed(x9)
    xyz = x9[:, :3].contiguous()
    kernels.reset_launch_counts()
    graphs = {"xyz": g.knn_edge_index(xyz, GCN_K), "features": g.knn_edge_index(feats, GCN_K)}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["knn"] != 2 or sum(counts.values()) != 2:
        raise AssertionError(f"knn_edge_index x 2: launches {counts}, want 2 knn")
    _record_path(records, "knn", "gcn_sparse knn_edge_index", counts["knn"],
                 "gcn_sparse knn_edge_index (xyz and features)", counts["knn"])
    out = {"graphs": {}}
    for name, pts in (("xyz", xyz), ("features", feats)):
        ei = graphs[name]
        want = knn.knn_plain(pts[None], pts[None], GCN_K)[1][0]
        if not torch.equal(ei[1].cpu(), torch.arange(pts.shape[0]).repeat_interleave(GCN_K)
                           .to(torch.int32)):
            raise AssertionError(f"knn_edge_index ({name}): targets out of order")
        differ, bad = near_tie_check(pts[None], ei[0].reshape(1, -1, GCN_K), want[None])
        if bad:
            raise AssertionError(f"knn_edge_index ({name}): {bad} rows differ from knn_plain "
                                 f"by more than a near-tie")
        out["graphs"][name] = {"edges": ei.shape[1], "rows_differing_near_tie": differ}
    print(f"knn_edge_index over xyz and over {GCN_WIDTH} features, k = {GCN_K}: "
          f"2 psg::knn launches; " + json.dumps(out["graphs"]))

    ei_card, ei_cpu = graphs["xyz"], graphs["xyz"].cpu()
    x_cpu = feats.cpu()
    layers = {}
    for name, make in gcn_layers(GCN_WIDTH).items():
        layer = make()
        init_parameters(layer, gen)
        sd = layer.state_dict()
        twins = {}
        for where in ("cpu", "card"):
            twin = make()
            twin.load_state_dict(sd)
            twins[where] = twin.to("cpu" if where == "cpu" else dev).train()
        cot = torch.randn((x_cpu.shape[0], twins["cpu"](x_cpu, ei_cpu).shape[-1]),
                          generator=gen)
        o_cpu, g_cpu = _gcn_fwd_bwd(twins["cpu"], x_cpu, ei_cpu, cot)
        o_card, g_card = _gcn_fwd_bwd(twins["card"], feats, ei_card, cot.to(dev))
        fwd = float((o_card.cpu() - o_cpu).abs().max() / o_cpu.abs().max())
        grad = _rel_l2(g_card.cpu(), g_cpu)
        d = {t: twins[t].double() for t in twins}
        _, g64_cpu = _gcn_fwd_bwd(d["cpu"], x_cpu.double(), ei_cpu, cot.double())
        _, g64_card = _gcn_fwd_bwd(d["card"], feats.double(), ei_card, cot.double().to(dev))
        grad64 = _rel_l2(g64_card.cpu(), g64_cpu)
        twins["card"].float()
        ms = cuda_ms(lambda: _gcn_fwd_bwd(twins["card"], feats, ei_card, cot.to(dev)), reps=5)
        layers[name] = {"forward_err": fwd, "grad_rel_l2": grad, "grad64_rel_l2": grad64,
                        "ms_fwd_bwd": ms}
        print(f"  {name} [{x_cpu.shape[0]}, {GCN_WIDTH}], {ei_cpu.shape[1]} edges, train "
              f"mode: " + json.dumps(layers[name]))
        if not (fwd <= GCN_FORWARD_TOL and grad <= GCN_GRAD_TOL and grad64 <= GCN_GRAD64_TOL):
            raise AssertionError(f"{name}: card vs CPU {layers[name]}")
    out["layers"] = layers

    x9_cpu, lab_cpu = x9.cpu(), lab.cpu()
    out["train"] = {}
    for opt_name, make_opt in (("radam", topt.radam), ("adamw", topt.adamw)):
        lr = GCN_LR[opt_name]
        net = GCNStack()
        init_parameters(net, gen)
        sd = net.state_dict()
        nets = {}
        for where in ("cpu", "card"):
            nets[where] = GCNStack()
            nets[where].load_state_dict(sd)
            nets[where].to("cpu" if where == "cpu" else dev).train()
        opt_cpu = make_opt(nets["cpu"].parameters(), lr)
        topt.smooth_cross_entropy(nets["cpu"](x9_cpu, ei_cpu), lab_cpu).backward()
        grads = {n: p.grad.clone() for n, p in nets["cpu"].named_parameters()}
        opt_cpu.step()
        opt = make_opt(nets["card"].parameters(), lr)
        losses, times = [], []
        for step in range(GCN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            opt.zero_grad()
            loss = topt.smooth_cross_entropy(nets["card"](x9, ei_card), lab)
            loss.backward()
            opt.step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(loss.item())
            if step == 0:
                card_p = dict(nets["card"].named_parameters())
                worst = 0.0
                for n, p in nets["cpu"].named_parameters():
                    diff = (card_p[n].detach().cpu() - p.detach()).abs()
                    if opt_name == "adamw":
                        diff = diff[grads[n].abs() > 0.2 * grads[n].abs().max()]
                    worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
                if worst > GCN_PARAM_TOL:
                    raise AssertionError(f"{opt_name}: the first step's parameters sit {worst} "
                                         f"from the CPU's (bound {GCN_PARAM_TOL})")
        stats = {"lr": lr, "losses": losses, "first_step_param_err": worst,
                 "ms_per_step": statistics.median(times[1:]), "ms_first_step": times[0]}
        print(f"GCNStack {opt_name} {GCN_STEPS} steps, smooth_cross_entropy: "
              + json.dumps(stats))
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{opt_name}: the loss did not fall: {losses}")
        out["train"][opt_name] = stats
    return out


def ptxas_functions(log: str) -> dict:
    """Entry function → [registers, spill store bytes, spill load bytes]
    from the ``-Xptxas -v`` lines of a build log."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            found[name] = [None, 0, 0]
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            found[name][1:] = [int(m.group(1)), int(m.group(2))]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            found[name][0] = int(m.group(1))
    return found


def check_tiled_knn_spills(log: str) -> None:
    """The any-D kNN kernel keeps its list in registers only where ptxas
    spills nothing: fail the build step otherwise, at every list size."""
    tiled = {int(m.group(1)): r for n, r in ptxas_functions(log).items()
             if "knn_tiled_kernel" in n and (m := re.search(r"ILi(\d+)E", n))}
    if sorted(tiled) != [1, 16, 48]:
        raise AssertionError(f"build log: knn_tiled_kernel at list sizes {sorted(tiled)}, "
                             f"want [1, 16, 48] (is -Xptxas -v on?)")
    for kmax, (regs, stores, loads) in sorted(tiled.items()):
        if stores or loads:
            raise AssertionError(f"ptxas: knn_tiled_kernel<{kmax}> spills {stores} bytes "
                                 f"stored, {loads} loaded")
        print(f"  knn_tiled_kernel<{kmax}>: {regs} registers, 0 spill bytes")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels_only", action="store_true",
                        help="build the kernels and run only the kernel-vs-plain phases "
                             "(3, 4, 5, 42, 8, 14, 20, 21, 27, 79, 35, 56, 60, 72 and 82); the last line "
                             "then carries \"ok\": false, because the slices were not driven")
    args = parser.parse_args(argv)
    import pointsecguard_tpu_torch
    from pointsecguard_tpu_torch.ops.cuda import build
    from pointsecguard_tpu_torch.utils.runtime import require_cuda

    # the port and its kernel sources must be this checkout's, never an
    # installed copy found elsewhere on the path
    pkg = os.path.dirname(os.path.realpath(pointsecguard_tpu_torch.__file__))
    if pkg != os.path.join(os.path.realpath(REPO), "pointsecguard_tpu_torch"):
        raise RuntimeError(f"pointsecguard_tpu_torch imported from {pkg}, "
                           f"not from the checkout at {REPO}")
    dev = require_cuda()
    card = card_line()
    print(card)
    print("max SM clock:", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    started = t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({build.library_path().name})")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                print("  ptxas:", line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print("  ptxas:  ", line.replace("ptxas info    :", "").strip())
    check_tiled_knn_spills(log.read_text() if log.exists() else "")

    records = {
        "fps": {"name": "fps", "route": "cuda",
                "source": "pointsecguard_tpu_torch/csrc/fps.cu",
                "replaces": "pointsecguard_tpu/ops/pallas/fps.py:27",
                "library_ms": None, "library_call": None},
        "fps_cluster": {"name": "fps_cluster", "route": "cuda",
                        "source": "pointsecguard_tpu_torch/csrc/fps.cu",
                        "replaces": "pointsecguard_tpu/ops/pallas/fps.py:27",
                        "library_ms": None, "library_call": None},
        "fps_stream": {"name": "fps_stream", "route": "cuda",
                       "source": "pointsecguard_tpu_torch/csrc/fps.cu",
                       "replaces": "pointsecguard_tpu/ops/pallas/fps.py:27",
                       "library_ms": None, "library_call": None},
        "bottom_k": {"name": "bottom_k", "route": "cuda",
                     "source": "pointsecguard_tpu_torch/csrc/bottomk.cu",
                     "replaces": "pointsecguard_tpu/ops/pallas/bottomk.py:66"},
        "knn": {"name": "knn", "route": "cuda",
                "source": "pointsecguard_tpu_torch/csrc/knn.cu",
                "replaces": "pointsecguard_tpu/ops/pallas/knn.py:52",
                "library_ms": None, "library_call": None},
        "bottom_k_chunked": {"name": "bottom_k_chunked", "route": "cuda",
                             "source": "pointsecguard_tpu_torch/csrc/bottomk_chunked.cu",
                             "replaces": "pointsecguard_tpu/ops/pallas/bottomk.py:206"},
        "attentive_fwd": {"name": "attentive_fwd", "route": "cuda",
                          "source": "pointsecguard_tpu_torch/csrc/attentive.cu",
                          "replaces": "pointsecguard_tpu/ops/pallas/attentive.py:100",
                          "library_ms": None, "library_call": None},
        "attentive_bwd": {"name": "attentive_bwd", "route": "cuda",
                          "source": "pointsecguard_tpu_torch/csrc/attentive.cu",
                          "replaces": "pointsecguard_tpu/ops/pallas/attentive.py:115",
                          "library_ms": None, "library_call": None},
    }
    from pointsecguard_tpu_torch.data import make_synthetic_rooms

    def timed(label, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
        return out

    t0 = time.perf_counter()
    data = os.path.join(WORK, "data")
    make_synthetic_rooms(data, points_per_room=ROOM_POINTS, seed=0)
    prep = prepare_randla(data)
    print(f"phases 6-7 set-up (synthetic rooms, RandLA preparation): "
          f"{time.perf_counter() - t0:.1f} s")
    timed(3, phase_kernels, dev, records)
    timed(8, phase_attentive_kernels, dev, records)
    feats = randla_batch(prep, dev)
    xyz = feats[..., :3].contiguous()
    timed(4, phase_randla_kernels, dev, records, xyz)
    timed(5, phase_routes, records, xyz)
    timed(42, phase_resample_knn, dev, records, xyz)
    del xyz
    timed(14, phase_train_kernels, dev, records)
    train_feats, train_labels = timed(20, phase_randla_train_knn, dev, records, prep)
    timed(21, phase_bottom_k_vjp, dev)
    selection = timed(27, phase_resgcn_kernels, dev, records, data)
    timed(79, phase_resgcn_fast_kernels, dev, records, data)
    timed(35, phase_msg_kernels, dev, records)
    cls_selection = timed(56, phase_cls_kernels, dev, records)
    partseg_selection = timed(60, phase_partseg_kernels, dev, records)
    timed(72, phase_opcheck, dev)
    timed("82 (kernels)", phase_fps_large_kernels, dev, records)
    selections = [selection, cls_selection, partseg_selection]
    print(f"kernel phases: the run so far {time.perf_counter() - started:.1f} s")
    if args.kernels_only:
        print(json.dumps({"selection": selections}))
        print(json.dumps({"kernels": list(records.values())}))
        print(card)
        print(json.dumps({"ok": False, "kernels_only": True}))
        return 1
    timed(6, phase_slice, dev, records, data)
    timed("6 (card vs CPU)", phase_reference, dev)
    timed(12, phase_pointnet2_nu, data, records)
    sd = timed("9 (seeded RandLA weights)", randla_state_dict, 0, dev, feats)
    timed(9, phase_fused_model, dev, feats, sd)
    del feats
    timed("7 and 10", phase_randla, dev, records, prep, sd)
    timed(11, phase_randla_nu, prep, records)
    timed(13, phase_randla_reference, dev, prep)
    timed(15, phase_trained_fixture, dev)
    timed(16, phase_train_step, dev)
    train_data, train_log, _ = timed(17, phase_train, dev, records)
    timed(18, phase_eval, train_data, train_log)
    timed(19, phase_attack_trained, train_data, train_log)
    timed(43, phase_protocol_blocks, train_data, train_log, records)
    timed(44, phase_defense_reference, dev)
    timed(22, phase_randla_train_step, dev, prep)
    timed(23, phase_fused_train, dev, records, train_feats, train_labels)
    del train_feats, train_labels
    randla_log, _ = timed(24, phase_randla_train, dev, records, prep)
    timed(25, phase_randla_eval, prep, randla_log, records)
    timed(26, phase_randla_attack_trained, prep, randla_log)
    timed(45, phase_randla_protocol, prep, randla_log, records)
    timed(28, phase_resgcn_reference, dev)
    resgcn_dynamic = timed(29, phase_resgcn_nb, dev, records, data)
    timed(46, phase_resgcn_fixed, data, records, resgcn_dynamic)
    timed(30, phase_resgcn_nu, dev, records, data)
    timed(31, phase_resgcn_train_step, dev)
    resgcn_data, resgcn_log, _ = timed(32, phase_resgcn_train, dev, records)
    timed(33, phase_resgcn_eval, resgcn_data, resgcn_log, records)
    resgcn_exact = timed(34, phase_resgcn_attack_trained, resgcn_data, resgcn_log)
    timed(80, phase_resgcn_fast, dev, records, resgcn_data, resgcn_log, resgcn_exact)
    print(f"phases 1-35 and 42-46: the run so far {time.perf_counter() - started:.1f} s")
    phases_36_41 = time.perf_counter()
    block_logs = {"pointnet2": train_log}
    for model in BLOCK_MODELS:
        t0 = time.perf_counter()
        phase_block_reference(dev, model)
        phase_slice(dev, records, data, model)
        phase_pointnet2_nu(data, records, model)
        t1 = time.perf_counter()
        phase_train_step(dev, model)
        t2 = time.perf_counter()
        _, log, _ = phase_train(dev, records, model, BLOCK_TRAIN_EPOCHS, data=train_data)
        block_logs[model] = log
        phase_eval(train_data, log, model)
        phase_attack_trained(train_data, log, model)
        print(f"{model} phases 36-41: {time.perf_counter() - t0:.1f} s (36-37 "
              f"{t1 - t0:.1f}, 38 {t2 - t1:.1f}, 39-41 {time.perf_counter() - t2:.1f})")
    print(f"phases 36-41: {time.perf_counter() - phases_36_41:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_47_51 = time.perf_counter()
    bench = {}
    for number, phase in (
            (47, lambda: phase_ensemble(train_data, block_logs, records)),
            (48, lambda: bench.update(phase_benchmark_registry(train_data, train_log, records))),
            (49, lambda: bench.update(phase_benchmark_sweeps(train_data, train_log))),
            (50, lambda: phase_score_reference(dev, train_log)),
            (51, lambda: phase_benchmark_victims(data, prep, randla_log,
                                                 os.path.join(WORK, "resgcn_log"), records))):
        t0 = time.perf_counter()
        phase()
        print(f"phase {number}: {time.perf_counter() - t0:.1f} s")
    print(f"phases 47-51: {time.perf_counter() - phases_47_51:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_52_55 = time.perf_counter()
    preps = phase_prepare_outdoor(data)
    print(f"phase 52: {time.perf_counter() - phases_52_55:.1f} s")
    t0 = time.perf_counter()
    phase_outdoor_knn(dev, records, preps)
    print(f"phase 53: {time.perf_counter() - t0:.1f} s")
    phase_semantic3d(dev, records, preps)
    phase_semantickitti(dev, records, preps)
    print(f"phases 52-55: {time.perf_counter() - phases_52_55:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_57_59 = time.perf_counter()
    cls_logs = run_cls_phases(dev, records)
    print(f"phases 57-59: {time.perf_counter() - phases_57_59:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_61_63 = time.perf_counter()
    partseg_logs = run_partseg_phases(dev, records)
    print(f"phases 61-63: {time.perf_counter() - phases_61_63:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_82_83 = time.perf_counter()
    timed("82 (NB at 10,000 points)", phase_cls_10k, dev, records, cls_logs["pointnet2_cls"])
    timed(83, phase_gcn_sparse, dev, records, train_data)
    print(f"phases 82-83: {time.perf_counter() - phases_82_83:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_64_68 = time.perf_counter()
    ds_train = run_training_extras_phases(dev, records, train_data, prep, resgcn_data)
    print(f"phases 64-68: {time.perf_counter() - phases_64_68:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_69_71 = time.perf_counter()
    paths = {"train_data": train_data, "train_log": train_log, "prep": prep,
             "randla_log": randla_log, "resgcn_data": resgcn_data, "resgcn_log": resgcn_log}
    for number, phase in (
            (69, lambda: phase_bf16_models(dev, records, data, prep, resgcn_log)),
            (70, lambda: phase_bf16_clis(dev, records, paths, ds_train["host"])),
            (71, lambda: phase_import(dev, paths))):
        t0 = time.perf_counter()
        phase()
        print(f"phase {number}: {time.perf_counter() - t0:.1f} s")
    print(f"phases 69-71: {time.perf_counter() - phases_69_71:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_73_74 = time.perf_counter()
    # every model from the checkpoint an earlier phase trained; the
    # classifiers on the synthetic ModelNet's 4 classes
    export_logs = {"pointnet2": (train_log, []), "randla": (randla_log, []),
                   "resgcn": (resgcn_log, []),
                   **{m: (block_logs[m], []) for m in BLOCK_MODELS},
                   **{m: (cls_logs[m], ["--num_category", "4"]) for m in CLS_MODELS},
                   **{m: (partseg_logs[m], []) for m in PS_MODELS}}
    exported = timed(73, phase_export, dev, records, export_logs)
    timed(74, phase_reload, records, exported)
    print(f"phases 73-74: {time.perf_counter() - phases_73_74:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")
    phases_75_81 = time.perf_counter()
    phase_parallel(dev, records, prep, train_data, train_log,
                   {"benchmark": bench, "steps_tsv": STEPS_TSV})
    timed(78, phase_nccl, dev, records, prep)
    print(f"phases 75-78 and 81: {time.perf_counter() - phases_75_81:.1f} s; "
          f"the run so far {time.perf_counter() - started:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "calls_per_batch")
    geometry_paths = {"pointnet2 nb", "pointnet2 train", "pointnet2_msg nb",
                      "pointnet2_msg train", "pointnet2 nb --ensemble", "pointnet2 benchmark",
                      "pointnet2_cls train", "pointnet2_cls eval", "pointnet2_cls_msg train",
                      "pointnet2_cls_msg eval", "pointnet2_cls benchmark",
                      *(f"pointnet2_cls {path}" for path, _, _ in CLS_ATTACKS),
                      *(f"{m} {what}" for m in PS_MODELS[:2] for what in ("train", "eval")),
                      *(f"{m} {path}" for m, path, _ in PS_ATTACKS if m != "pointnet_part_seg"),
                      "pointnet2 train --device_sampler", "pointnet2 train --adv_train nb",
                      "pointnet2 train --profile", "pointnet2 export",
                      "pointnet2 train --devices 2", "pointnet2 benchmark --devices 2",
                      "pointnet2 nb --log_steps --devices 2",
                      *(f"{m} forward --precision bfloat16" for m in
                        ("pointnet2", "pointnet2_msg", *CLS_MODELS[:2], *PS_MODELS[:2])),
                      *(f"{path} --precision bfloat16" for path in
                        ("pointnet2 train", "pointnet2 eval", "pointnet2 nb",
                         "pointnet2_cls nb", "pointnet2 benchmark"))}
    for name, paths in (("fps", geometry_paths | {CLS_10K_PATH, CLS_WIDE_PATH}),
                        ("bottom_k", geometry_paths),
                        ("fps_cluster", {CLS_10K_PATH}), ("fps_stream", {CLS_WIDE_PATH}),
                        ("bottom_k_chunked", {"knn tiled route 40960^2", CLS_10K_PATH,
                                              CLS_WIDE_PATH}),
                        ("knn", {"randla nb", "randla train", "randla eval",
                                 "resgcn nb", "resgcn train", "resgcn eval",
                                 "pointnet2 nb --defense resample",
                                 "randla nb --defense resample",
                                 "resgcn nb --resgcn_fixed_graphs",
                                 "resgcn nb --resgcn_fast", "resgcn eval --resgcn_fast",
                                 "randla benchmark", "resgcn benchmark",
                                 "randla semantic3d train", "randla semantic3d eval",
                                 "randla semantic3d nb", "randla semantickitti train",
                                 "randla semantickitti eval",
                                 "pointnet2_cls nb --defense sor",
                                 "pointnet2_part_seg nb --defense sor",
                                 "randla train --adv_train nb", "resgcn train --remat",
                                 "randla export",
                                 *(f"randla pyramid --shard_points {n}" for n in SP_RANKS),
                                 "randla nb --devices 2 --shard_points 2",
                                 "knn_points_sharded nccl", "gcn_sparse knn_edge_index",
                                 *(f"{path} --precision bfloat16" for path in
                                   ("randla forward", "resgcn forward", "resgcn train",
                                    "resgcn train --remat", "resgcn eval", "randla nb",
                                    "resgcn nb"))})):
        by_path = records[name]["launches_by_path"]
        if set(by_path) != paths or min(by_path.values()) <= 0:
            raise AssertionError(f"kernel {name} missed a main path: {by_path}")
        records[name]["launches"] = sum(by_path.values())
    for r in records.values():
        if not r["launches"] > 0:
            raise AssertionError(f"kernel {r['name']} never launched on its main path")
    print(json.dumps({"selection": selections}))
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: r[k] for k in ("cw_step", "ns_per_step", "train_step", "msg_attack",
                              "msg_train_step", "resgcn_forward", "resgcn_fast_forward",
                              "resample",
                              "semantic3d_pyramid", "semantickitti_pyramid",
                              "semantic3d_pass", "cls_attack", "cls_msg_attack",
                              "cls_train_step", "sor", "partseg_attack",
                              "partseg_train_step", "partseg_ball_query",
                              "partseg_three_nn_l0", "partseg_three_nn_l1", "partseg_sor",
                              "sharded_query", "shapes", "cls_10k_ball_query",
                              "launches_by_path")
            if k in r}}
        for r in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
