"""Chip smoke of the PyTorch port: drive its main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):

1. Build every kernel from ``mxnet_tpu_torch/csrc`` (nvcc, sm_90a) and
   print the card as ``nvidia-smi`` reports its name and power limit.
2. Hold each kernel against its plain PyTorch version on the card:
   the decode-attention kernel, f32 and int8 cache, at B=8, H=12, d=64,
   C in {256, 1024}, Tq in {1, 7, 64, 256}, per-row cache lengths on the
   kv-tile edges, an inert row, and NaN garbage past every row's valid
   length.  TF32 is off for matmuls and cuDNN, so the plain version runs
   in full f32; tolerance atol = rtol = 1e-4 (f32, different summation
   order).
3. Time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (``scaled_dot_product_attention``
   with the boolean decode mask, a yardstick the port never calls), with
   CUDA events at the main path's decode and prefill shapes, beside the
   least time the card could take (the bound); then, each checked
   against the plain version first, at shapes off the TPU kernel's
   tiling: a 1024-token prefill chunk (C = 1100), a cache of C = 100 and
   d = 36.  The decode row and the 1024-token row also give the device
   time of the kernel and of SDPA (``torch.profiler`` kernel records;
   where three profiles in a row record no device time, CUDA events
   around calls queued behind a spin kernel, which the kernel's time on
   these rows is also taken with every run, to hold one to the other),
   the decode row the split count of the plan and the kernels a call
   (one: the splits merge inside the launch), and every row two bounds:
   f32 on CUDA cores and 3xTF32 on tensor cores (the chunk path's).
4. Serve ``transformer_lm`` at GPT-2-small widths (vocab 50257, 768
   units, 12 layers, 12 heads, 1024 positions; random weights from
   ``mx.random.seed(0)`` and ``mx.init.Xavier()``, as ``bench.py`` builds)
   through ``serve.register_decode``: 16 greedy requests, checked for
   kernel launches, CPU parity of teacher-forced logits, and agreement
   with an unbatched greedy loop.
5. The same model with the int8 KV cache: 8 requests.
6. The flash-attention kernel against its plain version on the card:
   B=4, H=12, d in {64, 128, 256, 264, 320, 512}, T in {1, 37, 128,
   512}, causal off and on, per-row key lengths {0, 1, 63, 64, 65, T}
   over two calls, NaN garbage in k/v past each row's length; then
   Tq != Tk (70 x 130, 129 x 65) at d in {64, 320} on views at storage
   offset 1 (not 16-byte aligned); output and lse within atol = rtol =
   1e-4 (TF32 off), the same bits on a second call.  Then its times
   beside its plain version, ``scaled_dot_product_attention`` with the boolean
   key-padding mask (a yardstick the port never calls) and its bound, at
   the serving shapes B=16, T=512 (varied lengths) and B=8, T=128, and
   at B=8, T=128 with d = 36.
7. Serve ``bert_12_768_12`` (vocab 30522, 768 units, FFN 3072, 12
   layers, 12 heads, 512 positions; seeded random weights, f32) through
   ``serve.register`` and ``serve.Server(max_wait_ms=5, max_batch=16)``:
   64 ragged requests of 16-512 tokens, half with a second segment.
   Checks: flash launches == 12 x batches; every answer within 1e-4 x
   max|ref| of a one-request forward on the card; one padded batch on
   the card within 1e-3 x max|cpu| of the port's plain path on the CPU.

8. The flash-attention backward kernels (dq, dk/dv; tensor cores with a
   3xTF32 split) against their plain version on the card: B=4, H=12,
   d in {36, 64, 100, 128, 256, 264, 320, 512}, T in {1, 37, 128, 512},
   causal off and
   on, per-row key lengths {0, 1, 63, 64, 65,
   T} over two calls; NaN in k/v past each row's length, and in q/g of
   the 0-length row (every position of it is past its length).  dq, dk
   and dv within atol = rtol = 1e-4 (TF32 off); dk and dv exactly 0 at
   key positions >= the row's length, dq exactly 0 for the 0-length row.
9. Times of the dq and dk/dv kernels at the training shape (B=32, H=12,
   T=128, d=64, lengths 64-128 from a seed) and at B=16, T=512, beside
   the plain version and two bounds (3xTF32 on tensor cores, which the
   kernels run, and f32 on CUDA cores); then the whole
   ``flash_attention_bwd`` (dq with its fused delta, dk/dv) and SDPA's
   backward through a retained graph with the boolean key-padding mask
   (a yardstick the port never calls), in turns, twice each, with CUDA
   events; and the device time of each alone (``torch.profiler`` kernel
   records), since events around back-to-back calls also count host
   time where a call's host work outlasts its kernels.  The kernels
   line's ``library_ms`` for the pair is that device time of SDPA's
   backward; its event median is ``library_events_ms``.
10. The flat-arena optimizer kernel against its plain version for sgd,
    momentum, nesterov and adam at t in {1, 7}, on a small odd-length
    arena and on one of BERTForPretrain(bert_12_768_12)'s size: delta
    and state within 1e-6 relative, zero padding inert; adam's time
    beside its bound and ``torch._fused_adam_`` over the same flat
    tensors (a yardstick never on the path).
11. Train BERTForPretrain(bert_12_768_12) (published widths, dropout
    0.1, seeded weights) through ``parallel.ShardedTrainer``
    (optimizer="adam", lr 1e-4, wd 0.01, TF32 off) on the bench's
    pretraining batch: 32 rows of 128 tokens, lengths 64-128, 20 masked
    positions per row inside its length, NSP labels half 1.  Two warm
    steps, then 20 timed steps on the same batch: samples/s, step p50;
    launches per step: flash forward 12, dq 12, dk/dv 12, arena 1; the
    loss finite and lower at the last step than at the first.
12. The same model at full width with 2 layers and dropout 0, from the
    same seed, one step on the card (kernels) and on the CPU (plain
    versions) at B=4, T=128: step-1 loss within 1e-4 relative and every
    parameter gradient within 1e-4 x max|g| of the CPU gradient.
13. The batch-norm kernels (``bn_act_stats``: the statistics and their
    fold into the apply pass's scale and shift, one launch;
    ``bn_act_apply``) against their plain versions and a float64
    reference: every ResNet-50
    BatchNormReLU shape at B=128 (rows x C = 128.112.112 x 64, 128.56.56
    x 64, 128.28.28 x 128, 128.14.14 x 256, 128.7.7 x 512), rows in {1,
    9, 4097} x C in {3, 8, 64, 2048} and 1000003 x 64; a constant
    channel and an offset-mean channel in each.  y within atol = rtol =
    1e-4; mean and var within 1e-5 of the channel's scale (sqrt(E[x^2])
    for the mean, E[x^2] for the variance: relative for zero-mean data,
    and the most a one-pass variance can promise); scale within 1e-6 of
    |scale| and shift within 1e-6 of the larger of |beta| and |mean *
    gamma * inv| of the plain version's; the same bits on two runs.
14. Their times at the stem shape and the stage-4 shape beside the
    bound, the plain versions, ``torch.var_mean`` (stats) and
    ``F.batch_norm(training=True)`` + ``relu_`` (both passes, two calls;
    yardsticks the port never calls); then both kernels and those two
    yardsticks by device time (``torch.profiler``) at all five
    BatchNormReLU shapes of ResNet-50.
15. Train ``resnet50_v1(layout="NHWC", fused_bn_relu=True)`` (published
    widths, 1000 classes, seeded weights, f32, TF32 off) through
    ``parallel.ShardedTrainer`` (sgd, lr 0.05, momentum 0.9, as
    ``bench.py``'s ``bench_resnet50``) on B=128 224x224x3 inputs from
    ``RandomState(0)`` with random labels, held on the card: 2 warm steps
    and 20 timed; img/s, step p50, peak memory; launches per step
    ``bn_act_stats`` 33, ``bn_act_apply`` 33, ``opt_arena`` 1.  Then
    untimed steps to step 60: the loss finite throughout and lower at
    step 60 than at step 1 (on this one batch it spikes around steps
    14-25, so step 22 can read above step 1 on one run and below it on
    the next: cuDNN's backward sums in no fixed order).
16. ResNetV1(BottleneckV1, [1, 1, 1, 1], [64, 256, 512, 1024, 2048],
    1000 classes, NHWC, fused) from the same seed, one step on the card
    and on the CPU at B=4, 64x64: loss within 1e-4 relative, every
    gradient within 1e-4 x max|g|, running statistics within 1e-5.
17. The extension kernels (``ext_sqrelu_fwd``, ``ext_sqrelu_bwd``,
    ``ext_axpb``) against their plain versions on the card: sizes 1, 3,
    4, 4097 and 1000003, views at storage offset 1 (not 16-byte
    aligned), 0 elements, 0-d, and the ResNet-50 stem's 128x112x112x64;
    f32, f16 and bf16; ``axpb`` at a = 1/0.3081, b = -0.1307/0.3081 and
    at a = 3, b = 1.  Bar: squared ReLU equal bits; ``axpb`` equal bits
    in f16 / bf16 and within 1 ulp in f32 (the plain version rounds a
    float64 result once, the kernel one fused multiply-add).
18. Their times at the stem shape (f32) beside the bound, the plain
    versions and the shortest PyTorch compositions (``relu`` +
    ``square_``; ``relu`` + ``mul_`` + ``mul_``; one ``addcmul``;
    yardsticks the port never calls).
19. The canonical Gluon drive: ``get_model("lenet")`` (LeNet-5 at its
    published widths, ``mx.random.seed(0)`` then ``mx.init.Xavier()``),
    hybridized, 120 steps of ``autograd.record()`` -> loss ->
    ``autograd.backward`` -> ``gluon.Trainer("sgd", lr 0.05, momentum
    0.9).step(64)`` on the port's ``MNIST`` (the JAX package's synthetic
    set where no files are present: class templates from seed 1234),
    held on the card; img/s, step p50; held-out accuracy on 1024 images
    > 0.95; no kernel of the port launched.
20. The extension drive: a user ``HybridBlock`` with LeNet's layers,
    the input normalized by ``npx.pallas_axpb`` and the hidden layer's
    activation ``npx.pallas_squared_relu``, the ops loaded by
    ``library.load("example/extensions/torch_ops.py")``; the same
    training at lr 0.01 (lr 0.05 diverges) and bar; launches 1 + 1 + 1 a
    step; then one step on the card and on the CPU from one seed, on the
    first held-out batch: loss within 1e-4 relative, every gradient
    within 1e-4 x max|g|.
21. Phase 15's ResNet-50 v1, seed and batch through ``autograd.record()``
    and ``gluon.Trainer`` (sgd, lr 0.05, momentum 0.9): 5 steps; step-1
    loss within 1e-4 relative of ``ShardedTrainer``'s, ``bn_act_stats``
    / ``bn_act_apply`` 33 / 33 launches a step, the running statistics
    move; step p50 beside phase 15's.

22. The 16-bit attention kernels (bf16 and f16: forward, dq, dk/dv)
    against their plain versions, which follow the TPU kernels'
    roundings: the training shape (B=32, H=12, T=128, kv_len 64-128) and
    the serving shape (B=16, T=512, kv_len 24-512) at d=64, d in {36,
    128, 320} at B=4, T in {128, 512}, causal off and on, unaligned
    views; either side of the fused mode's edge (Tk <= 128 and d <= 64:
    the dk/dv kernel alone computes dq, dk and dv): Tk in {1, 64, 127,
    128, 129, 200, 512} with Tq != Tk at d in {36, 64, 128, 320}, key
    lengths {0, 1, Tk}, causal off and on, and unaligned views at Tk 128
    and 129; the forward's narrowest widths, d in {1, 8} at Tk in {65,
    129} with Tq 100 or 200 (off the 64- and 128-row blocks); a 0-length
    row in every edge case (out 0, lse -inf); NaN in k/v past each row's
    length.  Bars: the output within
    2^-7 (bf16) / 2^-10 (f16) x max|ref|, the lse within 1e-4, dq / dk /
    dv within 2^-6 / 2^-9 x the larger of max|g| and max|ref| (a gradient
    larger than g, as dv of a key that 512 queries attend with p ~ 1,
    rounds at its own scale); exact zeros past lengths, the same bits
    twice.  In f16 also four cases whose |dS| passes 65504 while dq, dk
    and dv are nonzero and fit, |dS| rising tile by tile
    (``half_large_ds``): finite, within the bar.  And dq where a split
    of dS that kept only its high term would show (``half_split_probe``,
    keys 1 + e, Tk 128 fused and 192 two-launch, bf16 and f16): within
    2^-6 / 2^-9 x max|dq|.
23. Their device times (``torch.profiler``) at the training shape (the
    fused dk/dv launch) and the serving shape (dq, then dk/dv) beside
    SDPA's forward and backward in the same type and key lengths
    (yardsticks the port never calls), the plain versions (events) and
    the bounds (``half_bounds``): bytes at 3.35e12 B/s, every product on
    16-bit MMAs at 989e12 flop/s, each f32 x 16-bit product counted as
    the two MMAs of its split.
24. Phase 11's BERT-base in bf16 at ``bench_bert_base``'s settings:
    ``ShardedTrainer(compute_dtype=torch.bfloat16)``, adamw, lr 1e-4, wd
    0.01, dropout 0.1; 2 warm + 20 timed steps: samples/s, step p50 and
    peak memory beside phase 11's f32; 12 launches a step of the bf16
    forward and 12 of the dk/dv kernel's fused mode, none of dq and none
    of an f32 kernel; the loss finite and falling; the master parameters
    f32.  Then 3 timed steps of BERT's 512-token phase (B=8, T=512, 76
    masked a row): 12 + 12 + 12 launches a step of the forward, dq and
    dk/dv, the loss finite.
25. The same in f16 with dynamic loss scaling; then 24 steps from a
    loss scale of 2^30 (dropout 0): steps skip while the scale halves,
    then the loss falls over the steps taken.
26. Phase 12 in bf16: 2 layers at full width, B=4, T=128, one step on
    the card and on the CPU: the loss within 2e-2 relative and every
    gradient within 2^-4 x max|g| (bf16 computations in two orders;
    the bars of ``tests/test_torch_amp.py``).
27. The 16-bit batch-norm kernels (``bn_act_stats.bf16`` / ``.f16``,
    ``bn_act_apply.bf16`` / ``.f16``) against their plain versions, bf16
    and f16: ResNet-50's five BatchNormReLU shapes at B=128 (the stem
    1,605,632 x 64 to stage 4's 6,272 x 512), rows x C in {4097 x 3,
    4097 x 12, 1 x 64, 1 x 8, 9 x 2048, 4097 x 77} (C % 8 != 0, one
    row), views at a 2-byte storage offset, and an f16 case past 65,504
    (inf, as the JAX op gives).  Bars: y bit for bit; scale and shift
    equal (the f32 fold rounded to x's type); mean and var within 1e-5 of
    each channel's scale of a float64 reference; the same bits twice.
    Then their device times at the five shapes beside the bound (2-byte
    x and y at 3.35e12 B/s), ``torch.var_mean`` and
    ``F.batch_norm(training=True)`` + ``relu_`` in the same type
    (yardsticks the port never calls), the plain versions by events at
    the stem and stage 4.
28. ``resnet50_v1(layout="NHWC")`` in bf16 as ``bench_resnet50`` runs
    it: ``ShardedTrainer(sgd, lr 0.05, momentum 0.9,
    compute_dtype=torch.bfloat16)`` with the bench's f32 cross entropy,
    phase 15's seed and batch; once with plain BatchNorm (the bench's
    default) and once with ``fused_bn_relu=True``.  2 warm and 20 timed
    steps, then to step 60: img/s, step p50 (CUDA events), wall a step,
    peak memory beside phase 15's f32; launches a step: fused 33
    ``bn_act_stats.bf16`` + 33 ``bn_act_apply.bf16`` + 1 ``opt_arena``,
    plain 1 ``opt_arena``, nothing else; the loss finite and lower at
    step 60 than at step 1; masters and running statistics f32 and
    moving.
29. The same in f16 with dynamic loss scaling (fused): the loss scale
    and the skipped steps.
30. Phase 16's step in bf16 (fused, B=4, 64x64) on the card and on the
    CPU: loss within 2e-2 relative (phase 26's bar); every gradient and
    every running statistic within the larger of 2^-4 x max of its
    tensor (phase 26's bar) and 3 times the distance between the CPU's
    bf16 and f32 steps in that tensor (bf16 alone moves some gradients
    of this step by half their max: ``phase_resnet_cpu_bf16``).

31. The trainer's multi-tensor update (``ShardedTrainer(multi_tensor=
    True)``) against the per-parameter one on BERT-base in bf16 at
    bench_bert_base's settings (B=32, T=128, 20 masked, lr 1e-4, wd
    0.01, dropout 0): 5 adamw steps and 3 lamb steps from the same
    weights, parameters and optimizer states bit for bit (lamb's
    parameters within 1e-6 x each tensor's max: its per-tensor norms
    reduce in another order on a stack).  For adamw,
    each adapter's kernel launches a step and device busy share
    (``torch.profiler``, 5 steps), step p50 (CUDA events) and wall a step
    (10 steps), and the number of groups; 12 bf16 forward and 12 fused
    dk/dv launches a step.
32. BERT-base f32 adam (the arena) under ``PolyScheduler(max_update=20,
    base_lr=1e-4, pwr=1, warmup_steps=4)`` with ``grad_accum=2``: one
    window of two B=16 halves against one B=32 step from the same state
    (within 1e-5 x the parameters' max: the summation order's), then 6
    windows: ``opt_arena`` launched once a window at ``scheduler(t)``;
    ``set_learning_rate`` raises.
33. Resume: BERT-base bf16 adamw ``multi_tensor=True``, dropout 0.1: 4
    steps, ``save_states``, a fresh net and trainer, ``load_states``, 4
    steps, against 8 uninterrupted steps (bit for bit, or within the
    distance of two uninterrupted runs where that is not 0); the same in
    f16 from loss scale 2^20 (the scale, the good count and the skipped
    steps carried); ``save_parameters`` -> ``load_parameters`` gives the
    same outputs; ``save_states`` mid-window raises.
34. The 19 registry optimizers through ``gluon.Trainer`` on LeNet-5
    (B=64, 3 steps, the first batches of the port's ``MNIST``) on the
    card against the CPU with the card's
    gradients, within 1e-5 x each tensor's max; SGLD on its drift (its
    noise replayed) and its noise's moments; then adam under a
    ``FactorScheduler`` resumed through ``save_states`` /
    ``load_states`` bit for bit.

35. The decode kernel in every (query type, cache type) pair: f32, bf16
    and f16 queries over f32, int8, bf16 and f16 caches, each its own
    kernel (``flash_attention_decode.<q>_<cache>``; f32 over f32 and
    int8 keep phase 2's names), against its plain version: Tq in {1, 3,
    8, 9, 64, 256} (split-K, query groups of 8 for a mixed pair's
    chunks, the 16-bit forward core for a same-type chunk), C in {100,
    1024}, d in {36, 64, 128}, B=4, H=6, an inert row (cache_len 0) and
    one at the capacity's edge, NaN past every window.  Bars 2^-7 (bf16)
    / 2^-10 (f16) x max|ref| where q or the cache is 16-bit (the 16-bit
    forward's; an f32 output over a 16-bit cache rounds P in the cache's
    type at the kernel's running max, so it takes the cache type's bar),
    atol = rtol = 1e-4 otherwise; the lse within 1e-4.  Then each of the
    ten new pairs at the decode shape (B=8, H=12, d=64, Tq=1, C=1024,
    cache lengths 979-1000), and bf16 over bf16 at a 256-token prefill
    chunk: device time (``torch.profiler``) and the kernels a call
    (one on split-K), the plain version (events),
    ``scaled_dot_product_attention`` in the same type with the boolean
    decode mask where q and the cache share a float type (a yardstick
    the port never calls), and the bound.
36. GPT-2 small all in bf16 (``transformer_lm(dtype=torch.bfloat16)
    .cast(torch.bfloat16)``: a bf16 cache) served as phase 4 serves f32:
    tokens/s, TTFT p50, step p50 and the cache's bytes beside phase 4's
    f32; 12 launches of ``flash_attention_decode.bf16_bf16`` a step and
    a prefill, none of the f32 kernel; teacher-forced logits on the card
    within 2^-4 x max|logit| of the port's bf16 plain path on the CPU;
    greedy agreement with the unbatched loop >= 0.9; the kernel launches
    of one decode step (8 slots, C=1024, cache_len 500; profiler).  Then a
    short run
    (4 requests, 8 new tokens) of every other way the public API builds
    a 16-bit model, each through its own pair: ``dtype=`` only (f32
    queries over a 16-bit cache), ``cast`` only (16-bit queries over an
    f32 cache), both, the int8 cache under a cast model, in bf16 and
    f16, and the two crossed types.
37. Phase 7's BERT-base batch serving on ``cast(torch.bfloat16)``:
    requests/s, e2e p50 / p99 and occupancy beside phase 7's f32; 12
    ``flash_attention.bf16`` launches a batch and no other kernel; every
    answer within 2^-4 x max|ref| of a one-request forward on the card,
    and a padded batch within 2^-4 x max|ref| of the port's bf16 plain
    path on the CPU.
38. ResNet-50 v1 scoring as ``bench.py --infer`` runs ``resnet50_b32``
    and ``resnet50_b128``: NHWC, plain BatchNorm, seeded weights, f32
    and then ``cast(torch.bfloat16)`` with a bf16 input from
    ``RandomState(0)``, an f32 sum of the scores read once after 20
    batches: img/s, ms a batch and peak memory at B=32 and B=128; no
    kernel of the port launched (inference batch norm is plain, as in
    the JAX package); then B=2 at 64x64 on the card against the CPU in
    bf16 at phase 30's rule.

39. The verify skill's LeNet drive as written (the repository's verify
    recipe's canonical drive), with ``import mxnet_tpu_torch as mx``:
    ``mx.random.seed(42)``, ``gluon.data.DataLoader(MNIST(
    train=True).transform_first(transforms.ToTensor()), batch_size=64,
    shuffle=True)``, ``get_model('lenet')``, ``initialize(
    mx.init.Xavier())``, ``hybridize()``, ``SoftmaxCrossEntropyLoss``,
    ``gluon.Trainer('sgd', lr 0.05, momentum 0.9)``, ``record()`` ->
    ``loss.backward()`` -> ``step(64)`` for 120 batches, then accuracy
    over ``MNIST(train=False)`` at batch 256 through
    ``gluon.metric.Accuracy`` > 0.95; once with ``num_workers=0`` and
    once with ``num_workers=2, pin_memory=True``.  Each prints whether
    MNIST is synthetic, img/s over the 120 steps (ending in a
    synchronize) and after the first step (a worker pool starts in the
    first), step p50 (CUDA events), the loader's wait share of the
    wall (``dataloader.wait_seconds``), the busy share of 8 more steps
    (``torch.profiler``) and the accuracy; a batch lands on ``cuda:0`` as
    f32 NCHW in [0, 1] with int32 labels; no kernel of the port launched.

40. The recurrent ops (``ops.rnn.rnn_fused``; PyTorch code, as the JAX
    package's is ``lax.scan``): lstm, gru, rnn_relu and rnn_tanh, 2
    layers, one and two directions, with and without per-row lengths,
    T=35, B=16, 128 -> 128; the outputs and the gradients of all inputs
    on the card against the same code on the CPU from the same seeded
    inputs, each within 1e-4 x its max|ref| (TF32 off).
41. BASELINE config #4 as ``bench.py``'s ``bench_lstm_lm`` writes it,
    with ``import mxnet_tpu_torch as mx``: ``mx.random.seed(0)``,
    ``nn.Embedding(10000, 650)``, ``rnn.LSTM(650, num_layers=2,
    input_size=650)``, ``nn.Dense(10000, flatten=False, in_units=650)``
    built with no device (they must land on ``cuda:0``),
    ``initialize(mx.init.Xavier())``, the bench's loss (f32 log-softmax,
    NLL pick, mean over T), ``ShardedTrainer(optimizer="sgd",
    learning_rate=1.0)`` on ``RandomState(0)`` tokens, B=64, T=35: 2 warm
    and 20 timed steps with ``opt_arena`` launched once a step and no
    other kernel of the port, the loss finite and lower at the end;
    ``lstm_lm_tokens_per_sec_per_chip`` (``bench.py``'s name), step p50,
    CUDA kernels a step and busy share (3 profiled steps); 3 steps on the
    card and on the CPU from one seed, losses within 1e-4 relative and
    weights within 1e-4 x max|w|; and as a yardstick only,
    ``torch.nn.LSTM`` (cuDNN) at the same shape beside ``rnn_fused`` on
    the same weights (outputs within 1e-4 x max|ref|): forward and
    backward device time (profiler) and CUDA-event time.
42. ``LSTMLM(vocab_size=10000, units=650, num_layers=2)`` behind
    ``serve.register_decode`` (8 slots, prompt buckets (8, 16, 32),
    capacity buckets (32, 64), 40 new tokens): ``precision="int8"``
    refused; 512 greedy requests (prompts uniform over 1-32 tokens, a
    synthetic mix) arriving as a Poisson stream at 400/s, more than the
    8 slots serve, so the slots stay full for seconds; each answer equal
    to the eager greedy loop's on the card, or leaving it only where the
    eager logits tie within 1e-4 x max|logit| (batched and one-row
    products sum in different orders), at most 1% of answers so;
    ``serve.cache_grows`` 0 though prompts of 25+ tokens pass the last
    capacity bucket, no kernel of the port; tokens/s with the slots
    full, rows a step, step p50 and mean, prefill p50, TTFT p50 / p99
    (queueing included), CUDA kernels a decode step and busy share.

43. The bounding-box operators (``ops.boxes``; PyTorch code, as the JAX
    package's is jnp) that the SSD path runs, at an SSD-512 batch's size
    (``test_utils.box_op_runs``: 16 images, NMS over 1,360 rows, topk
    800): ``multibox_prior``, ``multibox_target`` (also with two and three
    valid ground truths sharing a best anchor: the forced match gives it
    the last gt index, every call), ``box_iou``, ``box_nms``,
    ``multibox_detection``, ``roi_align`` and ``bipartite_matching`` on
    the card against the CPU: masks, classes, matched indices and NMS
    ids and fill equal, floats within 1e-6 x max|ref|; the NMS time.
44. BASELINE config #5 as ``bench.py``'s ``bench_ssd`` runs it (its full
    branch), with ``import mxnet_tpu_torch as mx``: ``mx.random.seed(0)``,
    ``get_model("ssd_512_resnet50_v1", classes=20)`` built with no
    device (it must land on ``cuda:0``), ``initialize(mx.init.Xavier())``,
    the bench's synthetic images and boxes from ``RandomState(0)``,
    ``training_targets`` on the card, the bench's loss in PyTorch (f32
    log-softmax, the class pick, L1 under the mask),
    ``ShardedTrainer("sgd", lr 0.01, momentum 0.9,
    compute_dtype=torch.bfloat16)``; B=32 at 512x512, 2 warm and 10 timed
    steps: ``ssd_resnet50_train_imgs_per_sec_per_chip`` and
    ``image_size`` (``bench.py``'s names), step p50, peak memory, one
    ``opt_arena`` launch a step and no other kernel of the port, CUDA
    kernels a step, busy share and the split of device time between
    convolutions and elementwise work (3 profiled steps); the loss finite
    and lower at step 12 than at step 1.
45. ``ssd_512_resnet50_v1`` on the card against the CPU from one seed
    at B=2, 128x128, f32 (TF32 off): step 1's loss within 1e-4 relative;
    step 1 in float64 on both, the loss and every gradient within 1e-9
    (relative; x max|g|) (f32 gradients carry up to 22% of a tensor's max
    of rounding here: ``phase_ssd_cpu``); 3 f32 steps' losses and
    weights within the larger of 1e-4 and 3 times the distance between
    runs in other summation orders (CPU threads, the card twice); one
    bf16 step under phase 30's rule.
46. ``detections`` (softmax, decode, NMS) on phase 44's trained model's
    f32 outputs for its batch, on the card and on the CPU from the same
    outputs: class ids and the -1 fill equal, the rest within 1e-6 x
    max|ref|; its time and CUDA kernels a call.
47. The JAX package's SSD drive (``tests/test_boxes.py``'s tiny SSD,
    ``autograd.record()`` and ``gluon.Trainer`` with
    ``SoftmaxCrossEntropyLoss`` + ``HuberLoss``), 8 steps on the card:
    the loss falls.
48. Every loss of ``gluon.loss`` but softmax cross entropy, CTC included
    (``test_utils.LOSS_CASES``, 28 cases over 13 losses), value and
    gradients on the card against the CPU within 1e-5 x max|ref|.
49. The arena kernel's ``sgd`` and ``momentum`` modes at the SSD's
    27,256,400 parameters and ``bench_lstm_lm``'s 19,780,400 beside
    ``torch._fused_sgd_`` (device time; a yardstick the port never calls)
    and the bytes bound; the kernels line's ``opt_arena`` row carries
    them under ``sgd_modes``.

50. ``hybridize()`` as CUDA-graph capture: a ``HybridSequential`` (Dense,
    BatchNorm, Dropout 0.1, Dense; 256 -> 1024 -> 256, B=128) and a
    2-layer BERT at 256 units (dropout 0.1; the flash-attention kernel
    and, under ``record()``, its backward pair), each eager and
    hybridized in one process, from the same seed before every call (the
    same dropout masks), in inference and under ``autograd.record()``:
    outputs and every gradient within ``HYB_BAR`` x max|eager| (bits
    expected), misses equal signatures and later calls hit, kernel launch
    counts on replay equal the eager ones; an update in place read
    without a capture, ``load_parameters(cast_dtype=True)`` one capture,
    two training replays draw different masks, a forward calling
    ``.item()`` raises ``MXNetError``.
51. Phase 4's GPT-2 small behind ``serve.register_decode`` eager
    (``hybridize(False)`` on the entry's blocks) and hybridized, f32,
    bf16 and the int8 cache (phase 4's 16 requests each, the first of
    256 tokens, so the cache grows once), every request queued before
    the worker admits any: every answer equal token for token, no
    capture after the warmup, the server left on the entry's own batch
    cache (a donated cache is never copied: another buffer would have
    been a capture); tokens/s, step p50, a step's device kernels and
    host launch calls and busy share (``torch.profiler``), the capture
    seconds, the memory the graphs and buffers hold and their peak.
52. Phase 42's ``LSTMLM`` the same way, at phase 42's traffic (its 512
    requests arriving as its Poisson stream): answers equal, no capture
    after the warmup, the entry's own cache, no growth.
53. The batch tier eager and hybridized through ``serve.register(...,
    background=True)`` and ``warmup_handle.wait()``: BERT-base in bf16
    at phase 37's requests, and ResNet-50 v1 NHWC in bf16 scoring at
    B = 32 and 128 (an f32 image cast inside the forward; 6 batches, too
    few for a throughput: the model call's readings are the measure):
    answers within ``HYB_BAR`` x max|eager|, no capture after the
    warmup; requests/s or img/s through the server, and one model call's
    time, launch calls and busy share.
54. The verify skill's LeNet drive as written (hybridized: forward and
    backward captured under ``record()``) and without ``hybridize()``,
    both from one numpy seed (the shuffle's) and with cuDNN's
    deterministic algorithms: losses within 1e-6 over the 120 steps;
    img/s, step p50 and busy share of both.
55. A hybridized channel-last ``BatchNormReLU`` (its training forward
    runs ``bn_act_stats``) captured under ``autograd.record()`` at B = 2,
    16 (the statistics workspace grows) and 8, other work on its capture
    stream, then the B = 2 graph replayed on new values: outputs,
    gradients and running statistics within 1e-6 x max|eager| of an eager
    twin's.
56. GPT-2 small (``SERVE_CFG``, 48 new tokens) behind
    ``serve.register_decode`` three ways, each warmed: unified
    (``prefill_workers=0``), a pool of 2 prefill workers with no prefix
    cache, and the pool with its default prefix cache; 64 greedy
    requests of one shared 192-token prefix (drawn once from a seed)
    plus 8-56 unique tokens, all queued at once (8 fill the slots, the
    batch grows 256 -> 512, cross-capacity moves), in f32, then 16 with
    the bf16 cache and 16 with ``precision="int8"``.  Checks: every pool
    and prefix answer equals the unified server's, or leaves it only
    where the top two logits at the first differing token lie within
    1e-4 x max|logit| (2^-6 for the bf16 model's bf16 logits; printed);
    the prefix run's prefills count only the trie's misses and its
    prefix fills the hits (>= n - 8); no capture after warmup; the
    decode kernel launched >= 12 times a step, prefill and prefix fill;
    a hit's last-token logits within 2^-6 x max|logit| of a cold
    prefill's (eager, 4 prompts; printed).  Printed: TTFT p50 / p99 and tokens/s of each
    server, the hit rate and the trie's bytes.  Then the decode kernel at
    a hit's shapes (one row, Tq 32 / 64 from cache_len 192, C 256 / 512;
    f32, bf16 and int8 caches) against its plain version, and its device
    time beside the plain version's, SDPA's and the bound.
57. ``LSTMLM`` at phase 42's widths through ``prefill_workers=1`` beside
    the unified server: 64 of phase 42's prompts at once, answers equal
    (or at a near tie); ``prefix_cache=True`` refused.

58. Tracing and observability behind both serving tiers (``phase_obs``).
59. BERT-base bf16 pretraining from ``mx.np`` inputs, counted and
    profiled (``phase_bert_profile``).
60. The replica fleet at full width: two worker processes of this file's
    ``fleet_spec`` (phase 4's GPT-2 small behind ``register_decode`` and
    phase 7's BERT-base behind ``register``, answering its pooled vector,
    with phase 7's ``Server`` settings) on the one card, spawned by
    ``serve.Fleet(min_replicas=2, max_replicas=2)``; each READY shows
    the decode and flash-forward kernels launched by its warmup.  4
    clients x 16 requests through the ``Router`` (each replica's
    ``/statusz`` launch counts, read at READY and after the load, show
    both kernels launched by its share of the traffic): streamed generates of
    32-256-token prompts (each arriving incrementally; greedy tokens
    equal to the same model served in this process, or leaving it only
    at a near tie, phase 56's rule) and ragged predicts of 16-512 tokens
    (within 1e-4 x max|ref| of this process's ``Server``).  Then a
    SIGKILL of one replica under two predict loaders (every admitted
    request answered; the respawn READY within the bound), 10 predicts
    under ``fleet.dispatch:error:0.5`` (all answered, retries counted),
    ``Fleet.close()`` (no ``mx-*`` thread left).  Printed: routed
    requests/s, streamed tokens/s, TTFT p50 / p99, cold and respawn
    start and build seconds, kill to ready, each replica's peak memory.
61. One ``EdgeServer`` in this process over GPT-2 small on the card: a
    deadline that expires mid-generate answers 504 and frees its slot, a
    client that hangs up mid-stream cancels its request, ``close()``
    drains a stream in flight.
62. BERT-base bf16 pretraining (``ShardedTrainer("adamw")``, phase 24's
    settings) from ``DataLoader(batch_size=32, last_batch="keep",
    pin_memory=True, bucket_spec={1: ("pow2", 32, 128)},
    prefetch_to_device=trainer)`` over seeded rows of 20-128 tokens,
    then the same batches inline: losses equal bit for bit, every batch
    a bucket shape, the prefetched wait p50 below inline's.  Phases
    60-62 are held to 60, 10 and 20 s.
63. Data parallelism, ``bench.py --multichip``'s two configurations at
    full width (ResNet-50 v1 NHWC 224^2, 64 a device, bf16, sgd momentum;
    BERT-base bf16, 8 a device, seq 128, 20 predictions, adam at bench's
    lr and wd: adamw is not arena-fusible).  (a) One rank over NCCL
    (``dist.init`` with a world of 1, ``make_mesh({"dp": -1})``): both
    under ``partition="zero1"`` with the arena, BERT also under
    ``overlap=True``, 2 warm and 5 timed steps; samples/s a device,
    launches a step, peak memory.  (b) Two spawned ranks sharing the
    card over gloo, each on half the per-device batch under zero1 with
    the arena, against one rank of the same global batch built here, at
    step 1 (module comment above ``DP_F32_LOSS_RTOL``): both in bf16 for
    3 steps, the loss and every parameter's and running statistic's
    displacement at phase 30's rule; ResNet-50 in f32 for one, the loss
    and the running statistics at phase 16's rule, which a control world
    with each rank's own batch-norm statistics must fail (a bf16 control
    is reported); the arena launched once a step on each rank over its
    half, and the ResNet's batch norms in the ``bn_act`` dp mode (sums,
    all-reduce, fold) on each rank.
    Then the dp mode's kernels against their plain versions and their
    times.  Held to 120 s; a rank that hangs is killed at 90 s.
64. The other mesh axes, one world of two gloo ranks on the card
    (module comment above ``MA_SECS``): (a) BERT-base as phase 63 builds
    it under zero1 on ``{"dp": 1, "mp": 2}`` (``mp_spec_fn()``) and
    ``{"dp": 2}`` (``fsdp_spec_fn()``), bf16, against one rank on the
    same global batch at step 1 (phase 30's rule), the mp world also in
    f32 (phase 16's loss rule); each rank stores only its shards, its
    accounting equals the JAX trainer's formula computed here, and the
    flash kernels run 12 forward and 12 backward launches a step on each
    rank.  (b) LeNet (bench_lenet's batch 1024) on ``{"pp": 2}``,
    ``grad_accum`` 4, 5 windows against one rank's 5 steps (phase 16's
    loss rule), the bubble gauge 0.2 and the arena once a window;
    ResNet-50 on bench's ``MXNET_PP=2`` mesh refused as mutating.  (c)
    Ring attention on ``{"sp": 2}`` (T 8192) and (d) experts on
    ``{"ep": 2}`` (E 8, 2048 tokens a rank) against their one-rank
    references and the references' gradients.  Held to 150 s.
65. Gluon's layers and deferred shapes (A6c) with Inception v3: (a)
    ``get_model("inceptionv3", layout="NHWC")`` with every width
    deferred, Xavier, one call on a (2, 299, 299, 3) batch that finishes
    the deferred init, then scored as ``bench.py`` ``_infer_child(
    "inceptionv3_b32")`` runs it: B=32 on 299^2 in f32 and, after
    ``cast(bf16)``, in bf16, each eager and captured (``hybridize()``,
    the captured scores within 1e-6 x max of the eager ones); no kernel
    of the port launched, every parameter and running statistic bf16,
    and bf16 B=2 scores on the card against the CPU at phase 38's bar.
    (b) A fresh deferred Inception v3 refused by ``ShardedTrainer`` with
    ``DeferredInitializationError``, then run once and trained for 5
    steps at B=32 in bf16 (sgd, momentum 0.9): ``opt_arena`` in its
    momentum mode once a step and no other kernel, and step 1 at B=2 on
    the card against the CPU at phase 30's rule (dropout's rate 0 in
    those nets: each device draws its own masks); the arena at Inception
    v3's parameter count beside its plain version and
    ``torch._fused_sgd_``.  (c) A Gluon user's net of A6c's layers
    with every width but PReLU's deferred (``Sequential``,
    ``HybridConcatenate``, ``Conv2D``, ``GroupNorm``, ``InstanceNorm``,
    ``PReLU``, ``AvgPool2D(ceil_mode=True)``, ``Conv2DTranspose``,
    ``ReflectionPad2D``, ``PixelShuffle2D``, ``Dense``; widths 64-256),
    trained eagerly for 3 steps through ``gluon.Trainer`` built before
    the first call, then hybridized: captured scores within 1e-6 x max
    of the eager ones.  Held to 90 s.

It prints a ``{"kernels": [...]}`` line, the card line, and as the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM dense TF32 on tensor cores
TOL = 1e-4
B, H, D = 8, 12, 64
GPT2_SMALL = dict(vocab_size=50257, units=768, hidden_size=3072,
                  num_layers=12, num_heads=12, max_length=1024)
SERVE_CFG = dict(slots=8, prompt_buckets=(32, 64, 128, 256),
                 capacity_buckets=(256, 512, 1024), max_new_tokens=64)
BERT_BASE = dict(vocab_size=30522, max_length=512)   # + bert_12_768_12 spec
BERT_BUCKETS = {0: [1, 2, 4, 8, 16], 1: ("pow2", 32, 512)}
BERT_REQUESTS = 64


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def xavier_init(net, seed):
    """``mx.random.seed(seed)`` then ``net.initialize(mx.init.Xavier())``,
    as ``bench.py`` builds its nets (``test_utils.xavier_init``)."""
    from mxnet_tpu_torch.test_utils import xavier_init as init

    return init(net, seed)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs
def make_case(c, tq, quantized, lens, seed, device):
    """q/k/v (+ scales) with NaN garbage past every row's attended window.
    Returns the kernel's inputs and the plain version's (whose values and
    value scales have the garbage zeroed: a masked position must be
    skipped by the kernel, and the plain version multiplies it by 0)."""
    from mxnet_tpu_torch.ops import attention as att

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.rand(B, H, tq, D, generator=g) - 0.5
    k = torch.rand(B, H, c, D, generator=g) - 0.5
    v = torch.rand(B, H, c, D, generator=g) - 0.5
    lens_t = torch.tensor(lens, dtype=torch.int32)
    garbage = (torch.arange(c)[None, :] >= (lens_t[:, None] + tq))
    garbage = garbage[:, None, :, None].expand(B, H, c, 1)
    kw = {}
    if quantized:
        k, ks = att.quantize_kv(k)
        v, vs = att.quantize_kv(v)
        ks = ks.masked_fill(garbage, float("nan"))
        vs = vs.masked_fill(garbage, float("nan"))
        kw = dict(k_scale=ks, v_scale=vs)
        ref_kw = dict(k_scale=ks, v_scale=torch.nan_to_num(vs))
        ref_v = v
    else:
        k = k.masked_fill(garbage, float("nan"))
        v = v.masked_fill(garbage, float("nan"))
        ref_kw, ref_v = {}, torch.nan_to_num(v)
    move = (lambda d: {n: t.to(device) for n, t in d.items()})
    kern = dict(q=q, k=k, v=v, cache_len=lens_t, **kw)
    plain = dict(q=q, k=k, v=ref_v, cache_len=lens_t, **ref_kw)
    return move(kern), move(plain)


def case_lens(c, tq):
    """Per-row cache lengths: an inert row, the kv-tile edges and the
    largest lengths that still fit the chunk."""
    top = c - tq
    cand = [0, 1, 63, 64, 65, 127, top - 1, top]
    return [min(max(x, 0), top) for x in cand][:B]


# ------------------------------------------------------------- timing
def cuda_time_ms(fn, nbuf, iters=20, reps=5):
    """Median over ``reps`` of the mean time of ``iters`` launches, CUDA
    events, after a warmup; ``fn(i)`` cycles ``nbuf`` input copies so the
    cache does not sit in L2 between launches when ``nbuf > 1``."""
    for i in range(3):
        fn(i % nbuf)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(iters):
            fn(i % nbuf)
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


DEVICE_TIME_BY = {"torch.profiler": 0, "events behind a spin": 0}
PROFILER_TRIES = 3


def kernel_records(fn, nbuf, calls):
    """``torch.profiler``'s kernel records over ``calls`` calls of
    ``fn(i)``: (device microseconds a call, kernels a call), or None.
    CUPTI now and then hands back no kernel record, or only some (one run
    read a kernel at 0.43 of its time by summing what it kept).  So each
    kernel counts as its mean recorded duration times its launches a call
    (its records over the calls, a whole number within 10%); a profile
    with none, or further off, gives None and is taken again by the
    callers."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i % nbuf)
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        k = round(e.count / calls)
        if k == 0 or abs(e.count - k * calls) > 0.1 * k * calls:
            return None
        us += e.device_time_total / e.count * k
        n += k
    return (us, n) if n else None


def profiled_ms_per_call(fn, nbuf, calls):
    """Device time (ms) of one ``fn(i)`` call from ``torch.profiler``'s
    kernel records over ``calls`` calls (``kernel_records``), or None."""
    rec = kernel_records(fn, nbuf, calls)
    return None if rec is None else rec[0] / 1e3


def spun_ms_per_call(fn, nbuf, calls):
    """Device time of one ``fn(i)`` call by CUDA events: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host queues all
    ``calls`` calls, so the events bracket the calls' kernels run back to
    back and none of the host's launch time.  The spin is lengthened until
    the start event is still pending once the last call is queued."""
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i % nbuf)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(1_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / s.elapsed_time(e)
    spin_ms = max(5.0, 4 * host_ms)
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        s.record()
        for i in range(calls):
            fn(i % nbuf)
        e.record()
        covered = not s.query()      # the spin outlasted the host's queueing
        torch.cuda.synchronize()
        if covered:
            return s.elapsed_time(e) / calls
        spin_ms *= 4
    check(False, f"a spin of {spin_ms:.0f} ms did not outlast the host's "
          f"queueing of {calls} calls")


def device_ms_per_call(fn, nbuf, calls=20):
    """Device time of one ``fn(i)`` call: ``torch.profiler``'s kernel
    records (up to ``PROFILER_TRIES`` profiles); where every profile
    records no device time, CUDA events behind a spin
    (``spun_ms_per_call``).  ``DEVICE_TIME_BY`` counts which one gave each
    time; the kernels line reports it."""
    for i in range(3):
        fn(i % nbuf)
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        ms = profiled_ms_per_call(fn, nbuf, calls)
        if ms is not None:
            DEVICE_TIME_BY["torch.profiler"] += 1
            return ms
    ms = spun_ms_per_call(fn, nbuf, calls)
    print(f"  device time by events behind a spin: {ms:.4f} ms (the "
          f"profiler recorded no device time in {PROFILER_TRIES} profiles)")
    DEVICE_TIME_BY["events behind a spin"] += 1
    check(ms > 0, "no device time by either the profiler or events")
    return ms


def kernels_per_call(fn, nbuf, calls=10):
    """Kernels the card runs a call of ``fn(i)``: ``torch.profiler``'s
    kernel records over ``calls`` calls (``kernel_records``; up to
    ``PROFILER_TRIES`` profiles, as ``device_ms_per_call``), or None."""
    for _ in range(PROFILER_TRIES):
        rec = kernel_records(fn, nbuf, calls)
        if rec is not None:
            return rec[1]
    return None


def two_bounds(nbytes, flops):
    """The least time (ms) for ``nbytes`` of HBM traffic and ``flops`` of
    f32 work, two ways: ``f32`` on CUDA cores, max(bytes / 3.35e12,
    flops / 67e12); ``tf32x3`` as the tensor-core kernels run it,
    max(bytes / 3.35e12, 3 flops / 495e12) (three TF32 products per f32
    product).  Each an ``(ms, "bytes" or "operations")`` pair."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3

    def pick(t_ops):
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    return dict(f32=pick(flops / F32_FLOP_PER_S * 1e3),
                tf32x3=pick(3 * flops / TF32_FLOP_PER_S * 1e3))


def bound(b, h, tq, c, d, lens, quantized):
    """Least time (ms) for decode attention on these inputs: each input
    read once (only the cache positions the rows attend), each output
    written once, over the HBM rate; or the multiply-adds over the peak
    (f32 CUDA cores, and 3xTF32 tensor cores: ``two_bounds``)."""
    kv_pos = sum(min(l + tq, c) for l in lens) * h     # attended positions
    elt = 1 if quantized else 4
    nbytes = (b * h * tq * d * 4              # q
              + 2 * kv_pos * d * elt          # k and v
              + (2 * kv_pos * 4 if quantized else 0)   # their scales
              + b * 4                         # cache_len
              + b * h * tq * d * 4)           # out
    attended = sum(min(l + i + 1, c) for l in lens for i in range(tq)) * h
    flops = 4 * d * attended                  # q.k and p.v, 2 flops each
    return two_bounds(nbytes, flops), nbytes, flops


def time_shape(b, tq, c, lens, quantized, dev, label, d=D, device=False):
    from mxnet_tpu_torch.ops import attention as att

    g = torch.Generator(device="cpu").manual_seed(7)
    one = b * H * c * d * (1 if quantized else 4) * 2
    nbuf = max(1, math.ceil(200e6 / one)) if one > 4e6 else 1
    bufs = []
    for _ in range(nbuf):
        q = (torch.rand(b, H, tq, d, generator=g) - 0.5).to(dev)
        k = (torch.rand(b, H, c, d, generator=g) - 0.5).to(dev)
        v = (torch.rand(b, H, c, d, generator=g) - 0.5).to(dev)
        kw = {}
        if quantized:
            k, ks = att.quantize_kv(k)
            v, vs = att.quantize_kv(v)
            kw = dict(k_scale=ks, v_scale=vs)
        bufs.append((q, k, v, kw))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = att.decode_mask(lens_t, tq, c)
    got = att.flash_attention_decode(*bufs[0][:3], lens_t, **bufs[0][3])
    want = att.flash_attention_decode_reference(*bufs[0][:3], lens_t,
                                                **bufs[0][3])
    err = (got - want).abs().max().item()
    check(bool(((got - want).abs() <= TOL + TOL * want.abs()).all()),
          f"{label}: timed inputs off by {err:.3e} over atol=rtol={TOL}")

    def kern_fn(i):
        return att.flash_attention_decode(*bufs[i][:3], lens_t, **bufs[i][3])

    def lib_fn(i):
        return F.scaled_dot_product_attention(*bufs[i][:3], attn_mask=mask)

    kern = cuda_time_ms(kern_fn, nbuf)
    plain = cuda_time_ms(lambda i: att.flash_attention_decode_reference(
        *bufs[i][:3], lens_t, **bufs[i][3]), nbuf)
    lib = None if quantized else cuda_time_ms(lib_fn, nbuf)
    kern_dev = lib_dev = None
    kern_spun = per_call = None
    if device:   # device time alone: events count a wrapper's host time
        kern_dev = device_ms_per_call(kern_fn, nbuf)
        lib_dev = None if quantized else device_ms_per_call(lib_fn, nbuf)
        # the profiler's fallback, run on every such row to hold it to
        # the profiler's reading
        kern_spun = spun_ms_per_call(kern_fn, nbuf, 20)
        per_call = kernels_per_call(kern_fn, nbuf)
    bd, nbytes, flops = bound(b, H, tq, c, d, lens, quantized)
    length, splits = att.split_plan(
        b * H, tq, c, d, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    path = f"split-K S={splits} L={length}" if splits else "chunk"
    (bnd, by), (t3, t3_by) = bd["f32"], bd["tf32x3"]
    dev_note = "" if not device else (
        f"; device time kernel {kern_dev:.4f} ms (events behind a spin "
        f"{kern_spun:.4f} ms), SDPA "
        f"{'n/a' if lib_dev is None else f'{lib_dev:.4f} ms'}, "
        f"{per_call} kernel launches a call")
    print(f"  time {label}: B={b} Tq={tq} C={c} d={d} cache_len~{lens[0]} "
          f"({path}) kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
          f"{'n/a' if lib is None else f'{lib:.4f} ms'}{dev_note}; bound "
          f"max({nbytes} B / 3.35e12 B/s, {flops} flop / 67e12 flop/s) = "
          f"{bnd:.4f} ms ({by}), 3xTF32 {t3:.4f} ms ({t3_by}); {nbuf} "
          f"input copies")
    return dict(shape=dict(B=b, H=H, Tq=tq, C=c, d=d, cache_len=lens),
                ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by=by, bound_f32_ms=bnd, bound_f32_by=by,
                bound_tf32x3_ms=t3, bound_tf32x3_by=t3_by,
                device_ms=kern_dev, device_spun_ms=kern_spun,
                library_device_ms=lib_dev, splits=splits, split_len=length,
                launches_per_call=per_call, max_abs_err=err)


# ------------------------------------------------------------- phases
def phase_build():
    from mxnet_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  nvcc {name}: " + " | ".join(usage[:8]))
    print(f"phase 1 build: {len(_build.sources())} source(s) in "
          f"{secs:.2f} s ({len(logs)} built now) on {card_line()}")


def phase_kernels(dev):
    from mxnet_tpu_torch.ops import attention as att

    worst = {}
    for quantized in (False, True):
        name = "flash_attention_decode_int8" if quantized else \
            "flash_attention_decode"
        worst[name] = 0.0
        for c in (256, 1024):
            for tq in (1, 7, 64, 256):
                lens = case_lens(c, tq)
                kern_in, plain_in = make_case(c, tq, quantized, lens,
                                              seed=c + tq, device=dev)
                out, lse = att.flash_attention_decode(**kern_in,
                                                      return_lse=True)
                torch.cuda.synchronize()
                ref, ref_lse = att.flash_attention_decode_reference(
                    **plain_in, return_lse=True)
                check(bool(torch.isfinite(out).all()),
                      f"{name} C={c} Tq={tq}: non-finite output")
                err = 0.0
                for got, want in ((out, ref), (lse, ref_lse)):
                    diff = (got - want).abs()
                    check(bool((diff <= TOL + TOL * want.abs()).all()),
                          f"{name} C={c} Tq={tq}: max err "
                          f"{diff.max().item():.3e} over atol=rtol={TOL}")
                    err = max(err, diff.max().item())
                inert = (out[0, :, 0] - kern_in["v"][0, :, 0].float() *
                         (kern_in["v_scale"][0, :, 0] if quantized else 1.0)
                         ).abs().max().item()
                check(inert <= TOL, f"{name}: inert row is not v[0] ({inert})")
                worst[name] = max(worst[name], err)
                print(f"  {name} C={c:4d} Tq={tq:3d} lens={lens}: "
                      f"max abs err {err:.3e}")
    print(f"phase 2 kernels vs plain: all within atol=rtol={TOL} "
          "(TF32 off for matmul and cuDNN)")
    return worst


def split_case(b, tq, c, d, lens, quantized, seed, device):
    """B x H x Tq x d queries against a (B, H, C, d) cache with NaN past
    each row's window (in the values, or in an int8 cache's scales).
    Returns the kernel's inputs and the plain version's (garbage zeroed
    where the plain version multiplies it by 0)."""
    from mxnet_tpu_torch.ops import attention as att

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.rand(b, H, tq, d, generator=g) - 0.5
    k = torch.rand(b, H, c, d, generator=g) - 0.5
    v = torch.rand(b, H, c, d, generator=g) - 0.5
    lens_t = torch.tensor(lens, dtype=torch.int32)
    past = (torch.arange(c)[None, :] >= lens_t[:, None] + tq)
    past = past[:, None, :, None]
    if quantized:
        k, ks = att.quantize_kv(k)
        v, vs = att.quantize_kv(v)
        ks = ks.masked_fill(past, float("nan"))
        vs = vs.masked_fill(past, float("nan"))
        kern = dict(q=q, k=k, v=v, cache_len=lens_t, k_scale=ks, v_scale=vs)
        plain = dict(kern, v_scale=torch.nan_to_num(vs))
    else:
        k = k.masked_fill(past, float("nan"))
        v = v.masked_fill(past, float("nan"))
        kern = dict(q=q, k=k, v=v, cache_len=lens_t)
        plain = dict(kern, v=torch.nan_to_num(v))
    move = (lambda x: {n: t.to(device) for n, t in x.items()})
    return move(kern), move(plain)


def phase_decode_splits(dev, worst):
    """Phase 2b: the split-K plan's edges against the plain version."""
    from mxnet_tpu_torch.ops import attention as att

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 0
    for quantized in (False, True):
        name = "flash_attention_decode_int8" if quantized else \
            "flash_attention_decode"
        for d in (36, 64, 264, 320):
            errs, plans = [], set()
            for c in (100, 1024, 4096):
                for tq in (1, 4, 7):
                    length, splits = att.split_plan(4 * H, tq, c, d, sms)
                    plans.add((length, splits))
                    step = length if splits else 64
                    lens = [0, 1, min(c - tq, step + step // 2),
                            max(0, min(c, 2 * step) - tq)]
                    kern_in, plain_in = split_case(4, tq, c, d, lens,
                                                   quantized,
                                                   seed=c + 10 * tq + d,
                                                   device=dev)
                    out, lse = att.flash_attention_decode(**kern_in,
                                                          return_lse=True)
                    again = att.flash_attention_decode(**kern_in)
                    torch.cuda.synchronize()
                    ref, ref_lse = att.flash_attention_decode_reference(
                        **plain_in, return_lse=True)
                    check(bool(torch.isfinite(out).all()),
                          f"{name} split C={c} Tq={tq} d={d}: non-finite")
                    check(bool(torch.equal(out, again)),
                          f"{name} split C={c} Tq={tq} d={d}: two calls "
                          "differ")
                    for got, want in ((out, ref), (lse, ref_lse)):
                        diff = (got - want).abs()
                        check(bool((diff <= TOL + TOL * want.abs()).all()),
                              f"{name} split C={c} Tq={tq} d={d} lens="
                              f"{lens}: max err {diff.max().item():.3e} over"
                              f" atol=rtol={TOL}")
                        errs.append(diff.max().item())
                    n += 1
            worst[name] = max(worst[name], max(errs))
            print(f"  {name} d={d:3d}: 9 cases (C 100/1024/4096 x Tq "
                  f"1/4/7), plans (L, S) {sorted(plans)}, max abs err "
                  f"{max(errs):.3e}, same bits twice")
    print(f"phase 2b split-K decode vs plain: {n} cases within "
          f"atol=rtol={TOL}, NaN past every window never read")


def phase_times(dev):
    rows = {}
    decode_lens = [1000 - 3 * i for i in range(B)]
    for quantized in (False, True):
        name = "flash_attention_decode_int8" if quantized else \
            "flash_attention_decode"
        rows[name] = dict(
            decode=time_shape(B, 1, 1024, decode_lens, quantized, dev,
                              f"{name} decode", device=True),
            prefill=time_shape(1, 256, 256, [0], quantized, dev,
                               f"{name} prefill"),
            # shapes beyond the TPU kernel's tiling: a 1024-token prefill
            # chunk, a cache capacity that is no multiple of 8, d = 36
            prefill_1024=time_shape(1, 1024, 1100, [0], quantized, dev,
                                    f"{name} prefill Tq=1024", device=True),
            decode_c100=time_shape(B, 1, 100, [90 - i for i in range(B)],
                                   quantized, dev, f"{name} decode C=100"),
            decode_d36=time_shape(B, 1, 1024, decode_lens, quantized, dev,
                                  f"{name} decode d=36", d=36))
    return rows


def pct(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def serve_run(lm, name, n_req, seed, precision=None):
    """Register ``lm``, serve ``n_req`` greedy requests, return the
    prompts, results, launch deltas and telemetry."""
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.kernels import registry

    t0 = time.perf_counter()
    serve.register_decode(name, lm, precision=precision, **SERVE_CFG)
    warm = time.perf_counter() - t0
    rs = np.random.RandomState(seed)
    lengths = rs.randint(16, 257, size=n_req)
    lengths[0] = 256                 # 256 + 64 tokens outgrow C = 256
    prompts = [rs.randint(0, GPT2_SMALL["vocab_size"], size=n).tolist()
               for n in lengths]
    telemetry.reset()
    registry.reset_launches()
    t0 = time.perf_counter()
    futs = [serve.decode_submit(name, p) for p in prompts]
    results = [f.result(600.0) for f in futs]
    wall = time.perf_counter() - t0
    launches = registry.launches()
    snap = telemetry.snapshot()
    serve.shutdown_decode(120.0)
    lm.hybridize(False)          # the phase's own references run eagerly
    return dict(prompts=prompts, results=results, wall=wall, warm=warm,
                launches=launches, snap=snap)


def greedy_unbatched(lm, prompt, n_new):
    """One request alone: prefill, then one-row steps (no batching)."""
    cap = 512 if len(prompt) + n_new > 256 else 256
    cache = lm.begin_cache(1, cap)
    logits, cache = lm(np.asarray([prompt]), cache, [0], [len(prompt)])
    out = [int(logits[0, -1].argmax())]
    for i in range(n_new - 1):
        logits, cache = lm(np.asarray([[out[-1]]]), cache,
                           [len(prompt) + i], [1])
        out.append(int(logits[0, 0].argmax()))
    return out


def phase_serve_f32(dev, card):
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm

    t0 = time.perf_counter()
    lm = xavier_init(transformer_lm(device=dev, **GPT2_SMALL), 0)
    torch.cuda.synchronize()
    print(f"  model on {dev}: "
          f"{sum(p.numel() for p in lm.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.2f} s")
    run = serve_run(lm, "gpt2s", 16, seed=1)
    snap, launches = run["snap"], run["launches"]
    steps = snap["serve.decode_step_seconds"]["count"]
    prefills = snap["serve.prefill_seconds"]["count"]
    n_f32 = launches["flash_attention_decode"]
    check(all(len(r) == SERVE_CFG["max_new_tokens"] for r in run["results"]),
          "a future resolved short of max_new_tokens")
    check(n_f32 >= GPT2_SMALL["num_layers"] * (steps + prefills),
          f"decode kernel launches {n_f32} < 12 x ({steps} steps + "
          f"{prefills} prefills)")
    check(snap.get("serve.cache_grows", {"value": 0})["value"] >= 1,
          "the cache never grew past its first capacity bucket")
    tokens = sum(len(r) for r in run["results"])

    # teacher-forced logits on the card vs the port's plain path on the CPU
    seq = run["prompts"][1] + run["results"][1]
    cpu_lm = transformer_lm(device="cpu", **GPT2_SMALL)
    cpu_lm.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    cap = 512 if len(seq) > 256 else 256
    gpu_logits, _ = lm(np.asarray([seq]), lm.begin_cache(1, cap), [0],
                       [len(seq)])
    cpu_logits, _ = cpu_lm(np.asarray([seq]), cpu_lm.begin_cache(1, cap),
                           [0], [len(seq)])
    delta = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    scale = cpu_logits.abs().max().item()
    check(delta <= 1e-3 * scale,
          f"teacher-forced logits differ by {delta:.3e} > 1e-3 x {scale:.3e}")
    del cpu_lm

    same = total = 0
    for prompt, got in zip(run["prompts"], run["results"]):
        want = greedy_unbatched(lm, prompt, len(got))
        same += sum(a == b for a, b in zip(got, want))
        total += len(got)
    agree = same / total
    check(agree >= 0.9, f"served greedy agrees with unbatched greedy in "
          f"{agree:.3f} of positions < 0.9")
    ttft = snap["serve.ttft_seconds"]["p50"]
    step = snap["serve.decode_step_seconds"]["p50"]
    print(f"  launches {launches} for {steps} steps + {prefills} prefills "
          f"(12 layers each); cache grows "
          f"{snap['serve.cache_grows']['value']}")
    print(f"  teacher-forced logits over {len(seq)} tokens: max |gpu - cpu| "
          f"{delta:.3e} (bar 1e-3 x {scale:.3e}); greedy agreement with the "
          f"unbatched loop {agree:.4f} over {total} positions")
    print(f"phase 4 serve f32: {tokens} tokens in {run['wall']:.3f} s = "
          f"{tokens / run['wall']:.1f} tokens/s, TTFT p50 {ttft * 1e3:.2f} ms, "
          f"decode step p50 {step * 1e3:.3f} ms, warmup {run['warm']:.2f} s "
          f"[{card}]")
    return lm, dict(tokens_per_s=tokens / run["wall"], ttft_p50_ms=ttft * 1e3,
                    step_p50_ms=step * 1e3, launches=n_f32,
                    steps=steps, prefills=prefills, agreement=agree,
                    logit_delta=delta)


def phase_serve_int8(lm, card):
    run = serve_run(lm, "gpt2s_int8", 8, seed=2, precision="int8")
    launches, snap = run["launches"], run["snap"]
    n_i8 = launches["flash_attention_decode_int8"]
    steps = snap["serve.decode_step_seconds"]["count"]
    prefills = snap["serve.prefill_seconds"]["count"]
    check(all(len(r) == SERVE_CFG["max_new_tokens"] for r in run["results"]),
          "an int8 future resolved short of max_new_tokens")
    check(n_i8 >= GPT2_SMALL["num_layers"] * (steps + prefills) and
          launches["flash_attention_decode"] == 0,
          f"int8 kernel launches {launches} for {steps} steps + "
          f"{prefills} prefills")
    tokens = sum(len(r) for r in run["results"])
    ttft = snap["serve.ttft_seconds"]["p50"]
    step = snap["serve.decode_step_seconds"]["p50"]
    print(f"  launches {launches} for {steps} steps + {prefills} prefills")
    print(f"phase 5 serve int8 cache: {tokens} tokens in {run['wall']:.3f} s "
          f"= {tokens / run['wall']:.1f} tokens/s, TTFT p50 "
          f"{ttft * 1e3:.2f} ms, decode step p50 {step * 1e3:.3f} ms [{card}]")
    return dict(tokens_per_s=tokens / run["wall"], ttft_p50_ms=ttft * 1e3,
                step_p50_ms=step * 1e3, launches=n_i8, steps=steps,
                prefills=prefills)


# ------------------------------------------------------- flash attention
FLASH_B, FLASH_T = 4, (1, 37, 128, 512)
FLASH_D = (64, 128, 256, 264, 320, 512)
BWD_D = (36, 64, 100, 128, 256, 264, 320, 512)  # phase 8: off the 8-grid too


def flash_case(t, d, lens, seed, device):
    """q/k/v (B=4, H=12, T, d) with NaN garbage in k/v past each row's
    length.  Returns the kernel's inputs and the plain version's (values
    with the garbage zeroed: the plain version multiplies a masked
    position by 0, the kernel never reads it)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.rand(FLASH_B, H, t, d, generator=g) - 0.5
               for _ in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    garbage = (torch.arange(t)[None, :] >= lens_t[:, None])[:, None, :, None]
    k = k.masked_fill(garbage, float("nan"))
    v = v.masked_fill(garbage, float("nan"))
    kern = dict(q=q, k=k, v=v, kv_valid_length=lens_t)
    plain = dict(q=q, k=k, v=torch.nan_to_num(v), kv_valid_length=lens_t)
    move = (lambda x: {n: x_.to(device) for n, x_ in x.items()})
    return move(kern), move(plain)


def phase_flash_kernel(dev):
    from mxnet_tpu_torch.ops import attention as att

    worst, n = 0.0, 0
    for d in FLASH_D:
        for t in FLASH_T:
            errs = []
            for causal in (False, True):
                for part, lens in enumerate(([0, 1, 63, 64],
                                             [65, t, t, 1])):
                    lens = [min(x, t) for x in lens]
                    kern_in, plain_in = flash_case(
                        t, d, lens, seed=d * 1000 + t * 2 + part, device=dev)
                    out, lse = att.flash_attention(**kern_in, causal=causal,
                                                   return_lse=True)
                    again = att.flash_attention(**kern_in, causal=causal)
                    torch.cuda.synchronize()
                    ref, ref_lse = att.flash_attention_reference(
                        **plain_in, causal=causal, return_lse=True)
                    check(bool(torch.isfinite(out).all()),
                          f"flash d={d} T={t} causal={causal}: non-finite "
                          "output")
                    check(bool(torch.equal(out, again)),
                          f"flash d={d} T={t} causal={causal}: two calls "
                          "differ")
                    for got, want in ((out, ref), (lse, ref_lse)):
                        # lse is -inf on an empty row in both versions
                        same_inf = torch.isinf(want) & (got == want)
                        diff = torch.where(same_inf, torch.zeros_like(got),
                                           (got - want).abs())
                        check(bool((diff <= TOL + TOL * want.abs()).all()),
                              f"flash d={d} T={t} causal={causal} lens="
                              f"{lens}: max err {diff.max().item():.3e} "
                              f"over atol=rtol={TOL}")
                        errs.append(diff.max().item())
                    n += 1
            worst = max(worst, max(errs))
            print(f"  flash_attention d={d:3d} T={t:3d}: 4 cases (causal "
                  f"off/on x 2 length sets), max abs err {max(errs):.3e}")
    # Tq != Tk on views at storage offset 1 (not 16-byte aligned)
    for d in (64, 320):
        for tq, tk in ((70, 130), (129, 65)):
            for causal in (False, True):
                g = torch.Generator(device="cpu").manual_seed(tq + d)
                x = [torch.rand(FLASH_B, H, t_, d, generator=g) - 0.5
                     for t_ in (tq, tk, tk)]
                views = []
                for t_ in x:
                    flat = torch.empty(t_.numel() + 1, device=dev)
                    flat[1:] = t_.reshape(-1).to(dev)
                    views.append(flat[1:].view(t_.shape))
                check(views[0].data_ptr() % 16 != 0, "view is aligned")
                lens = torch.tensor([min(tk, n_) for n_ in (0, 1, 63, tk)],
                                    dtype=torch.int32, device=dev)
                out, lse = att.flash_attention(*views, causal=causal,
                                               kv_valid_length=lens,
                                               return_lse=True)
                torch.cuda.synchronize()
                ref, ref_lse = att.flash_attention_reference(
                    *views, causal=causal, kv_valid_length=lens,
                    return_lse=True)
                for got, want in ((out, ref), (lse, ref_lse)):
                    same_inf = torch.isinf(want) & (got == want)
                    diff = torch.where(same_inf, torch.zeros_like(got),
                                       (got - want).abs())
                    check(bool((diff <= TOL + TOL * want.abs()).all()),
                          f"flash d={d} Tq={tq} Tk={tk} causal={causal} "
                          f"unaligned: max err {diff.max().item():.3e}")
                    worst = max(worst, diff.max().item())
                n += 1
    print("  flash_attention Tq != Tk (70 x 130, 129 x 65), d 64 / 320, "
          "unaligned views: 8 cases")
    print(f"phase 6a flash kernel vs plain: {n} cases within atol=rtol={TOL}"
          " (TF32 off), the same bits on two calls")
    return worst


def flash_bound(b, t, d, lens):
    """Least time (ms) for the flash forward on these inputs: q read and
    out written in full, k and v read only over each row's valid keys,
    over the HBM rate; or 4 d flops per attended (query, key) pair over
    the peak (``two_bounds``: f32 CUDA cores, 3xTF32 tensor cores)."""
    keys = sum(min(x, t) for x in lens) * H        # valid key rows
    nbytes = (2 * b * H * t * d * 4              # q and out
              + 2 * keys * d * 4                 # k and v
              + b * 4)                           # lengths
    flops = 4 * d * t * keys                     # q.k and p.v, 2 each
    return two_bounds(nbytes, flops), nbytes, flops


def time_flash(b, t, lens, dev, label, d=D, device=False):
    from mxnet_tpu_torch.ops import attention as att

    g = torch.Generator(device="cpu").manual_seed(11)
    one = 3 * b * H * t * d * 4
    nbuf = max(1, math.ceil(200e6 / one))
    bufs = [tuple((torch.rand(b, H, t, d, generator=g) - 0.5).to(dev)
                  for _ in range(3)) for _ in range(nbuf)]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :]
            < lens_t[:, None])[:, None, None, :]

    def kern_fn(i):
        return att.flash_attention(*bufs[i], kv_valid_length=lens_t)

    def lib_fn(i):
        return F.scaled_dot_product_attention(*bufs[i], attn_mask=mask)

    kern = cuda_time_ms(kern_fn, nbuf)
    plain = cuda_time_ms(lambda i: att.flash_attention_reference(
        *bufs[i], kv_valid_length=lens_t), nbuf)
    lib = cuda_time_ms(lib_fn, nbuf)
    kern_dev = lib_dev = None
    if device:
        kern_dev = device_ms_per_call(kern_fn, nbuf)
        lib_dev = device_ms_per_call(lib_fn, nbuf)
    bd, nbytes, flops = flash_bound(b, t, d, lens)
    (bnd, by), (f32, f32_by) = bd["tf32x3"], bd["f32"]
    dev_note = "" if not device else (
        f"; device time kernel {kern_dev:.4f} ms, SDPA {lib_dev:.4f} ms")
    print(f"  time {label}: B={b} H={H} T={t} d={d} kv_len "
          f"{min(lens)}..{max(lens)} kernel {kern:.4f} ms, plain "
          f"{plain:.4f} ms, SDPA {lib:.4f} ms{dev_note}; bound 3xTF32 "
          f"max({nbytes} B / 3.35e12 B/s, 3 x {flops} flop / 495e12 "
          f"flop/s) = {bnd:.4f} ms ({by}), f32 CUDA cores {f32:.4f} ms "
          f"({f32_by}); {nbuf} input copies")
    return dict(shape=dict(B=b, H=H, T=t, d=d, kv_len=lens), ms=kern,
                plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                bound_f32_ms=f32, bound_f32_by=f32_by, device_ms=kern_dev,
                library_device_ms=lib_dev)


def phase_flash_times(dev):
    rs = np.random.RandomState(5)
    lens16 = rs.randint(16, 513, size=16).tolist()
    lens16[0] = 512
    lens8 = rs.randint(16, 129, size=8).tolist()
    lens8[0] = 128
    rows = dict(serve_b16=time_flash(16, 512, lens16, dev, "flash B=16",
                                     device=True),
                serve_b8=time_flash(8, 128, lens8, dev, "flash B=8"),
                serve_b8_d36=time_flash(8, 128, lens8, dev,
                                        "flash B=8 d=36", d=36))
    print("phase 6b flash times: done")
    return rows


# ------------------------------------------------------ BERT-base serving
def bert_requests(n, seed):
    """``n`` requests (tokens, token_types, valid_length) of 16-512
    tokens: one at 512, one under 32, half with a second segment."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(16, 513, size=n)
    lengths[0], lengths[1] = 512, 20
    reqs = []
    for i, t in enumerate(lengths):
        tokens = rs.randint(0, BERT_BASE["vocab_size"], size=t)
        types = np.zeros(t, np.int32)
        if i % 2:
            types[t // 2:] = 1
        reqs.append((tokens.astype(np.int32), types,
                     np.asarray(t, np.int32)))
    return reqs


def phase_bert(dev, card):
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.gluon.model_zoo import bert_12_768_12
    from mxnet_tpu_torch.kernels import registry

    t0 = time.perf_counter()
    bert = xavier_init(bert_12_768_12(dropout=0.0, device=dev, **BERT_BASE),
                       0)
    torch.cuda.synchronize()
    print(f"  bert_12_768_12 on {dev}: "
          f"{sum(p.numel() for p in bert.parameters())} parameters, built "
          f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    entry = serve.register(
        "bert", bert, bucketer=BERT_BUCKETS,
        sample=(np.zeros(32, np.int32), np.zeros(32, np.int32),
                np.asarray(32, np.int32)))
    warm = time.perf_counter() - t0
    reqs = bert_requests(BERT_REQUESTS, seed=3)
    srv = serve.Server(max_wait_ms=5, max_batch=16)
    telemetry.reset()
    registry.reset_launches()
    t0 = time.perf_counter()
    futs = [srv.submit("bert", *r) for r in reqs]
    outs = [f.result(600.0) for f in futs]
    wall = time.perf_counter() - t0
    launches = registry.launches()
    snap = telemetry.snapshot()
    srv.close(120.0)
    bert.hybridize(False)        # the references below run eagerly
    batches = snap["serve.batches"]["value"]
    n_flash = launches["flash_attention"]
    check(n_flash == 12 * batches,
          f"flash_attention launches {n_flash} != 12 x {batches} batches")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"other kernels launched while serving BERT: {launches}")

    # every answer against a one-request forward on the card
    worst, units = 0.0, bert.pooler.weight.shape[0]
    for (tok, seg, vl), (seq, pooled) in zip(reqs, outs):
        t = int(vl)
        check(seq.shape == (t, units) and pooled.shape == (units,),
              f"answer shapes {seq.shape}, {pooled.shape} for T={t}")
        with torch.inference_mode():
            ref_seq, ref_pooled = bert(tok[None], seg[None], np.asarray([t]))
        for got, want in ((seq, ref_seq[0]), (pooled, ref_pooled[0])):
            want = want.cpu().numpy()
            err = float(np.abs(got - want).max())
            bar = 1e-4 * float(np.abs(want).max())
            check(np.isfinite(got).all() and err <= bar,
                  f"served answer off by {err:.3e} > {bar:.3e} (T={t})")
            worst = max(worst, err / max(float(np.abs(want).max()), 1e-30))

    # one padded batch on the card vs the port's plain path on the CPU
    batch, _, _ = entry.pad_requests(reqs[:3])
    cpu_bert = bert_12_768_12(dropout=0.0, device="cpu", **BERT_BASE)
    cpu_bert.load_state_dict({k: v.cpu() for k, v in bert.state_dict().items()})
    with torch.inference_mode():
        gpu_out = [x.cpu().numpy() for x in bert(*batch)]
        cpu_out = [x.numpy() for x in cpu_bert(*batch)]
    del cpu_bert
    cpu_err = 0.0
    for g_, c_ in zip(gpu_out, cpu_out):
        delta = float(np.abs(g_ - c_).max())
        scale = float(np.abs(c_).max())
        check(delta <= 1e-3 * scale,
              f"padded batch {batch[0].shape}: card vs CPU {delta:.3e} > "
              f"1e-3 x {scale:.3e}")
        cpu_err = max(cpu_err, delta / scale)

    e2e = snap["serve.e2e_seconds"]
    occupancy = snap["serve.rows"]["value"] / snap["serve.padded_rows"]["value"]
    print(f"  launches {launches} for {batches} batches (12 layers each); "
          f"warmup {entry.warmed} shapes in {warm:.2f} s")
    print(f"  answers vs one-request forwards: max err {worst:.3e} x max|ref|"
          f" (bar 1e-4); padded batch {batch[0].shape} card vs CPU "
          f"{cpu_err:.3e} x max|cpu| (bar 1e-3)")
    print(f"phase 7 serve BERT-base: {BERT_REQUESTS} requests in {wall:.3f} s"
          f" = {BERT_REQUESTS / wall:.1f} requests/s, e2e p50 "
          f"{e2e['p50'] * 1e3:.2f} ms, p99 {e2e['p99'] * 1e3:.2f} ms, "
          f"{batches} batches, mean batch occupancy {occupancy:.4f} "
          f"[{card}]")
    return dict(requests_per_s=BERT_REQUESTS / wall,
                e2e_p50_ms=e2e["p50"] * 1e3, e2e_p99_ms=e2e["p99"] * 1e3,
                batches=batches, occupancy=occupancy, launches=n_flash,
                answer_rel_err=worst, cpu_rel_err=cpu_err,
                warm_s=warm, warm_shapes=entry.warmed)


# ------------------------------------------------- flash backward kernels
def bwd_case(t, d, lens, seed, device):
    """q/k/v/g (B=4, H=12, T, d) for the backward check.  NaN garbage in
    k/v past each row's length (the kernels must never read it), and in
    q/g of a 0-length row (every position of it is past its length; in
    a row with live keys, NaN queries would reach dk/dv by the formula
    itself, since the queries past a row's length attend its keys).
    Returns the kernel's inputs and the plain version's (the garbage
    zeroed: the plain version multiplies a masked entry by 0)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, go = (torch.rand(FLASH_B, H, t, d, generator=g) - 0.5
                   for _ in range(4))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    past = (torch.arange(t)[None, :] >= lens_t[:, None])[:, None, :, None]
    empty = (lens_t == 0)[:, None, None, None]
    k = k.masked_fill(past, float("nan"))
    v = v.masked_fill(past, float("nan"))
    q = q.masked_fill(empty, float("nan"))
    go = go.masked_fill(empty, float("nan"))
    move = (lambda x: [x_.to(device) for x_ in x])
    kern = move((q, k, v, go, lens_t))
    plain = move([torch.nan_to_num(x) for x in (q, k, v, go)] + [lens_t])
    return kern, plain


def phase_bwd_kernels(dev):
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att

    worst, n = {"dq": 0.0, "dkv": 0.0}, 0
    for d in BWD_D:
        for t in FLASH_T:
            errs = []
            for causal in (False, True):
                for part, lens in enumerate(([0, 1, 63, 64],
                                             [65, t, t, 1])):
                    lens = [min(x, t) for x in lens]
                    (q, k, v, g, lt), (pq, pk, pv, pg, _) = bwd_case(
                        t, d, lens, seed=d * 1000 + t * 2 + part + 7,
                        device=dev)
                    out, lse = att.flash_attention(
                        q, k, v, causal=causal, kv_valid_length=lt,
                        return_lse=True)
                    got = fb.flash_attention_bwd(q, k, v, g, out, lse, lt,
                                                 causal)
                    torch.cuda.synchronize()
                    ref = fb.flash_attention_bwd_reference(
                        pq, pk, pv, pg, out, lse, lt, causal)
                    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                        check(bool(torch.isfinite(a).all()),
                              f"bwd {name} d={d} T={t} causal={causal} "
                              f"lens={lens}: non-finite")
                        diff = (a - b).abs()
                        check(bool((diff <= TOL + TOL * b.abs()).all()),
                              f"bwd {name} d={d} T={t} causal={causal} "
                              f"lens={lens}: max err {diff.max().item():.3e}"
                              f" over atol=rtol={TOL}")
                        key = "dq" if name == "dq" else "dkv"
                        worst[key] = max(worst[key], diff.max().item())
                        errs.append(diff.max().item())
                    dq, dk, dv = got
                    for r, ln in enumerate(lens):
                        check(bool((dk[r, :, ln:] == 0).all()
                                   and (dv[r, :, ln:] == 0).all()),
                              f"bwd d={d} T={t}: dk/dv not exactly 0 past "
                              f"length {ln}")
                        if ln == 0:
                            check(bool((dq[r] == 0).all()),
                                  f"bwd d={d} T={t}: dq of a 0-length row "
                                  "not exactly 0")
                    n += 1
            print(f"  flash bwd d={d:3d} T={t:3d}: 4 cases (causal off/on x"
                  f" 2 length sets), max abs err {max(errs):.3e}, "
                  f"max |dv| {got[2].abs().max().item():.3e}")
    print(f"phase 8 flash backward kernels vs plain: {n} cases within "
          f"atol=rtol={TOL}, exact zeros past every length (TF32 off)")
    return worst


def bwd_bound(b, t, d, lens, kernel):
    """Least time (ms) for one backward kernel on these inputs, two ways.
    Bytes: q and g (and lse; out for dq, which computes delta; delta for
    dk/dv) read in full, k and v over each row's valid keys, the outputs
    (dq and delta, or dk and dv) written once, over the HBM rate.  Flops:
    per attended (query, key) pair dq does 6 d (s, dp, dq) and dk/dv 8 d
    (s, dp, dk, dv).  ``f32`` is the CUDA-core bound, max(bytes, flops /
    67e12); ``tf32x3`` the bound of the split the kernels run,
    max(bytes, 3 flops / 495e12): three TF32 tensor-core products per f32
    product.  Returns both as ``(ms, by)`` pairs, and bytes and flops."""
    keys = sum(min(x, t) for x in lens) * H        # valid key rows
    rows = b * H * t                                # query rows
    reads = 2 * rows * d * 4 + 2 * rows * 4 + 2 * keys * d * 4 + b * 4
    if kernel == "dq":
        reads += rows * d * 4                       # out
        writes = rows * d * 4 + rows * 4            # dq, delta
    else:
        writes = 2 * b * H * t * d * 4              # dk, dv
    flops = (6 if kernel == "dq" else 8) * d * t * keys
    return dict(two_bounds(reads + writes, flops), nbytes=reads + writes,
                flops=flops)


def time_bwd(b, t, lens, dev, label):
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att

    g = torch.Generator(device="cpu").manual_seed(13)
    one = 5 * b * H * t * D * 4
    nbuf = max(1, math.ceil(200e6 / one))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :]
            < lens_t[:, None])[:, None, None, :]
    scale = 1.0 / math.sqrt(D)
    bufs = []
    for _ in range(nbuf):
        q, k, v, go = ((torch.rand(b, H, t, D, generator=g) - 0.5).to(dev)
                       for _ in range(4))
        out, lse = att.flash_attention(q, k, v, kv_valid_length=lens_t,
                                       return_lse=True)
        _, delta = fb.launch_dq(q, k, v, go, out, lse, lens_t, False, scale)
        bufs.append((q, k, v, go, out, lse, delta))
    dq_ms = cuda_time_ms(lambda i: fb.launch_dq(
        *bufs[i][:6], lens_t, False, scale), nbuf)
    dkv_ms = cuda_time_ms(lambda i: fb.launch_dkv(
        *bufs[i][:4], bufs[i][5], bufs[i][6], lens_t, False, scale), nbuf)
    plain = cuda_time_ms(lambda i: fb.flash_attention_bwd_reference(
        *bufs[i][:6], lens_t, False, scale), nbuf)
    graphs = []
    for q, k, v, go, *_ in bufs:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        graphs.append((leaves, F.scaled_dot_product_attention(
            *leaves, attn_mask=mask), go))
    # the whole backward (delta, dq, dk/dv: wrapper and two launches)
    # beside SDPA's, in turns
    whole, lib = [], []
    for _ in range(2):
        whole.append(cuda_time_ms(lambda i: fb.flash_attention_bwd(
            *bufs[i][:6], lens_t, False, scale), nbuf))
        lib.append(cuda_time_ms(lambda i: torch.autograd.grad(
            graphs[i][1], graphs[i][0], graphs[i][2], retain_graph=True),
            nbuf))
    whole_ms, lib_ms = statistics.median(whole), statistics.median(lib)
    # device time alone (torch.profiler kernel records, summed per call):
    # CUDA events around back-to-back calls also count host time when a
    # call's host work outlasts its kernels, as autograd.grad's can
    whole_dev = device_ms_per_call(lambda i: fb.flash_attention_bwd(
        *bufs[i][:6], lens_t, False, scale), nbuf)
    lib_dev = device_ms_per_call(lambda i: torch.autograd.grad(
        graphs[i][1], graphs[i][0], graphs[i][2], retain_graph=True), nbuf)
    rows = {}
    for kernel, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
        bd = bwd_bound(b, t, D, lens, kernel)
        (bnd, by), (f32_bnd, f32_by) = bd["tf32x3"], bd["f32"]
        # library_ms is SDPA backward's device time: its CUDA events also
        # count autograd's host time, which the kernel's events do not
        rows[kernel] = dict(shape=dict(B=b, H=H, T=t, d=D, kv_len=lens),
                            ms=ms, plain_ms=plain, library_ms=lib_dev,
                            bound_ms=bnd, bound_by=by,
                            bound_f32_ms=f32_bnd, bound_f32_by=f32_by,
                            whole_bwd_ms=whole_ms,
                            whole_bwd_device_ms=whole_dev,
                            library_events_ms=lib_ms)
        print(f"  time {label} {kernel}: B={b} H={H} T={t} d={D} kv_len "
              f"{min(lens)}..{max(lens)} kernel {ms:.4f} ms; plain (dq, dk,"
              f" dv together) {plain:.4f} ms; bound 3xTF32 max("
              f"{bd['nbytes']} B / 3.35e12 B/s, 3 x {bd['flops']} flop / "
              f"495e12 flop/s) = {bnd:.4f} ms ({by}), f32 CUDA cores "
              f"{f32_bnd:.4f} ms ({f32_by}); {nbuf} input copies")
    print(f"  time {label} whole flash_attention_bwd (delta, dq, dk/dv): "
          f"{' / '.join(f'{x:.4f}' for x in whole)} ms, median "
          f"{whole_ms:.4f}; SDPA backward (all three, its own delta) "
          f"{' / '.join(f'{x:.4f}' for x in lib)} ms, median {lib_ms:.4f}"
          f" (ratio {whole_ms / lib_ms:.3f}); device time alone "
          f"(profiler): {whole_dev:.4f} ms against {lib_dev:.4f} ms "
          f"(ratio {whole_dev / lib_dev:.3f})")
    return rows


def phase_bwd_times(dev):
    rs = np.random.RandomState(9)
    train_lens = rs.randint(64, 129, size=32).tolist()
    train_lens[0] = 128
    long_lens = rs.randint(16, 513, size=16).tolist()
    long_lens[0] = 512
    rows = dict(train=time_bwd(32, 128, train_lens, dev, "bwd B=32 T=128"),
                long=time_bwd(16, 512, long_lens, dev, "bwd B=16 T=512"))
    print("phase 9 flash backward times: done")
    return rows


# ------------------------------------------------------ the arena update
ARENA_VARIANTS = (("sgd", {}), ("momentum", dict(momentum=0.9)),
                  ("nesterov", dict(momentum=0.9, nesterov=True)),
                  ("adam", dict(beta1=0.9, beta2=0.999, eps=1e-8)))


def pretrain_shapes():
    """Parameter shapes of BERTForPretrain(bert_12_768_12), from the
    module built on the CPU with its parameters left unset."""
    from mxnet_tpu_torch.gluon.model_zoo import BERTForPretrain, \
        bert_12_768_12

    net = BERTForPretrain(bert_12_768_12(device="cpu", **BERT_BASE))
    return [tuple(p.shape) for p in net.parameters()]


def arena_inputs(lay, n_state, seed, dev):
    """A gradient arena and state arenas: seeded values over the layout's
    total, zeros in the padding (as the trainer keeps them)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i in range(1 + n_state):
        a = torch.zeros(lay.padded, device=dev)
        a[:lay.total] = torch.rand(lay.total, generator=g, device=dev) \
            * (1.0 if i == 0 else 0.1) - (0.5 if i == 0 else 0.0)
        out.append(a)
    return out[0], out[1:]


def phase_arena(dev):
    from mxnet_tpu_torch.kernels import opt_arena as oa

    layouts = dict(small=oa.build_layout([(37,), (5, 3), (949,)]),
                   bert=oa.build_layout(pretrain_shapes()))
    worst = 0.0
    for label, lay in layouts.items():
        for name, kw in ARENA_VARIANTS:
            variant = "momentum" if name == "nesterov" else name
            for t in (1, 7):
                g, st = arena_inputs(lay, oa.VARIANT_STATES[variant],
                                     seed=t + len(name), dev=dev)
                st_ref = [s.clone() for s in st]
                d, st = oa.arena_update(variant, g, st, 1e-3, t, **kw)
                torch.cuda.synchronize()
                d_ref, st_ref = oa.arena_update_reference(
                    variant, g, st_ref, 1e-3, t, **kw)
                for a, b in [(d, d_ref)] + list(zip(st, st_ref)):
                    diff = (a - b).abs()
                    check(bool((diff <= 1e-6 * b.abs()).all()),
                          f"arena {name} t={t} {label}: max rel err "
                          f"{(diff / b.abs().clamp_min(1e-30)).max():.3e}")
                    worst = max(worst, diff.max().item())
                    check(not a[lay.total:].any(),
                          f"arena {name} t={t} {label}: padding not inert")
        print(f"  arena {label}: {lay.total} elements padded to "
              f"{lay.padded}, sgd/momentum/nesterov/adam at t=1, 7 within "
              f"1e-6 relative")
    lay = layouts["bert"]
    g, (m, v) = arena_inputs(lay, 2, seed=3, dev=dev)
    kw = dict(ARENA_VARIANTS[3][1])
    ms = cuda_time_ms(lambda i: oa.arena_update("adam", g, [m, v], 1e-4, 7,
                                                **kw), 1)
    plain = cuda_time_ms(lambda i: oa.arena_update_reference(
        "adam", g, [m, v], 1e-4, 7, **kw), 1)
    lib = None
    if hasattr(torch, "_fused_adam_"):
        p = torch.zeros_like(g)
        step = torch.tensor(7.0, device=dev)
        lib = cuda_time_ms(lambda i: torch._fused_adam_(
            [p], [g], [m], [v], [], [step], lr=1e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), 1)
    nbytes = 6 * lay.padded * 4        # g, m, v read; m, v, delta written
    flops = 13 * lay.padded
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bnd = max(t_bytes, t_ops)
    print(f"  time arena adam: {lay.padded} elements, kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, torch._fused_adam_ "
          f"{'n/a' if lib is None else f'{lib:.4f} ms'}; bound max({nbytes} "
          f"B / 3.35e12 B/s, {flops} flop / 67e12 flop/s) = {bnd:.4f} ms "
          f"({by})")
    print(f"phase 10 arena kernel vs plain: max abs err {worst:.3e}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bnd, bound_by=by,
                shape=dict(elements=lay.padded, variant="adam"))


# ------------------------------------------------ BERT-base pretraining
PRETRAIN = dict(batch=32, seq=128, masked=20)
# the 512-token phase (phases 24-25): 76 masked a row, ~15% of 512
PRETRAIN_512 = dict(batch=8, seq=512, masked=76, steps=3)


def pretrain_batch(b, t, n_pred, seed):
    """The bench's pretraining batch: tokens, token types (a second
    segment from mid-row), valid lengths 64..t, ``n_pred`` distinct
    masked positions inside each row's length, MLM labels and NSP
    labels half 1."""
    rs = np.random.RandomState(seed)
    vocab = BERT_BASE["vocab_size"]
    lens = rs.randint(min(64, t), t + 1, size=b).astype(np.int32)
    lens[0] = t
    tokens = rs.randint(0, vocab, size=(b, t)).astype(np.int32)
    types = np.zeros((b, t), np.int32)
    for i, n in enumerate(lens):
        types[i, n // 2:n] = 1
    pos = np.stack([rs.choice(n, n_pred, replace=False)
                    for n in lens]).astype(np.int32)
    mlm_y = rs.randint(0, vocab, size=(b, n_pred)).astype(np.int32)
    nsp_y = (np.arange(b) % 2).astype(np.int32)
    return (tokens, types, lens, pos), (mlm_y, nsp_y)


def pretrain_model(dev, **kw):
    from mxnet_tpu_torch.gluon.model_zoo import BERTForPretrain, \
        bert_12_768_12

    return xavier_init(BERTForPretrain(bert_12_768_12(device=dev, **BERT_BASE,
                                                      **kw)), 0)


def timed_steps(tr, x, y, dev, steps):
    """2 warm steps, then ``steps`` timed ones with the launch counts set
    to 0 before them: ``(losses of all steps, step p50 by CUDA events,
    wall seconds of the timed steps, launches, peak device memory)``."""
    from mxnet_tpu_torch.kernels import registry

    losses = [tr.step(x, y) for _ in range(2)]
    tr.drain()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        starts[i].record()
        losses.append(tr.step(x, y))
        ends[i].record()
    tr.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    p50 = statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))
    return losses, p50, wall, launches, torch.cuda.max_memory_allocated(dev)


def phase_train(dev, card):
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    mxrandom.seed(0)
    t0 = time.perf_counter()
    net = pretrain_model(dev, dropout=0.1)
    tr = ShardedTrainer(net, pretrain_loss, optimizer="adam",
                        learning_rate=1e-4, weight_decay=0.01)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"  BERTForPretrain(bert_12_768_12) on {dev}: {n_params} "
          f"parameters, arena {tr.layout.padded} elements, built in "
          f"{time.perf_counter() - t0:.2f} s")
    x, y = pretrain_batch(PRETRAIN["batch"], PRETRAIN["seq"],
                          PRETRAIN["masked"], seed=21)
    steps = 20
    losses, p50, wall, launches, peak = timed_steps(tr, x, y, dev, steps)
    layers = 12
    for name, per_step in (("flash_attention", layers),
                           ("flash_attention_bwd_dq", layers),
                           ("flash_attention_bwd_dkv", layers),
                           ("opt_arena", 1)):
        check(launches[name] == per_step * steps,
              f"{name}: {launches[name]} launches in {steps} steps, want "
              f"{per_step} per step")
    check(all(v == 0 for k, v in launches.items() if "decode" in k),
          f"decode kernels launched while training: {launches}")
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"loss did not fall: {vals[0]} -> {vals[-1]}")
    check(tr.uses_arena, "the trainer did not pick the arena adapter")
    sps = PRETRAIN["batch"] * steps / wall
    print(f"  launches over {steps} steps: {launches}")
    print(f"  loss {vals[0]:.4f} (step 1) -> {vals[2]:.4f} (step 3) -> "
          f"{vals[-1]:.4f} (step {len(vals)})")
    print(f"phase 11 train BERT-base (B=32, T=128, 20 masked, adam, TF32 "
          f"off): {sps:.2f} samples/s, step p50 {p50:.3f} ms (device, CUDA "
          f"events), wall {wall * 1e3 / steps:.3f} ms per step, peak "
          f"{peak / 2**30:.2f} GiB [{card}]")
    del tr, net
    return dict(samples_per_s=sps, step_p50_ms=p50,
                wall_ms_per_step=wall * 1e3 / steps, steps=steps,
                launches={k: v for k, v in launches.items() if v},
                loss_first=vals[0], loss_last=vals[-1], peak_bytes=peak)


def check_step(gl, gg, cl, cg):
    """One step's loss within 1e-4 relative and every gradient within
    1e-4 x max|g| of the CPU's: ``(loss rel err, worst name, worst
    gradient err / max|g|)``."""
    rel = abs(gl - cl) / abs(cl)
    check(rel <= 1e-4, f"step-1 loss card {gl} vs CPU {cl}: rel {rel:.3e}")
    worst_name, worst = "", 0.0
    for name, c in cg.items():
        scale = c.abs().max().item()
        err = (gg[name] - c).abs().max().item()
        check(err <= 1e-4 * scale,
              f"grad {name}: card vs CPU {err:.3e} > 1e-4 x {scale:.3e}")
        if scale > 0 and err / scale > worst:
            worst_name, worst = name, err / scale
    return rel, worst_name, worst


def phase_train_cpu(dev):
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    x, y = pretrain_batch(4, 128, PRETRAIN["masked"], seed=22)
    out = {}
    for where in (dev, "cpu"):
        net = pretrain_model(where, dropout=0.0, num_layers=2)
        tr = ShardedTrainer(net, pretrain_loss, optimizer="adam",
                            learning_rate=1e-4, weight_decay=0.0)
        loss = tr.step(x, y, block=True)
        out[str(where)] = (loss, {n: p.grad.detach().cpu().clone()
                                  for n, p in zip(tr.train_names,
                                                  tr.params)})
        del tr, net
    (gl, gg), (cl, cg) = out[str(dev)], out["cpu"]
    rel, worst_name, worst = check_step(gl, gg, cl, cg)
    print(f"phase 12 card vs CPU (2 layers, full width, B=4, T=128): loss "
          f"{gl:.6f} vs {cl:.6f} (rel {rel:.3e}); worst gradient "
          f"{worst:.3e} x max|g| ({worst_name}) over {len(cg)} tensors")
    return dict(loss_rel_err=rel, grad_rel_err=worst)


# ------------------------------------------------ batch norm + relu
RESNET50_BN = ((128 * 112 * 112, 64), (128 * 56 * 56, 64),
               (128 * 28 * 28, 128), (128 * 14 * 14, 256),
               (128 * 7 * 7, 512))       # (rows, C) of its BatchNormReLUs
BN_SMALL = tuple((r, c) for r in (1, 9, 4097) for c in (3, 8, 64, 2048)) + \
    ((1000003, 64),)
STAT_TOL = 1e-5
FOLD_TOL = 1e-6       # scale and shift, relative to their terms
BN_EPS = 1e-5


def bn_case(rows, c, seed, dev):
    """x (rows, C) uniform in [-1, 1) with channel 0 constant (0.1) and
    the last channel's mean moved to 3 (when C > 1), gamma, beta."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(rows, c, generator=g, device=dev) * 2 - 1
    if c > 1:
        x[:, 0] = 0.1
        x[:, -1] += 3.0
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    beta = torch.rand(c, generator=g, device=dev) - 0.5
    return x, gamma, beta


def stat_errors(mean, var, ref_mean, ref_var, ms):
    """Errors of mean and var in units of the channel's scale
    (sqrt(E[x^2]) and E[x^2]; the phase 13 note)."""
    scale = ms.clamp_min(1e-30)
    em = ((mean.double() - ref_mean).abs() / scale.sqrt()).max().item()
    ev = ((var.double() - ref_var).abs() / scale).max().item()
    return em, ev


def fold_errors(scale, shift, mean, beta, want_scale, want_shift):
    """Errors of the fold relative to its terms: scale against |scale|,
    shift = beta - mean * gamma * inv against the larger of |beta| and
    |mean * gamma * inv| (a difference cancels; its rounding is of its
    terms' size)."""
    es = (scale - want_scale).abs() / want_scale.abs().clamp_min(1e-30)
    big = torch.maximum(beta.abs(), (mean * want_scale).abs())
    eh = (shift - want_shift).abs() / big.clamp_min(1e-30)
    return es.max().item(), eh.max().item()


def phase_bn_kernels(dev):
    from mxnet_tpu_torch.kernels import bn_act as kbn

    worst = {"bn_act_stats": 0.0, "bn_act_apply": 0.0}
    worst_rel = worst_fold = 0.0
    cases = [(r, c, "relu") for r, c in RESNET50_BN] + \
        [(r, c, act) for r, c in BN_SMALL for act in ("relu", "identity")]
    for i, (rows, c, act) in enumerate(cases):
        x, gamma, beta = bn_case(rows, c, seed=i + 1, dev=dev)
        got = kbn.bn_stats(x, gamma, beta, BN_EPS)
        mean, var, scale, shift = got
        y = kbn.bn_apply(x, scale, shift, act)
        torch.cuda.synchronize()
        again = kbn.bn_stats(x, gamma, beta, BN_EPS)
        y2 = kbn.bn_apply(x, again[2], again[3], act)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again))
              and torch.equal(y, y2),
              f"bn_act rows={rows} C={c}: two runs differ")
        x64 = x.double()
        ms = (x64 * x64).mean(0)
        ref_mean = x64.mean(0)
        ref_var = (x64 - ref_mean).square().mean(0)
        p_mean, p_var, p_scale, p_shift = kbn.bn_stats_plain(
            x, gamma, beta, BN_EPS)
        for what, (rm, rv) in (("float64", (ref_mean, ref_var)),
                               ("plain", (p_mean.double(), p_var.double()))):
            em, ev = stat_errors(mean, var, rm, rv, ms)
            check(em <= STAT_TOL and ev <= STAT_TOL,
                  f"bn_act_stats rows={rows} C={c} vs {what}: mean err "
                  f"{em:.3e}, var err {ev:.3e} x scale > {STAT_TOL}")
            worst_rel = max(worst_rel, em, ev)
        es, eh = fold_errors(scale, shift, p_mean, beta, p_scale, p_shift)
        check(es <= FOLD_TOL and eh <= FOLD_TOL,
              f"bn_act_stats rows={rows} C={c}: fold vs plain, scale "
              f"{es:.3e}, shift {eh:.3e} relative > {FOLD_TOL}")
        worst_fold = max(worst_fold, es, eh)
        check(c < 2 or float(var[0]) < 1e-6,
              f"constant channel var {float(var[0])}")
        err_s = max((a - b).abs().max().item() for a, b in
                    zip(got, (p_mean, p_var, p_scale, p_shift)))
        ref_y = kbn.bn_apply_plain(x, scale, shift, act)
        diff = (y - ref_y).abs()
        check(bool(torch.isfinite(y).all())
              and bool((diff <= TOL + TOL * ref_y.abs()).all()),
              f"bn_act_apply rows={rows} C={c} {act}: max err "
              f"{diff.max().item():.3e} over atol=rtol={TOL}")
        worst["bn_act_stats"] = max(worst["bn_act_stats"], err_s)
        worst["bn_act_apply"] = max(worst["bn_act_apply"],
                                    diff.max().item())
        if rows >= 4097 or i < len(RESNET50_BN):
            print(f"  bn_act rows={rows:8d} C={c:4d} {act:8s}: stats and "
                  f"fold vs plain {err_s:.3e} (fold relative {es:.2e} / "
                  f"{eh:.2e}), apply vs plain {diff.max().item():.3e}")
        del x, x64, y, y2, ref_y
    print(f"phase 13 bn_act kernels: {len(cases)} cases; mean and var "
          f"within {STAT_TOL} x scale of float64 and plain (worst "
          f"{worst_rel:.3e}), scale and shift within {FOLD_TOL} relative "
          f"of plain (worst {worst_fold:.3e}), y within atol=rtol={TOL}, "
          "same bits twice")
    return worst


def bn_bound(rows, c, kernel):
    """Least time (ms): stats reads x, gamma, beta and writes mean, var,
    scale, shift (3 flops an element); apply reads x, scale, shift and
    writes y (3 flops an element); over the HBM rate or the f32 peak,
    whichever is larger."""
    if kernel == "stats":
        nbytes = rows * c * 4 + 6 * c * 4
    else:
        nbytes = 2 * rows * c * 4 + 2 * c * 4
    flops = 3 * rows * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, flops


def time_bn(rows, c, dev, label):
    from mxnet_tpu_torch.kernels import bn_act as kbn

    nbuf = max(1, math.ceil(200e6 / (rows * c * 4)))
    bufs = [bn_case(rows, c, seed=100 + i, dev=dev)[0] for i in range(nbuf)]
    _, gamma, beta = bn_case(1, c, seed=99, dev=dev)
    _, _, scale, shift = kbn.bn_stats(bufs[0], gamma, beta, BN_EPS)
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    out = {}
    out["stats"] = cuda_time_ms(
        lambda i: kbn.bn_stats(bufs[i], gamma, beta, BN_EPS), nbuf)
    out["apply"] = cuda_time_ms(
        lambda i: kbn.bn_apply(bufs[i], scale, shift, "relu"), nbuf)
    out["stats_plain"] = cuda_time_ms(
        lambda i: kbn.bn_stats_plain(bufs[i], gamma, beta, BN_EPS), nbuf)
    out["apply_plain"] = cuda_time_ms(
        lambda i: kbn.bn_apply_plain(bufs[i], scale, shift, "relu"), nbuf)
    out["var_mean"] = cuda_time_ms(
        lambda i: torch.var_mean(bufs[i], 0, unbiased=False), nbuf)
    out["batch_norm"] = cuda_time_ms(lambda i: F.batch_norm(
        bufs[i], rm, rv, gamma, beta, training=True, momentum=0.1,
        eps=1e-5).relu_(), nbuf)
    rows_out = {}
    for kernel, lib in (("stats", out["var_mean"]),
                        ("apply", out["batch_norm"])):
        bnd, by, nbytes, flops = bn_bound(rows, c, kernel)
        rows_out[kernel] = dict(
            shape=dict(rows=rows, C=c), ms=out[kernel],
            plain_ms=out[f"{kernel}_plain"], library_ms=lib, bound_ms=bnd,
            bound_by=by)
        print(f"  time {label} {kernel}: rows={rows} C={c} kernel "
              f"{out[kernel]:.4f} ms, plain {out[kernel + '_plain']:.4f} ms, "
              f"library {lib:.4f} ms; bound max({nbytes} B / 3.35e12 B/s, "
              f"{flops} flop / 67e12 flop/s) = {bnd:.4f} ms ({by}); {nbuf} "
              "input copies")
    print(f"    (library: torch.var_mean for stats; F.batch_norm(training="
          f"True) + relu_ for both passes, two calls, {out['batch_norm']:.4f}"
          f" ms, beside stats + apply {out['stats'] + out['apply']:.4f} ms)")
    return rows_out


def bn_device_row(rows, c, dev):
    """Device time (``device_ms_per_call``) of ``bn_act_stats``,
    ``bn_act_apply``, ``torch.var_mean`` and ``F.batch_norm(training=True)
    + relu_`` at one shape: CUDA events around a call this short time the
    ~40 us Python wrapper, not the kernel."""
    from mxnet_tpu_torch.kernels import bn_act as kbn

    nbuf = max(1, math.ceil(200e6 / (rows * c * 4)))
    bufs = [bn_case(rows, c, seed=200 + i, dev=dev)[0] for i in range(nbuf)]
    _, gamma, beta = bn_case(1, c, seed=99, dev=dev)
    _, _, scale, shift = kbn.bn_stats(bufs[0], gamma, beta, BN_EPS)
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    out = dict(
        stats=device_ms_per_call(
            lambda i: kbn.bn_stats(bufs[i], gamma, beta, BN_EPS), nbuf),
        apply=device_ms_per_call(
            lambda i: kbn.bn_apply(bufs[i], scale, shift, "relu"), nbuf),
        var_mean=device_ms_per_call(
            lambda i: torch.var_mean(bufs[i], 0, unbiased=False), nbuf),
        batch_norm=device_ms_per_call(lambda i: F.batch_norm(
            bufs[i], rm, rv, gamma, beta, training=True, momentum=0.1,
            eps=1e-5).relu_(), nbuf))
    for kernel in ("stats", "apply"):
        out[f"{kernel}_bound_ms"] = bn_bound(rows, c, kernel)[0]
    print(f"  device time bn_act rows={rows} C={c}: stats {out['stats']:.4f}"
          f" ms (bound {out['stats_bound_ms']:.4f}), torch.var_mean "
          f"{out['var_mean']:.4f} ms; apply {out['apply']:.4f} ms (bound "
          f"{out['apply_bound_ms']:.4f}), F.batch_norm + relu_ "
          f"{out['batch_norm']:.4f} ms; {nbuf} input copies")
    return dict(shape=dict(rows=rows, C=c), **out)


def phase_bn_times(dev):
    rows = dict(stem=time_bn(*RESNET50_BN[0], dev, "bn_act stem"),
                stage4=time_bn(*RESNET50_BN[4], dev, "bn_act stage 4"))
    rows["device"] = [bn_device_row(r, c, dev) for r, c in RESNET50_BN]
    slower = [r["shape"] for r in rows["device"]
              if r["stats"] > r["var_mean"]]
    print(f"phase 14 bn_act times: done; stats slower than torch.var_mean "
          f"by device time at {slower or 'no shape'}")
    return rows


# ------------------------------------------------- ResNet-50 training
RESNET = dict(batch=128, image=224, classes=1000, steps=60)


def resnet_batch(b, image, classes, seed, dev):
    """``bench_resnet50``'s batch: NHWC f32 images from ``RandomState``
    and random labels, put on ``dev`` once."""
    rs = np.random.RandomState(seed)
    x = rs.rand(b, image, image, 3).astype(np.float32)
    y = rs.randint(0, classes, size=(b,)).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def phase_resnet(dev, card):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer

    t0 = time.perf_counter()
    net = xavier_init(get_model("resnet50_v1", layout="NHWC",
                                fused_bn_relu=True, classes=RESNET["classes"],
                                device=dev), 0)
    tr = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                        learning_rate=0.05, momentum=0.9)
    x, y = resnet_batch(RESNET["batch"], RESNET["image"], RESNET["classes"],
                        seed=0, dev=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"  resnet50_v1 (NHWC, fused BN+relu) on {dev}: {n_params} "
          f"parameters, {len(tr.aux_names)} buffers, arena "
          f"{tr.layout.padded} elements, built in "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [tr.step(x, y) for _ in range(2)]
    tr.drain()
    steps = 20
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    registry.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        starts[i].record()
        losses.append(tr.step(x, y))
        ends[i].record()
    tr.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    # on one fixed batch the loss falls, spikes around steps 14-25 (lr
    # 0.05 with momentum 0.9 overshoots) and then falls steadily: the
    # check reads it at RESNET["steps"], past the spike, untimed
    losses += [tr.step(x, y) for _ in range(RESNET["steps"] - len(losses))]
    for name, per_step in (("bn_act_stats", 33), ("bn_act_apply", 33),
                           ("opt_arena", 1)):
        check(launches[name] == per_step * steps,
              f"{name}: {launches[name]} launches in {steps} steps, want "
              f"{per_step} per step")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("bn_act_stats", "bn_act_apply", "opt_arena")),
          f"other kernels launched while training ResNet-50: {launches}")
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"loss did not fall: {vals[0]} -> {vals[-1]}")
    check(tr.uses_arena, "the trainer did not pick the arena adapter")
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    p50 = statistics.median(step_ms)
    ips = RESNET["batch"] * steps / wall
    print(f"  launches over {steps} timed steps: {launches}")
    print(f"  loss by step: {' '.join(f'{v:.4f}' for v in vals)}")
    print(f"  loss {vals[0]:.4f} (step 1) -> {vals[21]:.4f} (step 22) -> "
          f"{vals[-1]:.4f} (step {len(vals)}); peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"phase 15 train ResNet-50 v1 (B={RESNET['batch']}, "
          f"{RESNET['image']}x{RESNET['image']}, NHWC, fused BN+relu,"
          f" sgd momentum, f32, TF32 off): {ips:.2f} img/s, step p50 "
          f"{p50:.3f} ms (device, CUDA events), wall "
          f"{wall * 1e3 / steps:.3f} ms per step [{card}]")
    del tr, net, x, y
    torch.cuda.empty_cache()
    return dict(img_per_s=ips, step_p50_ms=p50,
                wall_ms_per_step=wall * 1e3 / steps, steps=steps,
                peak_mem_bytes=peak,
                launches={k: v for k, v in launches.items() if v},
                loss_first=vals[0], loss_step22=vals[21],
                loss_last=vals[-1])


def phase_resnet_cpu(dev):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import BottleneckV1, \
        ResNetV1
    from mxnet_tpu_torch.parallel import ShardedTrainer

    out = {}
    for where in (dev, "cpu"):
        net = xavier_init(ResNetV1(
            BottleneckV1, [1, 1, 1, 1], [64, 256, 512, 1024, 2048],
            classes=1000, layout="NHWC", fused_bn_relu=True, device=where), 0)
        x, y = resnet_batch(4, 64, 1000, seed=1, dev=where)
        tr = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                            learning_rate=0.05, momentum=0.9)
        loss = tr.step(x, y, block=True)
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in zip(tr.train_names, tr.params)}
        stats = {n: b.detach().cpu().clone() for n, b in net.named_buffers()}
        out[str(where)] = (loss, grads, stats)
        del tr, net
    (gl, gg, gs), (cl, cg, cs) = out[str(dev)], out["cpu"]
    rel, worst_name, worst = check_step(gl, gg, cl, cg)
    stat_err = 0.0
    for name, c in cs.items():
        diff = (gs[name] - c).abs()
        check(bool((diff <= 1e-5 + 1e-5 * c.abs()).all()),
              f"{name}: card vs CPU {diff.max().item():.3e} over 1e-5")
        stat_err = max(stat_err, diff.max().item())
    print(f"phase 16 card vs CPU (ResNetV1 bottleneck [1,1,1,1] at full "
          f"width, B=4, 64x64): loss {gl:.6f} vs {cl:.6f} (rel {rel:.3e}); "
          f"worst gradient {worst:.3e} x max|g| ({worst_name}) over "
          f"{len(cg)} tensors; running statistics within {stat_err:.3e}")
    return dict(loss_rel_err=rel, grad_rel_err=worst, stat_abs_err=stat_err)


# ------------------------------------------------ extension kernels
EXT_KERNELS = ("ext_sqrelu_fwd", "ext_sqrelu_bwd", "ext_axpb")
EXT_AB = ((1 / 0.3081, -0.1307 / 0.3081), (3.0, 1.0))    # MNIST, 3x + 1
STEM = (128, 112, 112, 64)                                # ResNet-50 stem


def ext_case(shape, dtype, offset, seed, dev):
    """x and g of ``shape`` (N(0, 3^2), rounded to ``dtype``) on ``dev``,
    as views at storage offset ``offset`` (1: not 16-byte aligned)."""
    n = math.prod(shape)
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(2, n + offset, generator=g, device=dev) * 3
    flat = flat.to(dtype)
    return tuple(flat[i, offset:offset + n].view(shape) for i in range(2))


def _bits_equal(a, b):
    return torch.equal(a.float().view(torch.int32), b.float().view(torch.int32))


def phase_ext_kernels(dev):
    from mxnet_tpu_torch.kernels import ext_ops

    worst = dict.fromkeys(EXT_KERNELS, 0.0)
    cases = [((n,), 0) for n in (1, 3, 4, 4097, 1000003)] + \
        [((4097,), 1), ((1000003,), 1), ((0,), 0), ((), 0), (STEM, 0)]
    count = 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for shape, offset in cases:
            x, g = ext_case(shape, dtype, offset, seed=count + 1, dev=dev)
            label = f"{str(dtype)[6:]} {shape} offset {offset}"
            outs = {"ext_sqrelu_fwd": (ext_ops.sqrelu(x),
                                       ext_ops.sqrelu_plain(x)),
                    "ext_sqrelu_bwd": (ext_ops.sqrelu_grad(g, x),
                                       ext_ops.sqrelu_grad_plain(g, x))}
            for a, b in EXT_AB:
                outs[f"ext_axpb {a:.4f} {b:.4f}"] = (
                    ext_ops.axpb(x, a, b), ext_ops.axpb_plain(x, a, b))
            torch.cuda.synchronize()
            for name, (got, want) in outs.items():
                check(got.shape == x.shape and got.dtype == dtype,
                      f"{name} {label}: {got.dtype} {tuple(got.shape)}")
                if name.startswith("ext_axpb") and dtype == torch.float32:
                    ulp = torch.maximum(got.abs(), want.abs()).double()
                    ulp = (torch.nextafter(ulp.float(), torch.tensor(
                        math.inf, device=dev)).double() - ulp)
                    ok = bool(((got.double() - want.double()).abs() <= ulp
                               ).all())
                    bar = "1 ulp"
                else:
                    ok, bar = _bits_equal(got, want), "equal bits"
                err = (got.float() - want.float()).abs().max().item() \
                    if got.numel() else 0.0
                check(ok, f"{name} {label}: over {bar} (max err {err:.3e})")
                key = name.split()[0]
                worst[key] = max(worst[key], err)
            count += 1
            del x, g, outs
    print(f"phase 17 extension kernels vs plain: {count} cases (sizes 1, 3, "
          f"4, 4097, 1000003, offset-1 views, 0 elements, 0-d, the stem "
          f"{STEM}; f32, f16, bf16; axpb at {EXT_AB}): squared ReLU equal "
          "bits, axpb equal bits (f16, bf16) or within 1 ulp (f32); worst "
          f"|kernel - plain| {worst}")
    return worst


def ext_bound(n, kernel):
    """Least time (ms): forward and axpb read x and write y, backward
    reads g and x and writes dx (f32); 2, 3 and 2 flops an element."""
    nbytes = (3 if kernel == "ext_sqrelu_bwd" else 2) * n * 4
    flops = (3 if kernel == "ext_sqrelu_bwd" else 2) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, flops


def phase_ext_times(dev):
    from mxnet_tpu_torch.kernels import ext_ops

    n = math.prod(STEM)
    nbuf = max(1, math.ceil(200e6 / (n * 4)))
    bufs = [ext_case(STEM, torch.float32, 0, seed=200 + i, dev=dev)
            for i in range(nbuf)]
    a, b = EXT_AB[0]
    ta = torch.tensor(a, dtype=torch.float32, device=dev)
    tb = torch.tensor(b, dtype=torch.float32, device=dev)
    runs = {
        "ext_sqrelu_fwd": (
            lambda i: ext_ops.sqrelu(bufs[i][0]),
            lambda i: ext_ops.sqrelu_plain(bufs[i][0]),
            lambda i: torch.relu(bufs[i][0]).square_(),
            "torch.relu + square_, 2 calls"),
        "ext_sqrelu_bwd": (
            lambda i: ext_ops.sqrelu_grad(bufs[i][1], bufs[i][0]),
            lambda i: ext_ops.sqrelu_grad_plain(bufs[i][1], bufs[i][0]),
            lambda i: torch.relu(bufs[i][0]).mul_(bufs[i][1]).mul_(2.0),
            "torch.relu + mul_ + mul_, 3 calls"),
        "ext_axpb": (
            lambda i: ext_ops.axpb(bufs[i][0], a, b),
            lambda i: ext_ops.axpb_plain(bufs[i][0], a, b),
            lambda i: torch.addcmul(tb, bufs[i][0], ta),
            "torch.addcmul over 0-d tensors, 1 call"),
    }
    rows = {}
    for name, (kern, plain, lib, lib_what) in runs.items():
        t = {what: cuda_time_ms(fn, nbuf) for what, fn in
             (("ms", kern), ("plain_ms", plain), ("library_ms", lib))}
        bnd, by, nbytes, flops = ext_bound(n, name)
        rows[name] = dict(shape=dict(elements=n, as_=list(STEM),
                                     dtype="float32"),
                          bound_ms=bnd, bound_by=by, library=lib_what, **t)
        print(f"  time {name}: {n} f32 kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
              f"({lib_what}); bound max({nbytes} B / 3.35e12 B/s, {flops} "
              f"flop / 67e12 flop/s) = {bnd:.4f} ms ({by}); {nbuf} input "
              "copies")
    print("phase 18 extension kernel times: done")
    return rows


# ---------------------------------------- the eager Gluon path (LeNet-5)
LENET = dict(batch=64, steps=120, train=8192, held_out=1024)


def mnist_arrays(train, num=None):
    """The port's ``MNIST`` (the JAX package's synthetic set where no
    files are present) through ``transforms.ToTensor``: NCHW f32 in
    [0, 1] and int32 labels, the first ``num`` items (all by default)."""
    from mxnet_tpu_torch.gluon.data.vision import MNIST, transforms

    ds = MNIST(train=train)
    to_tensor = transforms.ToTensor()
    n = len(ds) if num is None else num
    items = [ds[i] for i in range(n)]
    return (np.stack([to_tensor(x) for x, _ in items]),
            np.array([y for _, y in items], dtype=np.int32))


def ext_lenet(device):
    """LeNet-5's layers at their widths, the input normalized by
    ``npx.pallas_axpb`` and the 500-unit hidden layer's activation
    ``npx.pallas_squared_relu`` (the extension ops) in place of tanh."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import HybridBlock, nn

    class ExtLeNet(HybridBlock):
        def __init__(self):
            super().__init__()
            kw = dict(device=device)
            self.features = nn.HybridSequential().add(
                nn.Conv2D(20, 5, activation="tanh", in_channels=1, **kw),
                nn.MaxPool2D(2, 2),
                nn.Conv2D(50, 5, activation="tanh", in_channels=20, **kw),
                nn.MaxPool2D(2, 2), nn.Flatten())
            self.hidden = nn.Dense(500, in_units=800, **kw)
            self.output = nn.Dense(10, in_units=500, **kw)

        def forward(self, x):
            x = mx.npx.pallas_axpb(x, a=EXT_AB[0][0], b=EXT_AB[0][1])
            h = mx.npx.pallas_squared_relu(self.hidden(self.features(x)))
            return self.output(h)

    return ExtLeNet()


def train_eager(net, dev, lr, label):
    """The verify skill's drive: ``autograd.record()`` -> loss ->
    ``autograd.backward`` -> ``gluon.Trainer.step(64)`` over 120 batches
    of the synthetic set (held on the card), then accuracy on 1024
    held-out images.  Launch counts are reset just before the training
    loop and read just after it."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import registry

    b, steps = LENET["batch"], LENET["steps"]
    xs, ys = mnist_arrays(True, LENET["train"])
    xv, yv = mnist_arrays(False, LENET["held_out"])
    xs, ys = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    xv = torch.from_numpy(xv).to(dev)
    net.hybridize()
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0.9})
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    losses = []
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        x, y = xs[i * b:(i + 1) * b], ys[i * b:(i + 1) * b]
        starts[i].record()
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        trainer.step(b)
        ends[i].record()
        losses.append(loss.detach().mean())
    trainer.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    with torch.no_grad():
        acc = float((net(xv).argmax(1).cpu().numpy() == yv).mean())
    vals = [float(v) for v in losses]
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    p50 = statistics.median(step_ms)
    ips = b * steps / wall
    check(all(math.isfinite(v) for v in vals), f"{label}: non-finite loss")
    check(acc > 0.95, f"{label}: held-out accuracy {acc:.4f} <= 0.95")
    print(f"  {label}: loss {vals[0]:.4f} (step 1) -> {vals[-1]:.4f} (step "
          f"{steps}); held-out accuracy {acc:.4f} on {len(yv)} images")
    return dict(img_per_s=ips, step_p50_ms=p50,
                wall_ms_per_step=wall * 1e3 / steps, steps=steps, batch=b,
                lr=lr, accuracy=acc, loss_first=vals[0], loss_last=vals[-1],
                launches={k: v for k, v in launches.items() if v})


def phase_lenet(dev, card):
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    net = xavier_init(get_model("lenet", device=dev), 0)
    out = train_eager(net, dev, 0.05, "lenet")
    check(not out["launches"],
          f"LeNet launched the port's kernels: {out['launches']}")
    print(f"phase 19 canonical drive, LeNet-5 (B={out['batch']}, "
          f"{out['steps']} steps, sgd lr 0.05 momentum 0.9, f32): "
          f"{out['img_per_s']:.1f} img/s, step p50 {out['step_p50_ms']:.3f}"
          f" ms (CUDA events), held-out accuracy {out['accuracy']:.4f} "
          f"[{card}]")
    return out


EXT_LR = 0.01      # lr 0.05 diverges: the squared ReLU is unbounded


def phase_ext_drive(dev, card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    here = Path(__file__).resolve().parent
    ops = mx.library.load(str(here / "example" / "extensions" /
                              "torch_ops.py"))
    check(sorted(ops) == ["pallas_axpb", "pallas_squared_relu"],
          f"torch_ops.py registered {sorted(ops)}")
    out = train_eager(xavier_init(ext_lenet(dev), 0), dev, EXT_LR,
                      "extension block")
    # train_eager hybridizes the block: its first step runs eagerly, the
    # second warms (one real launch of each kernel), captures and replays
    want = {k: out["steps"] + 1 for k in EXT_KERNELS}
    check(out["launches"] == want,
          f"extension drive launches {out['launches']}, want 1 of each "
          f"{EXT_KERNELS} a step, and one in the warm run ({want})")
    # one step on the card and on the CPU from the same seed, on the first
    # held-out batch
    xs, ys = mnist_arrays(False, LENET["batch"])
    res = {}
    for where in (dev, "cpu"):
        net = xavier_init(ext_lenet(where), 0)
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(
                net(torch.from_numpy(xs).to(where)),
                torch.from_numpy(ys).to(where))
        autograd.backward(loss)
        res[str(where)] = (float(loss.detach().mean()), {
            n: p.grad.detach().cpu().clone()
            for n, p in net.collect_params().items()})
    (gl, gg), (cl, cg) = res[str(dev)], res["cpu"]
    rel, worst_name, worst = check_step(gl, gg, cl, cg)
    out.update(loss_rel_err=rel, grad_rel_err=worst)
    print(f"phase 20 extension drive (ExtLeNet, B={out['batch']}, "
          f"{out['steps']} steps, sgd lr {EXT_LR} momentum 0.9): "
          f"{out['img_per_s']:.1f} img/s, step p50 {out['step_p50_ms']:.3f} "
          f"ms, held-out accuracy {out['accuracy']:.4f}; launches "
          f"{out['launches']} ({out['steps']} steps); card vs CPU loss rel "
          f"{rel:.3e}, worst gradient {worst:.3e} x max|g| ({worst_name}) "
          f"[{card}]")
    return out


def phase_resnet_eager(dev, card, sharded):
    """ResNet-50 v1 of phase 15 through ``autograd.record()`` and
    ``gluon.Trainer`` (sgd, lr 0.05, momentum 0.9) from the same seed and
    batch: 5 steps."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.kernels import registry

    net = xavier_init(get_model("resnet50_v1", layout="NHWC",
                                fused_bn_relu=True, classes=RESNET["classes"],
                                device=dev), 0)
    x, y = resnet_batch(RESNET["batch"], RESNET["image"], RESNET["classes"],
                        seed=0, dev=dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    stats0 = net.features[1].running_mean.clone()
    steps = 5
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    losses = []
    torch.cuda.synchronize()
    registry.reset_launches()
    for i in range(steps):
        starts[i].record()
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        trainer.step(RESNET["batch"])
        ends[i].record()
        losses.append(loss.detach().mean())
    trainer.drain()
    torch.cuda.synchronize()
    launches = registry.launches()
    vals = [float(v) for v in losses]
    rel = abs(vals[0] - sharded["loss_first"]) / abs(sharded["loss_first"])
    check(rel <= 1e-4, f"eager step-1 loss {vals[0]} vs ShardedTrainer "
          f"{sharded['loss_first']}: rel {rel:.3e} > 1e-4")
    for name in ("bn_act_stats", "bn_act_apply"):
        check(launches[name] == 33 * steps,
              f"{name}: {launches[name]} launches in {steps} eager steps, "
              "want 33 a step")
    moved = (net.features[1].running_mean - stats0).abs().max().item()
    check(moved > 0, "running statistics did not move under record()")
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    p50 = statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))
    print(f"phase 21 ResNet-50 v1 through autograd.record() + gluon.Trainer "
          f"(B={RESNET['batch']}, {steps} steps): losses "
          f"{' '.join(f'{v:.4f}' for v in vals)}; step-1 loss rel "
          f"{rel:.3e} to ShardedTrainer's; launches a step bn_act_stats "
          f"{launches['bn_act_stats'] // steps}, bn_act_apply "
          f"{launches['bn_act_apply'] // steps}; running mean moved by up to "
          f"{moved:.3e}; step p50 {p50:.3f} ms beside phase 15's "
          f"{sharded['step_p50_ms']:.3f} ms [{card}]")
    del trainer, net, x, y
    torch.cuda.empty_cache()
    return dict(step_p50_ms=p50, steps=steps, loss_first=vals[0],
                loss_rel_err=rel, losses=vals, stat_moved=moved,
                launches={k: v for k, v in launches.items() if v})


# ------------------------------------ 16-bit attention and training
HALF = ((torch.bfloat16, "bf16"), (torch.float16, "f16"))
HALF_FWD_TOL = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}   # x max|ref|
HALF_BWD_TOL = {"bf16": 2.0 ** -6, "f16": 2.0 ** -9}    # x max|g|
HALF_FLOP_PER_S = 989e12     # H100 SXM dense bf16 / f16 on tensor cores
HALF_SHAPES = dict(train=(32, 128, 64), serve=(16, 512, 24))  # B, T, lo
HALF_EDGE_TK = (1, 64, 127, 128, 129, 200, 512)   # either side of Tk = 128
# phase 26's bars, the CPU tests' (tests/test_torch_amp.py): two bf16
# computations of one step differ at bf16's scale, not f32's
HALF_LOSS_RTOL = 2e-2
HALF_GRAD_TOL = 2.0 ** -4     # x max|g| of each tensor
HALF_NOISE_BARS = 3.0         # phase 30: x the CPU's bf16-to-f32 distance


def half_lens(b, t, lo, seed):
    """Per-row key lengths lo..t from a seed, the first t."""
    lens = np.random.RandomState(seed).randint(lo, t + 1, size=b).tolist()
    lens[0] = t
    return lens


def half_case(b, t, d, lens, dt, seed, dev, offset=False, tk=None):
    """16-bit q, g (B, H, T, d) and k, v (B, H, Tk, d; Tk = T unless
    given), NaN in k/v past each row's length, on the card (as views at
    storage offset 1 with ``offset``): the kernels' inputs, the plain
    version's (garbage zeroed) and the lengths."""
    tk = t if tk is None else tk
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = [((torch.rand(b, H, n, d, generator=g) - 0.5) * 2).to(dt)
         for n in (t, tk, tk, t)]
    lens_t = torch.tensor(lens, dtype=torch.int32)
    past = (torch.arange(tk)[None, :] >= lens_t[:, None])[:, None, :, None]
    x[1] = x[1].masked_fill(past, float("nan"))
    x[2] = x[2].masked_fill(past, float("nan"))

    def put(t_):
        if not offset:
            return t_.to(dev)
        flat = torch.empty(t_.numel() + 1, dtype=dt, device=dev)
        flat[1:] = t_.reshape(-1).to(dev)
        return flat[1:].view(t_.shape)

    kern = [put(t_) for t_ in x]
    plain = [kern[0], torch.nan_to_num(kern[1]), torch.nan_to_num(kern[2]),
             kern[3]]
    return kern, plain, lens_t.to(dev)


def half_check(sfx, kern, plain, lt, causal, label):
    """One 16-bit forward and backward against the plain versions:
    output within HALF_FWD_TOL x max|ref|, lse within 1e-4, dq / dk / dv
    within HALF_BWD_TOL x max|g|, exact zeros past each length, the same
    bits on a second call.  Returns the worst absolute errors."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att

    out, lse = att.flash_attention(*kern[:3], causal=causal,
                                   kv_valid_length=lt, return_lse=True)
    got = fb.flash_attention_bwd(*kern, out, lse, lt, causal)
    again = att.flash_attention(*kern[:3], causal=causal, kv_valid_length=lt)
    again_g = fb.flash_attention_bwd(*kern, out, lse, lt, causal)
    torch.cuda.synchronize()
    ref, ref_lse = att.flash_attention_reference(
        *plain[:3], causal=causal, kv_valid_length=lt, return_lse=True)
    want = fb.flash_attention_bwd_reference(*plain, out, lse, lt, causal)
    check(out.dtype == kern[0].dtype and lse.dtype == torch.float32,
          f"{label}: out {out.dtype}, lse {lse.dtype}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    err = dict(fwd=(out.float() - ref.float()).abs().max().item())
    top = ref.float().abs().max().item()
    check(err["fwd"] <= HALF_FWD_TOL[sfx] * top,
          f"{label}: forward err {err['fwd']:.3e} over "
          f"{HALF_FWD_TOL[sfx]:.3e} x {top:.3e}")
    same_inf = torch.isinf(ref_lse) & (lse == ref_lse)
    diff = torch.where(same_inf, torch.zeros_like(lse), (lse - ref_lse).abs())
    check(bool((diff <= TOL + TOL * ref_lse.abs()).all()),
          f"{label}: lse err {diff.max().item():.3e}")
    gmax = kern[3].float().abs().max().item()
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == kern[0].dtype and bool(torch.isfinite(a).all()),
              f"{label}: {name} {a.dtype}, finite {torch.isfinite(a).all()}")
        e = (a.float() - r.float()).abs().max().item()
        # max|g|, or the gradient's own scale where it is larger (a key
        # that 512 queries attend with p ~ 1 sums 512 rows of g)
        top = max(gmax, r.float().abs().max().item())
        check(e <= HALF_BWD_TOL[sfx] * top,
              f"{label}: {name} err {e:.3e} over {HALF_BWD_TOL[sfx]:.3e} x "
              f"{top:.3e}")
        key = "dq" if name == "dq" else "dkv"
        err[key] = max(err.get(key, 0.0), e)
    for r, n in enumerate(lt.tolist()):
        check(not got[1][r, :, n:].any() and not got[2][r, :, n:].any(),
              f"{label}: dk/dv not exactly 0 past length {n}")
        if n == 0:
            check(not got[0][r].any() and not out[r].any(),
                  f"{label}: a 0-length row's out / dq not exactly 0")
    check(bool(torch.equal(out, again))
          and all(torch.equal(a, b) for a, b in zip(got, again_g)),
          f"{label}: two calls differ")
    return err


def half_large_ds(tk, d, dev):
    """Phase 22's f16 case whose |dS| passes 65504, f16's largest value,
    while dq, dk and dv are nonzero and fit in f16, |dS| rising from one
    64-query tile to the next (``test_utils.attention_large_ds_inputs``,
    which the card and CPU tests share).  The backward's gradients finite
    and within phase 22's bar of the plain version's, the same bits
    twice; returns the worst absolute error."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.test_utils import (attention_large_ds_inputs,
                                            attention_p_ds)

    q, k, v, g = (x.half().to(dev)
                  for x in attention_large_ds_inputs(2, H, tk, d))
    lt = torch.tensor([tk, 2], dtype=torch.int32, device=dev)
    out, lse = att.flash_attention(q, k, v, kv_valid_length=lt,
                                   return_lse=True)
    got = fb.flash_attention_bwd(q, k, v, g, out, lse, lt)
    again = fb.flash_attention_bwd(q, k, v, g, out, lse, lt)
    want = fb.flash_attention_bwd_reference(q, k, v, g, out, lse, lt)
    torch.cuda.synchronize()
    ds = attention_p_ds(q, k, v, g, out, lse, lt)[1]
    label = f"f16 |dS| > 65504 Tk={tk} d={d}"
    check(ds.abs().max().item() > 65504, f"{label}: max|dS| "
          f"{ds.abs().max().item():.3e}, not past f16's range")
    gmax = g.float().abs().max().item()
    worst = 0.0
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        e = (a.float() - r.float()).abs().max().item()
        top = r.float().abs().max().item()
        check(bool(torch.isfinite(a).all()) and top > 1000 and
              e <= HALF_BWD_TOL["f16"] * max(gmax, top),
              f"{label}: {name} err {e:.3e}, max|ref| {top:.3e}, finite "
              f"{bool(torch.isfinite(a).all())}")
        worst = max(worst, e)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label}: two calls differ")
    return worst


def half_split_probe(dt, sfx, tk, dev):
    """Phase 22's dq where the split's low term shows: keys 1 + e
    (``test_utils.attention_split_probe_inputs``) make dq one ulp's size
    of dS, so a split that kept only dS's high term errs by a quarter of
    dq or more (measured against the JAX package on the CPU,
    ``tests/test_torch_half_attention.py``).  dq within HALF_BWD_TOL x
    max|dq| of the plain version's; returns the error over max|dq|."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.test_utils import attention_split_probe_inputs

    q, k, v, g = (x.to(dt).to(dev) for x in attention_split_probe_inputs(
        2, H, 96, tk, D, dt, seed=tk))
    lt = torch.tensor([tk, tk - 30], dtype=torch.int32, device=dev)
    out, lse = att.flash_attention(q, k, v, kv_valid_length=lt,
                                   return_lse=True)
    dq = fb.flash_attention_bwd(q, k, v, g, out, lse, lt)[0]
    ref = fb.flash_attention_bwd_reference(q, k, v, g, out, lse, lt)[0]
    top = ref.float().abs().max().item()
    e = (dq.float() - ref.float()).abs().max().item() / top
    check(fb.fused(q, k) == (tk <= 128) and e <= HALF_BWD_TOL[sfx],
          f"{sfx} split probe Tk={tk}: dq err {e:.3e} x max|dq| {top:.3e}")
    return e


def phase_half_kernels(dev):
    """Phase 22: the 16-bit forward, dq and dk/dv against their plain
    versions, bf16 and f16; both sides of the fused mode's edge."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb

    worst = {sfx: dict(fwd=0.0, dq=0.0, dkv=0.0) for _, sfx in HALF}
    n = 0
    for dt, sfx in HALF:
        cases = []
        for shape, (b, t, lo) in HALF_SHAPES.items():
            lens = half_lens(b, t, lo, seed=t)
            for causal in ((False, True) if shape == "train" else (False,)):
                cases.append((f"{shape} d=64", b, t, t, 64, lens, causal,
                              False))
        for d in (36, 128, 320):
            for t in (128, 512):
                for causal in (False, True):
                    cases.append((f"B=4 T={t} d={d}", 4, t, t, d,
                                  [0, 1, 63, t], causal, False))
        for d in (36, 64):
            cases.append((f"unaligned d={d}", 4, 128, 128, d,
                          [0, 1, 63, 128], True, True))
        # the fused mode's edge (Tk <= 128 and d <= 64), Tq != Tk
        for tk in HALF_EDGE_TK:
            for d in (36, 64, 128, 320):
                for causal in (False, True):
                    tq = max(1, tk - 5) if causal else tk + 37
                    cases.append((f"Tq={tq} Tk={tk} d={d}", 3, tq, tk, d,
                                  [0, 1, tk], causal, False))
        for tk in (128, 129):
            for d in (36, 64):
                cases.append((f"unaligned Tq=100 Tk={tk} d={d}", 3, 100, tk,
                              d, [0, 1, tk], True, True))
        # the forward's narrowest widths, Tq off the 64- and 128-row blocks
        for d in (1, 8):
            for tk in (65, 129):
                for causal in (False, True):
                    tq = 100 if causal else 200
                    cases.append((f"Tq={tq} Tk={tk} d={d}", 3, tq, tk, d,
                                  [0, 1, tk], causal, False))
        fused = 0
        for label, b, t, tk, d, lens, causal, offset in cases:
            kern, plain, lt = half_case(b, t, d, lens, dt, seed=b + t + d,
                                        dev=dev, offset=offset, tk=tk)
            err = half_check(sfx, kern, plain, lt, causal,
                             f"{sfx} {label} causal={causal}")
            for k_ in err:
                worst[sfx][k_] = max(worst[sfx][k_], err[k_])
            fused += fb.fused(kern[0], kern[1])
            n += 1
        line = (f"  {sfx}: {len(cases)} cases ({fused} on the fused mode; "
                f"training and serving shapes at d=64, d in 36/128/320 at T "
                f"128/512, Tk in {list(HALF_EDGE_TK)} at d in 36/64/128/"
                f"320 with Tq != Tk, d 1 and 8 at Tk 65/129, causal off/on, "
                "unaligned views)")
        if dt == torch.float16:
            for tk, d in ((128, 64), (200, 64), (128, 320), (200, 320)):
                e = half_large_ds(tk, d, dev)
                for k_ in ("dq", "dkv"):
                    worst[sfx][k_] = max(worst[sfx][k_], e)
                n += 1
            line += " and 4 with |dS| > 65504 (Tk 128/200, d 64/320)"
        probe = max(half_split_probe(dt, sfx, tk, dev) for tk in (128, 192))
        n += 2
        line += (f"; dq on keys 1 + e (Tk 128/192) within {probe:.3e} x "
                 "max|dq|")
        print(f"{line}, worst abs err fwd {worst[sfx]['fwd']:.3e}, dq "
              f"{worst[sfx]['dq']:.3e}, dk/dv {worst[sfx]['dkv']:.3e}")
    print(f"phase 22 16-bit attention kernels vs plain: {n} cases within "
          f"2^-7 / 2^-10 x max|ref| (forward, bf16 / f16) and 2^-6 / 2^-9 "
          f"x max(max|g|, max|ref|) (dq, dk, dv), exact zeros past "
          "lengths, same bits twice")
    return worst


def half_bounds(b, t, d, lens):
    """Least times (ms) of the 16-bit forward, dq, dk/dv and the fused
    backward on these inputs, as ``(ms, by, bytes)``.  Bytes (2 a 16-bit
    value, 4 an f32 one), each input read once and each output written
    once: the forward reads q, lse's rows and k, v over the valid keys
    and writes out; dq reads q, g, out, lse and those keys' k, v and
    writes dq and delta; dk/dv reads q, g, lse, delta and the keys' k, v
    and writes dk, dv; the fused backward (Tk <= 128, d <= 64, one
    launch) reads q, g, out, lse and the keys' k, v and writes dq, dk,
    dv, delta staying in the block.  Operations per attended (query,
    key) pair, all 16-bit MMAs at 989e12 flop/s, as the d <= 64 kernels
    run them: S and dP (the forward: S and P V) exact, 2 d each; each
    product of an f32 operand with a 16-bit one (dS K, dS^T Q, P^T G)
    2 x 2 d, the two terms of its split.  dq does S, dP and dS K (8 d);
    dk/dv S, dP, P^T G, dS^T Q (12 d); the fused backward all five once
    (16 d)."""
    keys = sum(min(x, t) for x in lens) * H
    rows = b * H * t
    pairs = t * keys
    kv = 2 * keys * d * 2
    kv_out = 2 * b * H * t * d * 2
    nbytes = dict(fwd=2 * rows * d * 2 + rows * 4 + kv + b * 4,
                  dq=4 * rows * d * 2 + 2 * rows * 4 + kv + b * 4,
                  dkv=2 * rows * d * 2 + 2 * rows * 4 + kv + kv_out + b * 4,
                  fused=4 * rows * d * 2 + rows * 4 + kv + kv_out + b * 4)
    ops = {k_: n * d * pairs / HALF_FLOP_PER_S
           for k_, n in dict(fwd=4, dq=8, dkv=12, fused=16).items()}
    out = {}
    for k_ in nbytes:
        tb, to = nbytes[k_] / HBM_BYTES_PER_S * 1e3, ops[k_] * 1e3
        out[k_] = (max(tb, to), "bytes" if tb >= to else "operations",
                   nbytes[k_])
    return out


def time_half(dt, sfx, shape, dev):
    """Device times (profiler) of the 16-bit forward and of what
    ``flash_attention_bwd`` launches on this shape's path (the fused
    dk/dv kernel alone where Tk <= 128, else dq, then dk/dv) beside
    SDPA's forward and backward in the same type and key lengths, the
    plain versions (CUDA events) and the bounds."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att

    b, t, lo = HALF_SHAPES[shape]
    lens = half_lens(b, t, lo, seed=t + 1)
    d = D
    one = 5 * b * H * t * d * 2
    nbuf = max(1, math.ceil(200e6 / one))
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lt[:, None])[:, None,
                                                                None, :]
    scale = 1.0 / math.sqrt(d)
    g = torch.Generator(device="cpu").manual_seed(17)
    bufs, graphs = [], []
    for _ in range(nbuf):
        q, k, v, go = (((torch.rand(b, H, t, d, generator=g) - 0.5) * 2)
                       .to(dt).to(dev) for _ in range(4))
        out, lse = att.flash_attention(q, k, v, kv_valid_length=lt,
                                       return_lse=True)
        bufs.append([q, k, v, go, out, lse])
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        graphs.append((leaves, F.scaled_dot_product_attention(
            *leaves, attn_mask=mask), go))
    fused = fb.fused(bufs[0][0], bufs[0][1])
    fns = dict(fwd=lambda i: att.flash_attention(*bufs[i][:3],
                                                 kv_valid_length=lt))
    if fused:
        fns["fused"] = lambda i: fb.launch_fused(*bufs[i], lt, False, scale)
    else:
        for buf in bufs:
            buf.append(fb.launch_dq(*buf, lt, False, scale)[1])
        fns["dq"] = lambda i: fb.launch_dq(*bufs[i][:6], lt, False, scale)
        fns["dkv"] = lambda i: fb.launch_dkv(*bufs[i][:4], bufs[i][5],
                                             bufs[i][6], lt, False, scale)
    dev_ms = {k_: device_ms_per_call(fn, nbuf) for k_, fn in fns.items()}
    lib = dict(
        fwd=device_ms_per_call(lambda i: F.scaled_dot_product_attention(
            *bufs[i][:3], attn_mask=mask), nbuf),
        bwd=device_ms_per_call(lambda i: torch.autograd.grad(
            graphs[i][1], graphs[i][0], graphs[i][2], retain_graph=True),
            nbuf))
    plain = dict(
        fwd=cuda_time_ms(lambda i: att.flash_attention_reference(
            *bufs[i][:3], kv_valid_length=lt), nbuf, iters=5, reps=3),
        bwd=cuda_time_ms(lambda i: fb.flash_attention_bwd_reference(
            *bufs[i][:6], lt, False, scale), nbuf, iters=5, reps=3))
    bnds = half_bounds(b, t, d, lens)
    rows = {}
    for k_ in fns:
        bnd, by, nbytes = bnds[k_]
        rows[k_] = dict(
            shape=dict(B=b, H=H, T=t, d=d, kv_len=[min(lens), max(lens)],
                       dtype=sfx),
            ms=dev_ms[k_], plain_ms=plain["fwd" if k_ == "fwd" else "bwd"],
            library_ms=lib["fwd" if k_ == "fwd" else "bwd"], bound_ms=bnd,
            bound_by=by, nbytes=nbytes)
        print(f"  time {sfx} {shape} {k_}: B={b} H={H} T={t} d={d} kv_len "
              f"{min(lens)}..{max(lens)} device {dev_ms[k_]:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}; {nbytes} B), plain "
              f"{rows[k_]['plain_ms']:.4f} ms (events"
              f"{'' if k_ == 'fwd' else ', dq dk dv together'})")
    whole = sum(v_ for k_, v_ in dev_ms.items() if k_ != "fwd")
    print(f"  time {sfx} {shape}: SDPA ({sfx}, boolean key-padding mask) "
          f"forward {lib['fwd']:.4f} ms against {dev_ms['fwd']:.4f}; "
          f"backward {lib['bwd']:.4f} ms against "
          f"{'the fused dk/dv launch' if fused else 'dq + dk/dv'} "
          f"{whole:.4f} (device time, profiler); {nbuf} input copies")
    rows["whole_bwd_ms"] = whole
    return rows


def phase_half_times(dev):
    rows = {sfx: {shape: time_half(dt, sfx, shape, dev)
                  for shape in HALF_SHAPES} for dt, sfx in HALF}
    print("phase 23 16-bit attention times: done")
    return rows


def train_half(dev, card, dt, sfx, f32):
    """Phases 24 (bf16) and 25 (f16, dynamic loss scaling): BERT-base
    pretraining at bench_bert_base's settings through ShardedTrainer
    (adamw, lr 1e-4, wd 0.01, dropout 0.1, compute_dtype), 2 warm and 20
    timed steps on phase 11's batch, then 2 warm and 3 timed steps of
    PRETRAIN_512's rows of 512 tokens."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    mxrandom.seed(0)
    net = pretrain_model(dev, dropout=0.1)
    tr = ShardedTrainer(net, pretrain_loss, optimizer="adamw",
                        learning_rate=1e-4, weight_decay=0.01,
                        compute_dtype=dt)
    x, y = pretrain_batch(PRETRAIN["batch"], PRETRAIN["seq"],
                          PRETRAIN["masked"], seed=21)
    steps = 20
    losses, p50, wall, launches, peak = timed_steps(tr, x, y, dev, steps)
    # T = 128: the backward is the dk/dv kernel's fused mode alone
    half_launches(launches, sfx, steps, dict(flash_attention=12,
                                             flash_attention_bwd_dq=0,
                                             flash_attention_bwd_dkv=12))
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"loss did not fall: {vals[0]} -> {vals[-1]}")
    check(all(p.dtype == torch.float32 for p in net.parameters()),
          "a master parameter left f32")
    sps = PRETRAIN["batch"] * steps / wall
    out = dict(samples_per_s=sps, step_p50_ms=p50,
               wall_ms_per_step=wall * 1e3 / steps, steps=steps,
               launches={k: v for k, v in launches.items() if v},
               loss_first=vals[0], loss_last=vals[-1], peak_bytes=peak,
               loss_scale=tr.loss_scale, skipped_steps=tr.skipped_steps)
    print(f"  loss {vals[0]:.4f} (step 1) -> {vals[-1]:.4f} (step "
          f"{len(vals)}); loss scale {tr.loss_scale:g}, skipped "
          f"{tr.skipped_steps}; launches over {steps} steps: "
          f"{out['launches']}")
    # BERT's second pretraining phase runs rows of 512 (Devlin et al.
    # 2019: 90% of the steps at 128, 10% at 512): past 128 keys the
    # backward is dq, then dk/dv
    b5, t5, p5 = PRETRAIN_512["batch"], PRETRAIN_512["seq"], \
        PRETRAIN_512["masked"]
    x5, y5 = pretrain_batch(b5, t5, p5, seed=23)
    n5 = PRETRAIN_512["steps"]
    l5, p50_5, _, launches5, _ = timed_steps(tr, x5, y5, dev, n5)
    half_launches(launches5, sfx, n5, dict(flash_attention=12,
                                           flash_attention_bwd_dq=12,
                                           flash_attention_bwd_dkv=12))
    l5 = [float(v) for v in l5]
    check(all(math.isfinite(v) for v in l5), f"T=512: non-finite loss {l5}")
    out["seq512"] = dict(batch=b5, seq=t5, masked=p5, steps=n5,
                         step_p50_ms=p50_5, losses=l5,
                         launches={k: v for k, v in launches5.items() if v})
    print(f"  then {n5} steps of B={b5}, T={t5} ({p5} masked): loss "
          f"{l5[-1]:.4f}, step p50 {p50_5:.3f} ms; launches "
          f"{out['seq512']['launches']}")
    print(f"  {sfx} {sps:.2f} samples/s, step p50 {p50:.3f} ms, peak "
          f"{peak / 2**30:.2f} GiB against phase 11's f32 (adam) "
          f"{f32['samples_per_s']:.2f} samples/s, {f32['step_p50_ms']:.3f} "
          f"ms, {f32['peak_bytes'] / 2**30:.2f} GiB (x"
          f"{sps / f32['samples_per_s']:.3f} samples/s)")
    del tr, net
    return out


def half_launches(launches, sfx, steps, per_step):
    """Every 16-bit attention kernel launched ``per_step[name]`` times a
    step and no f32 kernel at all."""
    for name, n in per_step.items():
        got = launches[f"{name}.{sfx}"]
        check(got == n * steps, f"{name}.{sfx}: {got} launches in {steps} "
              f"steps, want {n} a step")
    check(not any(v for k, v in launches.items() if "." not in k),
          f"an f32 kernel launched in a {sfx} step: {launches}")


def phase_train_bf16(dev, card, f32):
    out = train_half(dev, card, torch.bfloat16, "bf16", f32)
    print(f"phase 24 train BERT-base bf16 (B=32, T=128, 20 masked, adamw, "
          f"dropout 0.1): {out['samples_per_s']:.2f} samples/s, step p50 "
          f"{out['step_p50_ms']:.3f} ms [{card}]")
    return out


def phase_train_fp16(dev, card, f32):
    """Phase 25: the f16 run, then a short run from an overflowing loss
    scale: steps skip while the scale halves, then the loss falls."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    out = train_half(dev, card, torch.float16, "f16", f32)
    mxrandom.seed(1)
    net = pretrain_model(dev, dropout=0.0)   # a loss that moves by steps only
    tr = ShardedTrainer(net, pretrain_loss, optimizer="adamw",
                        learning_rate=1e-4, weight_decay=0.01,
                        compute_dtype=torch.float16,
                        init_loss_scale=2.0 ** 30)
    x, y = pretrain_batch(PRETRAIN["batch"], PRETRAIN["seq"],
                          PRETRAIN["masked"], seed=21)
    seq = []
    for _ in range(24):
        loss = tr.step(x, y, block=True)
        seq.append((loss, tr.loss_scale, tr.skipped_steps))
    skipped = seq[-1][2]
    check(1 <= skipped < len(seq), f"overflow run skipped {skipped} of "
          f"{len(seq)} steps: {seq}")
    prev_scale, prev_skip = 2.0 ** 30, 0
    for loss, scale, skip in seq:
        want = prev_scale / 2 if skip > prev_skip else prev_scale
        check(scale == want, f"scale {scale} after a step, want {want}: "
              f"{seq}")
        prev_scale, prev_skip = scale, skip
    stepped = [loss for (loss, _, skip), (_, _, before) in
               zip(seq, [(0, 0, 0)] + seq[:-1]) if skip == before]
    check(len(stepped) >= 3 and stepped[-1] < stepped[0],
          f"the loss did not fall after the skips: {seq}")
    print(f"  from loss scale 2^30: {skipped} skipped steps, scale "
          f"{' -> '.join(f'{s:g}' for _, s, _ in seq[:skipped + 1])}; loss "
          f"over the stepped steps {stepped[0]:.4f} -> {stepped[-1]:.4f}")
    out["overflow_run"] = dict(skipped=skipped, scales=[s for _, s, _ in seq],
                               losses=[v for v, _, _ in seq])
    del tr, net
    print(f"phase 25 train BERT-base f16 with dynamic loss scaling: "
          f"{out['samples_per_s']:.2f} samples/s, step p50 "
          f"{out['step_p50_ms']:.3f} ms, {out['skipped_steps']} skipped "
          f"[{card}]")
    return out


def phase_train_cpu_bf16(dev):
    """Phase 26: phase 12's 2-layer full-width step in bf16 on the card
    (the 16-bit kernels) and on the CPU (their plain versions)."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    x, y = pretrain_batch(4, 128, PRETRAIN["masked"], seed=22)
    out = {}
    for where in (dev, "cpu"):
        net = pretrain_model(where, dropout=0.0, num_layers=2)
        tr = ShardedTrainer(net, pretrain_loss, optimizer="adamw",
                            learning_rate=1e-4, weight_decay=0.0,
                            compute_dtype=torch.bfloat16)
        loss = tr.step(x, y, block=True)
        out[str(where)] = (loss, {n: p.grad.detach().cpu().clone()
                                  for n, p in zip(tr.train_names,
                                                  tr.params)})
        del tr, net
    (gl, gg), (cl, cg) = out[str(dev)], out["cpu"]
    rel = abs(gl - cl) / abs(cl)
    check(rel <= HALF_LOSS_RTOL, f"bf16 step-1 loss card {gl} vs CPU {cl}: "
          f"rel {rel:.3e} over {HALF_LOSS_RTOL}")
    worst_name, worst = "", 0.0
    for name, c in cg.items():
        top = c.abs().max().item()
        err = (gg[name] - c).abs().max().item()
        check(err <= HALF_GRAD_TOL * top, f"bf16 grad {name}: card vs CPU "
              f"{err:.3e} > {HALF_GRAD_TOL} x {top:.3e}")
        if top > 0 and err / top > worst:
            worst_name, worst = name, err / top
    print(f"phase 26 card vs CPU in bf16 (2 layers, full width, B=4, T=128):"
          f" loss {gl:.6f} vs {cl:.6f} (rel {rel:.3e}, bar "
          f"{HALF_LOSS_RTOL}); worst gradient {worst:.3e} x max|g| "
          f"({worst_name}; bar {HALF_GRAD_TOL}) over {len(cg)} tensors")
    return dict(loss_rel_err=rel, grad_rel_err=worst, worst=worst_name)


# ------------------------ 16-bit batch norm and ResNet-50 training
# phase 27's shapes past ResNet-50's five: C % 8 != 0, one row, a wide C
BN16_EDGE = ((4097, 3), (4097, 12), (1, 64), (1, 8), (9, 2048), (4097, 77))
# views at a 2-byte storage offset (no 16-byte access): (rows, C, act)
BN16_OFFSET = ((4097, 64, "relu"), (4097, 12, "relu"),
               (100352, 128, "identity"))


def bn16_case(rows, c, dt, seed, dev, offset=False):
    """``bn_case``'s x, gamma and beta rounded to ``dt`` (the trainer
    casts gamma and beta to the compute type); x as a view at storage
    offset 1 (2 bytes) with ``offset``."""
    x, gamma, beta = (t.to(dt) for t in bn_case(rows, c, seed, dev))
    if offset:
        flat = torch.empty(rows * c + 1, dtype=dt, device=dev)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(rows, c)
    return x, gamma, beta


def bn16_overflow(dt, dev):
    """4097 x 8 with one outlier in channel 1 (x = 1000 in row 0, else 0)
    and gamma 2048 there: its normalized value is about 64, so y there
    is about 131,000, past f16's 65,504 (f16 gives inf, as the JAX op
    does; bf16 a finite value)."""
    x = torch.zeros(4097, 8, device=dev)
    x[0, 1] = 1000.0
    x[:, 2:] = torch.rand(4097, 6, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    gamma = torch.ones(8, device=dev)
    gamma[1] = 2048.0
    return x.to(dt), gamma.to(dt), torch.zeros(8, device=dev, dtype=dt)


def _bits(t):
    return t.view(torch.int16)


def phase_bn16_kernels(dev):
    """Phase 27: the bf16 / f16 stats and apply kernels against their
    plain versions: y bit for bit, scale and shift equal (each the f32
    fold rounded once), mean and var within STAT_TOL of each channel's
    scale of a float64 reference, the same bits on two runs, one launch
    each of the dtype's kernels."""
    from mxnet_tpu_torch.kernels import bn_act as kbn
    from mxnet_tpu_torch.kernels import registry

    worst = {}
    n_cases = 0
    for dt, sfx in HALF:
        s_name, a_name = f"bn_act_stats.{sfx}", f"bn_act_apply.{sfx}"
        worst[s_name] = worst[a_name] = 0.0
        worst_rel = 0.0
        cases = [(r, c, "relu", False) for r, c in RESNET50_BN] + \
            [(r, c, act, False) for r, c in BN16_EDGE
             for act in ("relu", "identity")] + \
            [(r, c, act, True) for r, c, act in BN16_OFFSET] + \
            [("overflow", 8, "identity", False)]
        for i, (rows, c, act, offset) in enumerate(cases):
            if rows == "overflow":
                x, gamma, beta = bn16_overflow(dt, dev)
                rows = x.shape[0]
            else:
                x, gamma, beta = bn16_case(rows, c, dt, seed=300 + i,
                                           dev=dev, offset=offset)
            label = (f"{sfx} rows={rows} C={c} {act}"
                     + (" offset 2 B" if offset else ""))
            before = registry.launches()
            got = kbn.bn_stats(x, gamma, beta, BN_EPS)
            mean, var, scale, shift = got
            y = kbn.bn_apply(x, scale, shift, act)
            torch.cuda.synchronize()
            after = registry.launches()
            check(after[s_name] - before[s_name] == 1
                  and after[a_name] - before[a_name] == 1
                  and sum(after.values()) - sum(before.values()) == 2,
                  f"bn16 {label}: launches {before} -> {after}")
            check(mean.dtype == var.dtype == torch.float32
                  and scale.dtype == shift.dtype == y.dtype == dt,
                  f"bn16 {label}: dtypes {[t.dtype for t in got]}, "
                  f"y {y.dtype}")
            again = kbn.bn_stats(x, gamma, beta, BN_EPS)
            y2 = kbn.bn_apply(x, again[2], again[3], act)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again))
                  and torch.equal(_bits(y), _bits(y2)),
                  f"bn16 {label}: two runs differ")
            x64 = x.double()
            ms = (x64 * x64).mean(0)
            ref_mean = x64.mean(0)
            ref_var = (x64 - ref_mean).square().mean(0)
            em, ev = stat_errors(mean, var, ref_mean, ref_var, ms)
            check(em <= STAT_TOL and ev <= STAT_TOL,
                  f"bn16 {label}: mean err {em:.3e}, var err {ev:.3e} x "
                  f"scale > {STAT_TOL}")
            worst_rel = max(worst_rel, em, ev)
            p_mean, p_var, p_scale, p_shift = kbn.bn_stats_plain(
                x, gamma, beta, BN_EPS)
            check(torch.equal(_bits(scale), _bits(p_scale))
                  and torch.equal(_bits(shift), _bits(p_shift)),
                  f"bn16 {label}: scale / shift differ from the plain "
                  f"fold: {(scale != p_scale).sum().item()} / "
                  f"{(shift != p_shift).sum().item()} of {c}")
            ref_y = kbn.bn_apply_plain(x, scale, shift, act)
            same = torch.equal(_bits(y), _bits(ref_y))
            check(same, f"bn16 {label}: y differs from plain in "
                  f"{(_bits(y) != _bits(ref_y)).sum().item()} elements")
            if i == len(cases) - 1:
                want_inf = dt == torch.float16
                check(bool(torch.isinf(y[0, 1])) == want_inf
                      and bool(torch.isfinite(y[:, 2:]).all()),
                      f"bn16 {label}: y[0, 1] = {y[0, 1].item()}")
            else:
                check(bool(torch.isfinite(y).all()),
                      f"bn16 {label}: non-finite y")
            err_s = max((a - b).abs().max().item() for a, b in
                        ((mean, p_mean), (var, p_var)))
            worst[s_name] = max(worst[s_name], err_s)
            if rows >= 4097 or i < len(RESNET50_BN):
                print(f"  bn16 {label}: mean / var vs plain {err_s:.3e} "
                      f"(vs float64 {em:.2e} / {ev:.2e} x scale); scale, "
                      f"shift and y equal bits")
            n_cases += 1
            del x, x64, y, y2, ref_y
        print(f"  {sfx}: mean and var within {STAT_TOL} x scale of "
              f"float64 (worst {worst_rel:.3e})")
    print(f"phase 27 16-bit bn_act kernels: {n_cases} cases (bf16, f16); "
          "y bit for bit with the plain version, scale and shift equal, "
          f"mean and var within {STAT_TOL} x scale of float64, the same "
          "bits twice; f16 past its range gives inf")
    return worst


def bn16_bound(rows, c, kernel):
    """Least time (ms) of a 16-bit kernel: stats reads x (2 bytes an
    element), gamma and beta and writes mean and var (f32) and scale and
    shift; apply reads x, scale and shift and writes y; 3 flops an
    element at the f32 peak, or the bytes at the HBM rate, whichever is
    larger."""
    if kernel == "stats":
        nbytes = rows * c * 2 + 4 * c * 2 + 2 * c * 4
    else:
        nbytes = 2 * rows * c * 2 + 2 * c * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * rows * c / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def time_bn16(rows, c, dt, sfx, dev, plain):
    """Device times (``device_ms_per_call``) of the 16-bit stats and
    apply kernels, ``torch.var_mean`` of the 16-bit x and
    ``F.batch_norm(training=True)`` + ``relu_`` in the same type (f32
    weights and running statistics, cuDNN's mixed form), inputs cycled
    past L2; with ``plain`` also the plain versions by CUDA events."""
    from mxnet_tpu_torch.kernels import bn_act as kbn

    # two copies at least: at the stem one 205 MB copy would leave its
    # last 50 MB in L2 for the next call
    nbuf = max(2, math.ceil(200e6 / (rows * c * 2)))
    bufs = [bn16_case(rows, c, dt, seed=400 + i, dev=dev)[0]
            for i in range(nbuf)]
    _, gamma, beta = bn16_case(1, c, dt, seed=99, dev=dev)
    _, _, scale, shift = kbn.bn_stats(bufs[0], gamma, beta, BN_EPS)
    g32, b32 = gamma.float(), beta.float()
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    out = dict(
        stats=device_ms_per_call(
            lambda i: kbn.bn_stats(bufs[i], gamma, beta, BN_EPS), nbuf),
        apply=device_ms_per_call(
            lambda i: kbn.bn_apply(bufs[i], scale, shift, "relu"), nbuf),
        var_mean=device_ms_per_call(
            lambda i: torch.var_mean(bufs[i], 0, unbiased=False), nbuf),
        batch_norm=device_ms_per_call(lambda i: F.batch_norm(
            bufs[i], rm, rv, g32, b32, training=True, momentum=0.1,
            eps=BN_EPS).relu_(), nbuf))
    if plain:
        out["stats_plain"] = cuda_time_ms(
            lambda i: kbn.bn_stats_plain(bufs[i], gamma, beta, BN_EPS), nbuf)
        out["apply_plain"] = cuda_time_ms(
            lambda i: kbn.bn_apply_plain(bufs[i], scale, shift, "relu"),
            nbuf)
    rows_out = {}
    for kernel, lib in (("stats", "var_mean"), ("apply", "batch_norm")):
        bnd, by, nbytes = bn16_bound(rows, c, kernel)
        rows_out[kernel] = dict(
            shape=dict(rows=rows, C=c), ms=out[kernel],
            plain_ms=out.get(f"{kernel}_plain"), library_ms=out[lib],
            bound_ms=bnd, bound_by=by)
        print(f"  device time {sfx} {kernel}: rows={rows} C={c} kernel "
              f"{out[kernel]:.4f} ms (bound {bnd:.4f}, {by}: {nbytes} B; "
              f"bound / time {bnd / out[kernel]:.2f}), "
              + (f"plain {out[kernel + '_plain']:.4f} ms (events), "
                 if plain else "")
              + f"library {out[lib]:.4f} ms; {nbuf} input copies")
    return rows_out


def phase_bn16_times(dev):
    """Phase 27's times: every ResNet-50 BatchNormReLU shape at B=128,
    bf16 and f16; the plain versions at the stem and at stage 4."""
    rows = {}
    for dt, sfx in HALF:
        rows[sfx] = [time_bn16(r, c, dt, sfx, dev, plain=k in (0, 4))
                     for k, (r, c) in enumerate(RESNET50_BN)]
    print("phase 27 16-bit bn_act times: done")
    return rows


def resnet_ce(pred, y):
    """``bench.py``'s ``_ce``: cross entropy of the scores cast to f32."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    return SoftmaxCrossEntropyLoss()(pred.float(), y)


def train_resnet16(dev, card, dt, sfx, fused, f32):
    """Phases 28-29: ``resnet50_v1(layout="NHWC")`` through
    ``ShardedTrainer(sgd, lr 0.05, momentum 0.9, compute_dtype=dt)`` as
    ``bench_resnet50`` runs it, on phase 15's batch: 2 warm and 20 timed
    steps, then untimed to step 60 (phase 15's reading of the loss)."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer

    variant = "fused BN+relu" if fused else "BatchNorm + relu"
    net = xavier_init(get_model("resnet50_v1", layout="NHWC",
                                fused_bn_relu=fused, classes=RESNET["classes"],
                                device=dev), 0)
    tr = ShardedTrainer(net, resnet_ce, optimizer="sgd", learning_rate=0.05,
                        momentum=0.9, compute_dtype=dt)
    x, y = resnet_batch(RESNET["batch"], RESNET["image"], RESNET["classes"],
                        seed=0, dev=dev)
    stat = net.features[1].running_mean          # the stem's BN
    stat0 = stat.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [tr.step(x, y) for _ in range(2)]
    tr.drain()
    steps = 20
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    registry.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        starts[i].record()
        losses.append(tr.step(x, y))
        ends[i].record()
    tr.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    losses += [tr.step(x, y) for _ in range(RESNET["steps"] - len(losses))]
    want = {"opt_arena": 1}
    if fused:
        want.update({f"bn_act_stats.{sfx}": 33, f"bn_act_apply.{sfx}": 33})
    for name, per_step in want.items():
        check(launches[name] == per_step * steps,
              f"{sfx} {variant}: {name} {launches[name]} launches in "
              f"{steps} steps, want {per_step} a step")
    check(all(v == 0 for k, v in launches.items() if k not in want),
          f"{sfx} {variant}: other kernels launched: {launches}")
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"{sfx} {variant}: loss did not fall: "
          f"{vals[0]} -> {vals[-1]}")
    check(all(p.dtype == torch.float32 for p in net.parameters())
          and all(b.dtype == torch.float32 for b in net.buffers()),
          "a master parameter or buffer left f32")
    check(not torch.equal(stat, stat0), "the running statistics never moved")
    check(tr.uses_arena, "the trainer did not pick the arena adapter")
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    p50 = statistics.median(step_ms)
    ips = RESNET["batch"] * steps / wall
    out = dict(img_per_s=ips, step_p50_ms=p50,
               wall_ms_per_step=wall * 1e3 / steps, steps=steps,
               peak_mem_bytes=peak,
               launches={k: v for k, v in launches.items() if v},
               loss_first=vals[0], loss_step22=vals[21], loss_last=vals[-1],
               loss_scale=tr.loss_scale, skipped_steps=tr.skipped_steps)
    print(f"  {sfx} {variant}: loss by step: "
          f"{' '.join(f'{v:.4f}' for v in vals)}")
    print(f"  {sfx} {variant}: {ips:.2f} img/s, step p50 {p50:.3f} ms "
          f"(CUDA events), wall {wall * 1e3 / steps:.3f} ms a step, peak "
          f"{peak / 2**30:.2f} GiB, loss scale {tr.loss_scale:g}, skipped "
          f"{tr.skipped_steps}; launches over {steps} steps "
          f"{out['launches']}; phase 15's f32 (fused BN+relu): "
          f"{f32['img_per_s']:.2f} img/s, {f32['step_p50_ms']:.3f} ms, "
          f"{f32['peak_mem_bytes'] / 2**30:.2f} GiB (x"
          f"{ips / f32['img_per_s']:.3f} img/s) [{card}]")
    del tr, net, x, y
    torch.cuda.empty_cache()
    return out


def phase_resnet_bf16(dev, card, f32):
    out = dict(plain=train_resnet16(dev, card, torch.bfloat16, "bf16",
                                    False, f32),
               fused=train_resnet16(dev, card, torch.bfloat16, "bf16", True,
                                    f32))
    print(f"phase 28 train ResNet-50 v1 bf16 (B={RESNET['batch']}, "
          f"{RESNET['image']}x{RESNET['image']}, NHWC, sgd momentum): "
          f"BatchNorm + relu {out['plain']['img_per_s']:.2f} img/s, step "
          f"p50 {out['plain']['step_p50_ms']:.3f} ms; fused BN+relu "
          f"{out['fused']['img_per_s']:.2f} img/s, "
          f"{out['fused']['step_p50_ms']:.3f} ms; f32 (phase 15) "
          f"{f32['img_per_s']:.2f} img/s, {f32['step_p50_ms']:.3f} ms "
          f"[{card}]")
    return out


def phase_resnet_fp16(dev, card, f32):
    out = train_resnet16(dev, card, torch.float16, "f16", True, f32)
    print(f"phase 29 train ResNet-50 v1 f16 with dynamic loss scaling "
          f"(fused BN+relu): {out['img_per_s']:.2f} img/s, step p50 "
          f"{out['step_p50_ms']:.3f} ms, loss scale {out['loss_scale']:g}, "
          f"{out['skipped_steps']} skipped [{card}]")
    return out


def phase_resnet_cpu_bf16(dev):
    """Phase 30: phase 16's step in bf16 on the card (the 16-bit bn_act
    kernels, cuDNN) and on the CPU (their plain versions), and in f32 on
    the CPU: the distance bf16 itself puts between two computations of
    this step.  At B=4, 64x64 and random weights the bf16 gradients of
    some tensors lie up to half their max from the f32 ones (16-bit
    batch norm subtracts the mean after rounding ``x * scale``; the CPU
    tests see the same in both packages), so each gradient and running
    statistic is held within the larger of 2^-4 x max|t| and
    ``HALF_NOISE_BARS`` times the CPU's own bf16-to-f32 distance of that
    tensor: each bf16 computation lies about that far from f32, so two
    of them may lie up to twice as far apart, and cuDNN's backward sums
    in no fixed order."""
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import BottleneckV1, \
        ResNetV1
    from mxnet_tpu_torch.parallel import ShardedTrainer

    out = {}
    for where, dt in ((dev, torch.bfloat16), ("cpu", torch.bfloat16),
                      ("cpu", None)):
        net = xavier_init(ResNetV1(
            BottleneckV1, [1, 1, 1, 1], [64, 256, 512, 1024, 2048],
            classes=1000, layout="NHWC", fused_bn_relu=True, device=where), 0)
        x, y = resnet_batch(4, 64, 1000, seed=1, dev=where)
        tr = ShardedTrainer(net, resnet_ce, optimizer="sgd",
                            learning_rate=0.05, momentum=0.9,
                            compute_dtype=dt)
        loss = tr.step(x, y, block=True)
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in zip(tr.train_names, tr.params)}
        stats = {n: b.detach().cpu().clone() for n, b in net.named_buffers()}
        out[(str(where), dt)] = (loss, grads, stats)
        del tr, net
    (gl, gg, gs), (cl, cg, cs), (_, fg, fs) = out.values()
    rel = abs(gl - cl) / abs(cl)
    check(rel <= HALF_LOSS_RTOL, f"bf16 ResNet step-1 loss card {gl} vs "
          f"CPU {cl}: rel {rel:.3e} over {HALF_LOSS_RTOL}")
    worst = {}
    for kind, got, want, f32 in (("grad", gg, cg, fg), ("stat", gs, cs, fs)):
        top_rel, top_noise = ("", 0.0), ("", 0.0)
        for name, c in want.items():
            check(got[name].dtype == torch.float32, f"{name} not f32")
            top = c.abs().max().item()
            err = (got[name] - c).abs().max().item()
            noise = (c - f32[name]).abs().max().item()
            bar = max(HALF_GRAD_TOL * top, HALF_NOISE_BARS * noise)
            check(err <= bar, f"bf16 {kind} {name}: card vs CPU {err:.3e} "
                  f"> max({HALF_GRAD_TOL} x {top:.3e}, {HALF_NOISE_BARS} x "
                  f"the CPU's bf16 vs f32 {noise:.3e})")
            if top > 0 and err / top > top_rel[1]:
                top_rel = (name, err / top)
            if noise > 0 and err / noise > top_noise[1]:
                top_noise = (name, err / noise)
        worst[kind] = dict(rel=top_rel, to_noise=top_noise)
    print(f"phase 30 card vs CPU in bf16 (ResNetV1 bottleneck [1,1,1,1] at "
          f"full width, fused, B=4, 64x64): loss {gl:.6f} vs {cl:.6f} (rel "
          f"{rel:.3e}, bar {HALF_LOSS_RTOL}); worst gradient "
          f"{worst['grad']['rel'][1]:.3e} x max|g| "
          f"({worst['grad']['rel'][0]}), worst running statistic "
          f"{worst['stat']['rel'][1]:.3e} x max|stat| "
          f"({worst['stat']['rel'][0]}); against the CPU's bf16-to-f32 "
          f"distance at most {worst['grad']['to_noise'][1]:.3f}x "
          f"({worst['grad']['to_noise'][0]}) and "
          f"{worst['stat']['to_noise'][1]:.3f}x "
          f"({worst['stat']['to_noise'][0]}); bar max({HALF_GRAD_TOL} x "
          f"max, {HALF_NOISE_BARS} x that distance)")
    return dict(loss_rel_err=rel, grad_rel_err=worst["grad"]["rel"][1],
                worst_grad=worst["grad"]["rel"][0],
                grad_to_noise=worst["grad"]["to_noise"][1],
                stat_rel_err=worst["stat"]["rel"][1],
                worst_stat=worst["stat"]["rel"][0],
                stat_to_noise=worst["stat"]["to_noise"][1])


# ------------------------------- the trainer's options and checkpoints
TRAIN16 = dict(learning_rate=1e-4, weight_decay=0.01,
               compute_dtype=torch.bfloat16)
# phase 32's schedule: PolyScheduler(max_update=20, base_lr=1e-4, pwr=1,
# warmup_steps=4), two B=16 micro-batches a window, 6 windows
SCHED = dict(max_update=20, base_lr=1e-4, pwr=1, warmup_steps=4)
WINDOW_TOL = 1e-5             # phase 32: x the parameters' max
# phase 31: multi-tensor LAMB's parameters against per-parameter, x each
# tensor's max (its states bit for bit): the per-tensor norms under vmap
# reduce in another order, a last-bit difference in the trust ratio
# (BERT-base bf16, 3 steps on an H100 80GB HBM3 at 700 W: 32 of 158
# tensors, max |d| 5.96e-8)
MT_NORM_TOL = 1e-6
CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"


def profile_steps(fn, n, groups=None):
    """``fn`` (one training step) run ``n`` times under ``torch.profiler``
    after a drain, as ``tools/torch_decode_profile.py`` profiles: kernel
    launches a step, device busy ms a step (the kernels' self device
    time) and the busy share of the profiled window; with ``groups``
    (``{name: predicate on a kernel's name}``, first match wins, else
    "elementwise and reductions") also the device ms a step of each."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    split = {k: 0.0 for k in list(groups or {})
             + ["elementwise and reductions"]}
    busy_us, count = 0.0, 0
    for evt in prof.key_averages():
        us = next((float(getattr(evt, k)) for k in (
            "self_device_time_total", "self_cuda_time_total")
            if hasattr(evt, k)), 0.0)
        if us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
            busy_us += us
            count += evt.count
            key = next((g for g, f in (groups or {}).items() if f(evt.key)),
                       "elementwise and reductions")
            split[key] += us / 1e3 / n
    out = dict(launches=count / n, device_busy_ms=busy_us / 1e3 / n,
               busy_share=busy_us / 1e3 / window_ms)
    if groups:
        out["split_ms"] = split
    return out


def bits_distance(a_list, b_list):
    """``(number of tensors that differ, max |a - b|)`` over two lists."""
    differ, worst = 0, 0.0
    for a, b in zip(a_list, b_list):
        if not torch.equal(a, b):
            differ += 1
            worst = max(worst, (a.double() - b.double()).abs().max().item())
    return differ, worst


def mt_trainer(dev, opt, multi, dropout=0.0, compute_dtype=torch.bfloat16,
               **kw):
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    mxrandom.seed(0)
    net = pretrain_model(dev, dropout=dropout)
    args = dict(TRAIN16, compute_dtype=compute_dtype)
    args.update(kw)
    tr = ShardedTrainer(net, pretrain_loss, optimizer=opt,
                        multi_tensor=multi, **args)
    return net, tr


def phase_multi_tensor(dev, card):
    """Phase 31: BERT-base bf16 as bench_bert_base trains it (B=32,
    T=128, 20 masked, lr 1e-4, wd 0.01, dropout 0 for the comparison):
    5 steps with ``multi_tensor=True`` against 5 per-parameter steps from
    the same weights, adamw then lamb (3 steps); parameters and optimizer
    states bit for bit (lamb: states bit for bit, parameters within
    ``MT_NORM_TOL`` of each tensor's max).  Then, per adapter, launches a step and the busy
    share (profiler, 5 steps), step p50 (CUDA events) and wall a step
    (10 timed steps), and the number of groups."""
    x, y = pretrain_batch(PRETRAIN["batch"], PRETRAIN["seq"],
                          PRETRAIN["masked"], seed=21)
    out = {}
    for opt, steps in (("adamw", 5), ("lamb", 3)):
        runs = {}
        for multi in (False, True):
            net, tr = mt_trainer(dev, opt, multi)
            check(not tr.uses_arena, f"{opt}: the arena took the update")
            losses = [float(tr.step(x, y)) for _ in range(steps)]
            tr.drain()
            runs[multi] = (net, tr, losses)
        (n0, t0, l0), (n1, t1, l1) = runs[False], runs[True]
        pd = bits_distance([p.detach() for p in t0.params],
                           [p.detach() for p in t1.params])
        sd = bits_distance(t0._adapter.leaves(), t1._adapter.leaves())
        groups = t1._adapter.groups
        print(f"  {opt}: {steps} steps, losses per-parameter "
              f"{' '.join(f'{v:.6f}' for v in l0)}, multi-tensor "
              f"{' '.join(f'{v:.6f}' for v in l1)}; parameters differing "
              f"{pd[0]} of {len(t0.params)} (max |d| {pd[1]:.3e}), states "
              f"{sd[0]} of {len(t0._adapter.leaves())} (max |d| "
              f"{sd[1]:.3e}); {len(groups)} groups over "
              f"{len(t1.params)} parameters (largest "
              f"{max(len(g) for g in groups)})")
        if opt == "lamb":
            # the trust ratio's norms: a stacked group's norm reduces each
            # row in another order than a lone tensor's (MT_NORM_TOL)
            rel = max(((a.detach() - b.detach()).abs().max()
                       / b.detach().abs().max()).item()
                      for a, b in zip(t1.params, t0.params))
            print(f"  lamb parameters: worst |d| {rel:.3e} x the tensor's "
                  f"max (bar {MT_NORM_TOL})")
            check(sd[0] == 0 and rel <= MT_NORM_TOL,
                  f"lamb: states {sd}, parameters {rel:.3e} x max")
        else:
            check(pd[0] == 0 and sd[0] == 0 and l0 == l1,
                  f"{opt}: multi-tensor and per-parameter differ: "
                  f"parameters {pd}, states {sd}, losses {l0} vs {l1}")
        row = dict(steps=steps, groups=len(groups), params=len(t1.params),
                   losses=l1)
        if opt == "adamw":
            for multi, (net, tr, _) in runs.items():
                prof = profile_steps(lambda: tr.step(x, y), 5)
                _, p50, wall, launches, _ = timed_steps(tr, x, y, dev, 10)
                half_launches(launches, "bf16", 10, dict(
                    flash_attention=12, flash_attention_bwd_dq=0,
                    flash_attention_bwd_dkv=12))
                key = "multi_tensor" if multi else "per_parameter"
                row[key] = dict(prof, step_p50_ms=p50,
                                wall_ms_per_step=wall * 1e3 / 10)
                print(f"  adamw {key.replace('_', '-')}: "
                      f"{prof['launches']:.0f} launches a step, busy "
                      f"share {prof['busy_share']:.3f} (device "
                      f"{prof['device_busy_ms']:.3f} ms a step), step p50 "
                      f"{p50:.3f} ms (CUDA events), wall "
                      f"{wall * 1e2:.3f} ms a step [{card}]")
        out[opt] = row
        del runs, n0, t0, n1, t1, net, tr
        torch.cuda.empty_cache()
    a = out["adamw"]
    print(f"phase 31 multi-tensor vs per-parameter (BERT-base bf16, B=32, "
          f"T=128): adamw bit for bit, lamb's states bit for bit; adamw "
          f"launches a step "
          f"{a['per_parameter']['launches']:.0f} -> "
          f"{a['multi_tensor']['launches']:.0f}, busy share "
          f"{a['per_parameter']['busy_share']:.3f} -> "
          f"{a['multi_tensor']['busy_share']:.3f}, step p50 "
          f"{a['per_parameter']['step_p50_ms']:.3f} -> "
          f"{a['multi_tensor']['step_p50_ms']:.3f} ms, wall "
          f"{a['per_parameter']['wall_ms_per_step']:.3f} -> "
          f"{a['multi_tensor']['wall_ms_per_step']:.3f} ms a step, "
          f"{a['groups']} groups [{card}]")
    return out


def phase_schedule_accum(dev, card):
    """Phase 32: BERT-base f32 adam (the arena) under
    ``PolyScheduler(**SCHED)`` with ``grad_accum=2``: 6 windows of two
    B=16 halves of phase 11's batch (dropout 0); ``opt_arena`` launched
    once a window at ``scheduler(t)``; one window against one B=32 step
    from the same state; ``set_learning_rate`` raises."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.lr_scheduler import PolyScheduler

    x, y = pretrain_batch(PRETRAIN["batch"], PRETRAIN["seq"],
                          PRETRAIN["masked"], seed=21)
    half = PRETRAIN["batch"] // 2
    halves = [(tuple(a[s] for a in x), tuple(a[s] for a in y))
              for s in (slice(0, half), slice(half, None))]
    nets = {}
    for accum in (1, 2):
        sched = PolyScheduler(**SCHED)
        nets[accum] = mt_trainer(dev, "adam", False, compute_dtype=None,
                                 lr_scheduler=sched, grad_accum=accum)
        check(nets[accum][1].uses_arena, "the arena did not take adam")
    (n1, t1), (n2, t2) = nets[1], nets[2]
    t1.step(x, y, block=True)
    for xb, yb in halves:
        t2.step(xb, yb, block=True)
    top = max(p.detach().abs().max().item() for p in t1.params)
    window = max((a.detach() - b.detach()).abs().max().item()
                 for a, b in zip(t1.params, t2.params))
    print(f"  one window of two B={half} halves vs one B={2 * half} step: "
          f"max |d| "
          f"{window:.3e} = {window / top:.3e} x the parameters' max "
          f"{top:.4f} (bar {WINDOW_TOL})")
    check(window <= WINDOW_TOL * top, f"window vs one step: {window:.3e} > "
          f"{WINDOW_TOL} x {top:.4f}")
    del n1, t1, nets
    torch.cuda.empty_cache()
    seen = []
    update = t2._adapter.update

    def recorded(params, grads, garena, lr, t):
        seen.append((t, lr))
        return update(params, grads, garena, lr, t)

    t2._adapter.update = recorded
    registry.reset_launches()
    losses = []
    for _ in range(6):
        for xb, yb in halves:
            losses.append(t2.step(xb, yb))
    t2.drain()
    launches = registry.launches()
    t2._adapter.update = update
    want = [(t, t2.lr_scheduler(t)) for t in range(2, 8)]
    check(launches["opt_arena"] == 6, f"opt_arena launched "
          f"{launches['opt_arena']} times in 6 windows, want 6")
    check(seen == want, f"window lrs {seen}, want {want}")
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss")
    try:
        t2.set_learning_rate(1e-3)
    except MXNetError:
        pass
    else:
        check(False, "set_learning_rate did not raise under a schedule")
    print(f"phase 32 schedule + grad_accum=2 through the arena (BERT-base "
          f"f32 adam, 6 windows of 2 x B={half}): opt_arena "
          f"{launches['opt_arena']} launches, one a window, at lr "
          f"{' '.join(f'{lr:.4e}' for _, lr in seen)} = "
          f"PolyScheduler(t) for t 2..7; window vs one step "
          f"{window / top:.3e} x max [{card}]")
    out = dict(launches_opt_arena=launches["opt_arena"], windows=6,
               lrs=[lr for _, lr in seen], window_rel_err=window / top,
               losses=[float(v) for v in losses])
    del n2, t2
    torch.cuda.empty_cache()
    return out


def resume_run(dev, dt, steps, split, init_scale=None):
    """BERT-base adamw ``multi_tensor=True`` with dropout 0.1 in ``dt``:
    ``steps`` uninterrupted, or ``split`` steps, save_states, a fresh net
    and trainer, load_states, the rest.  Returns the final parameters,
    optimizer state leaves, losses and loss-scale state."""
    from mxnet_tpu_torch import random as mxrandom

    kw = {} if init_scale is None else dict(init_loss_scale=init_scale)
    x, y = pretrain_batch(PRETRAIN["batch"], PRETRAIN["seq"],
                          PRETRAIN["masked"], seed=21)
    net, tr = mt_trainer(dev, "adamw", True, dropout=0.1, compute_dtype=dt,
                         **kw)
    losses = [float(tr.step(x, y)) for _ in range(split or steps)]
    if split:
        CKPT_DIR.mkdir(parents=True, exist_ok=True)
        path = str(CKPT_DIR / "bert.npz")
        tr.save_states(path)
        meta = (tr.loss_scale, int(tr._good), tr.skipped_steps, tr._t)
        del net, tr
        torch.cuda.empty_cache()
        from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
        from mxnet_tpu_torch.parallel import ShardedTrainer

        net = fresh_bert(dev)
        mxrandom.seed(123)                # the file carries the draws
        tr = ShardedTrainer(net, pretrain_loss, optimizer="adamw",
                            multi_tensor=True,
                            **dict(TRAIN16, compute_dtype=dt))
        tr.load_states(path)
        os.remove(path)
        check((tr.loss_scale, int(tr._good), tr.skipped_steps, tr._t)
              == meta, f"loss-scale state not carried: {meta} -> "
              f"{(tr.loss_scale, int(tr._good), tr.skipped_steps, tr._t)}")
        losses += [float(tr.step(x, y)) for _ in range(steps - split)]
    tr.drain()
    state = dict(params=[p.detach().clone() for p in tr.params],
                 leaves=[t.clone() for t in tr._adapter.leaves()],
                 losses=losses, scale=tr.loss_scale,
                 skipped=tr.skipped_steps)
    del net, tr
    torch.cuda.empty_cache()
    return state


def fresh_bert(dev):
    """BERT-base of phase 11's build from another seed: every value the
    resume shows must come from the file."""
    from mxnet_tpu_torch.gluon.model_zoo import BERTForPretrain, \
        bert_12_768_12

    return xavier_init(BERTForPretrain(bert_12_768_12(device=dev, dropout=0.1,
                                                      **BERT_BASE)), 1)


def phase_resume(dev, card):
    """Phase 33: BERT-base bf16 adamw ``multi_tensor=True``, dropout 0.1:
    4 steps, ``save_states``, a fresh net and trainer, ``load_states``, 4
    steps, against 8 uninterrupted steps, run twice (the distance two
    uninterrupted runs lie apart, the bar when it is not 0); the same in
    f16 from loss scale 2^20 (skipped steps, then the scale and the
    counts carried); ``save_parameters`` -> ``load_parameters`` on a
    fresh net gives the same outputs bit for bit; ``save_states`` in the
    middle of a gradient-accumulation window raises."""
    from mxnet_tpu_torch.base import MXNetError

    out = {}
    for dt, sfx, scale in ((torch.bfloat16, "bf16", None),
                           (torch.float16, "f16", 2.0 ** 20)):
        whole = resume_run(dev, dt, 8, 0, scale)
        again = resume_run(dev, dt, 8, 0, scale)
        resumed = resume_run(dev, dt, 8, 4, scale)
        rep = bits_distance(whole["params"] + whole["leaves"],
                            again["params"] + again["leaves"])
        res = bits_distance(whole["params"] + whole["leaves"],
                            resumed["params"] + resumed["leaves"])
        print(f"  {sfx}: 8 steps {' '.join(f'{v:.6f}' for v in whole['losses'])}"
              f"; resumed at 4 {' '.join(f'{v:.6f}' for v in resumed['losses'])}"
              f"; two uninterrupted runs differ in {rep[0]} tensors (max "
              f"|d| {rep[1]:.3e}), resumed vs uninterrupted in {res[0]} "
              f"(max |d| {res[1]:.3e}); loss scale {resumed['scale']:g}, "
              f"skipped {resumed['skipped']}")
        check(res[1] <= rep[1] and (rep[0] or res[0] == 0),
              f"{sfx} resume: {res} apart, two uninterrupted runs {rep}")
        check(resumed["losses"] == whole["losses"] or rep[0] > 0,
              f"{sfx} resume: losses differ")
        if scale:
            check(resumed["skipped"] == whole["skipped"] > 0,
                  f"f16: skipped {resumed['skipped']} vs {whole['skipped']}")
        out[sfx] = dict(repeat_tensors=rep[0], repeat_max=rep[1],
                        resume_tensors=res[0], resume_max=res[1],
                        losses=resumed["losses"], loss_scale=resumed["scale"],
                        skipped=resumed["skipped"])
        del whole, again, resumed
        torch.cuda.empty_cache()
    # parameters file: the same outputs from a fresh net
    x, _ = pretrain_batch(4, PRETRAIN["seq"], PRETRAIN["masked"], seed=5)
    xs = tuple(torch.as_tensor(a, device=dev) for a in x)
    net = pretrain_model(dev, dropout=0.1)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / "bert.params")
    net.save_parameters(path)
    fresh = fresh_bert(dev)
    fresh.load_parameters(path)
    os.remove(path)
    with torch.no_grad():
        same = all(torch.equal(a, b) for a, b in zip(net(*xs), fresh(*xs)))
    check(same, "save_parameters -> load_parameters changed the outputs")
    del net, fresh
    # mid-window refusal
    net, tr = mt_trainer(dev, "adamw", True, grad_accum=2)
    xb, yb = pretrain_batch(4, PRETRAIN["seq"], PRETRAIN["masked"], seed=6)
    tr.step(xb, yb, block=True)
    try:
        tr.save_states(str(CKPT_DIR / "never.npz"))
    except MXNetError:
        pass
    else:
        check(False, "save_states in mid-window did not raise")
    del net, tr
    torch.cuda.empty_cache()
    b, f = out["bf16"], out["f16"]
    print(f"phase 33 resume (BERT-base adamw multi-tensor, dropout 0.1): "
          f"bf16 resumed vs uninterrupted {b['resume_tensors']} tensors "
          f"apart (max {b['resume_max']:.3e}; two uninterrupted runs "
          f"{b['repeat_tensors']}, {b['repeat_max']:.3e}); f16 "
          f"{f['resume_tensors']} ({f['resume_max']:.3e}; "
          f"{f['repeat_tensors']}, {f['repeat_max']:.3e}), loss scale "
          f"{f['loss_scale']:g}, {f['skipped']} skipped; parameters file "
          f"bit for bit; save_states mid-window raises [{card}]")
    return out


# phase 34: each registry optimizer's settings on LeNet-5 (the defaults
# but for the learning rate, kept small enough for 3 steps to train)
REGISTRY_LR = {"sgd": 0.05, "nag": 0.05, "signum": 1e-3, "lars": 0.1,
               "lbsgd": 0.05, "dcasgd": 0.05, "sgld": 1e-4, "test": 0.05,
               "adadelta": 1.0, "ftrl": 0.1, "adagrad": 0.01}
REGISTRY_TOL = 1e-5           # x each tensor's max


def lenet_grads(net, x, y):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(x), y)
    autograd.backward(loss)
    return float(loss.detach().mean())


def phase_registry(dev, card):
    """Phase 34: LeNet-5 through ``gluon.Trainer`` at B=64, 3 steps of
    each of the 19 registry optimizers on the card and on the CPU (the
    plain path) from the same weights and with the card's gradients:
    every parameter within 1e-5 of its tensor's max; SGLD held on its
    drift (its noise replayed from the card generator's state) and on the
    noise's moments.  Then Adam under a ``FactorScheduler`` through
    ``save_states`` / ``load_states`` and ``save_parameters`` /
    ``load_parameters`` resumes bit for bit (cuDNN deterministic)."""
    from mxnet_tpu_torch import gluon, optimizer as opt_mod
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.lr_scheduler import FactorScheduler

    images, labels = mnist_arrays(True, 64 * 4)
    batches = [(torch.from_numpy(images[i * 64:(i + 1) * 64]),
                torch.from_numpy(labels[i * 64:(i + 1) * 64]))
               for i in range(4)]
    worst = {}
    for name in sorted(opt_mod._REG):
        kw = {"learning_rate": REGISTRY_LR.get(name, 1e-3)}
        card_net = xavier_init(get_model("lenet", device=dev), 0)
        cpu_net = xavier_init(get_model("lenet", device="cpu"), 0)
        ctr = gluon.Trainer(card_net.collect_params(), name, dict(kw))
        htr = gluon.Trainer(cpu_net.collect_params(), name, dict(kw))
        gen = mxrandom.generator(dev)
        err = 0.0
        for x, y in batches[:3]:
            lenet_grads(card_net, x.to(dev), y.to(dev))
            before = {n: p.detach().cpu().clone()
                      for n, p in card_net.named_parameters()}
            for (n, pc), ph in zip(card_net.named_parameters(),
                                   cpu_net.parameters()):
                ph.grad = pc.grad.detach().cpu().clone()
            gstate = gen.get_state()
            ctr.step(64)
            htr.step(64)
            ctr.drain()
            if name == "sgld":
                err = max(err, sgld_check(card_net, before, gen, gstate,
                                          kw["learning_rate"]))
                for pc, ph in zip(card_net.parameters(),
                                  cpu_net.parameters()):
                    ph.data.copy_(pc.detach().cpu())
                continue
            for (n, pc), ph in zip(card_net.named_parameters(),
                                   cpu_net.parameters()):
                a, b = pc.detach().cpu(), ph.detach()
                top = max(b.abs().max().item(), 1e-30)
                e = (a - b).abs().max().item() / top
                err = max(err, e)
                check(e <= REGISTRY_TOL, f"{name}: {n} card vs CPU "
                      f"{e:.3e} x max > {REGISTRY_TOL}")
        moved = any(not torch.equal(p.detach().cpu(), q.detach()) for p, q in
                    zip(card_net.parameters(),
                        xavier_init(get_model("lenet", device="cpu"), 0)
                        .parameters()))
        check(moved, f"{name}: the parameters never moved")
        worst[name] = err
        del card_net, cpu_net, ctr, htr
    print("  card vs CPU, worst x max over 3 steps: " + ", ".join(
        f"{n} {e:.1e}" for n, e in worst.items()))
    # Adam under a FactorScheduler, resumed through the files
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def trainer(net, begin=0):
        return gluon.Trainer(net.collect_params(), "adam", {
            "learning_rate": 1e-3, "begin_num_update": begin,
            "lr_scheduler": FactorScheduler(step=1, factor=0.7,
                                            base_lr=1e-3)})

    def run(net, tr, part):
        out = []
        for x, y in part:
            out.append(lenet_grads(net, x.to(dev), y.to(dev)))
            tr.step(64)
        return out

    net = xavier_init(get_model("lenet", device=dev), 0)
    whole = run(net, trainer(net), batches)
    net1 = xavier_init(get_model("lenet", device=dev), 0)
    tr1 = trainer(net1)
    run(net1, tr1, batches[:2])
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    net1.save_parameters(str(CKPT_DIR / "lenet.params"))
    tr1.save_states(str(CKPT_DIR / "lenet.states"))
    net2 = xavier_init(get_model("lenet", device=dev), 7)
    net2.load_parameters(str(CKPT_DIR / "lenet.params"))
    tr2 = trainer(net2, begin=2)
    tr2.load_states(str(CKPT_DIR / "lenet.states"))
    rest = run(net2, tr2, batches[2:])
    torch.backends.cudnn.deterministic = prev
    for f in ("lenet.params", "lenet.states"):
        os.remove(CKPT_DIR / f)
    same = rest == whole[2:] and all(
        torch.equal(a, b) for a, b in zip(net.parameters(),
                                          net2.parameters()))
    check(same, f"gluon resume under FactorScheduler: losses {rest} vs "
          f"{whole[2:]}")
    print(f"phase 34 the 19 registry optimizers on the card (LeNet-5, "
          f"gluon.Trainer, B=64, 3 steps): every parameter within "
          f"{REGISTRY_TOL} x its tensor's max of the CPU's (worst "
          f"{max(v for k, v in worst.items() if k != 'sgld'):.3e}); SGLD "
          f"drift within {worst['sgld']:.3e}; gluon.Trainer adam + "
          f"FactorScheduler resumed bit for bit [{card}]")
    return dict(worst=worst, resume_bit_for_bit=same)


def sgld_check(net, before, gen, gstate, lr):
    """One SGLD step on the card: the noise replayed from the generator's
    state before the step, parameter by parameter in the trainer's order;
    ``w - lr / 2 * g + sqrt(lr) * noise`` computed on the CPU against the
    card's weights (within REGISTRY_TOL x max), and the noise's mean and
    standard deviation over every parameter (within 4 standard errors of
    0 and 1).  Returns the drift's error relative to the max."""
    after = gen.get_state()
    gen.set_state(gstate)
    params = [p for _, p in sorted(net.collect_params().items())]
    noise = [torch.randn(p.shape, dtype=p.dtype, device=p.device,
                         generator=gen).cpu() for p in params]
    gen.set_state(after)
    names = sorted(net.collect_params())
    err = 0.0
    for n, p, z in zip(names, params, noise):
        g = p.grad.detach().cpu() * (1.0 / 64)
        want = before[n] - lr / 2 * g + z * math.sqrt(lr)
        got = p.detach().cpu()
        e = (got - want).abs().max().item() / want.abs().max().item()
        check(e <= REGISTRY_TOL, f"sgld {n}: {e:.3e} x max")
        err = max(err, e)
    flat = torch.cat([z.flatten() for z in noise]).double()
    k = flat.numel()
    check(abs(flat.mean().item()) < 4 / math.sqrt(k)
          and abs(flat.std().item() - 1) < 4 * math.sqrt(0.5 / k),
          f"sgld noise mean {flat.mean().item():.3e} std "
          f"{flat.std().item():.5f} over {k}")
    return err


# ------------------------------------------------------ 16-bit serving
DEC16_SHAPES = [(tq, c) for c in (100, 1024) for tq in (1, 3, 8, 9, 64, 256)
                if tq <= c]
DEC16_D = (36, 64, 128)
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int8: "int8"}


def phase_decode16_kernels(dev):
    """Phase 35a: every (query type, cache type) pair of the decode
    kernel against its plain version."""
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.test_utils import DECODE_PAIRS, decode_bar, \
        decode_case

    worst, n = {}, 0
    for q_dt, kv_dt in DECODE_PAIRS:
        name = att.decode_kernel_name(q_dt, kv_dt)
        worst[name], rel = 0.0, 0.0
        for tq, c in DEC16_SHAPES:
            for d in DEC16_D:
                lens = [0, 1, (c - tq) // 2, c - tq]   # inert row, edge
                kern, plain = decode_case(q_dt, kv_dt, 4, 6, tq, c, d, lens,
                                          seed=tq * 1000 + c + d, device=dev)
                out, lse = att.flash_attention_decode(**kern, return_lse=True)
                ref, ref_lse = att.flash_attention_decode_reference(
                    **plain, return_lse=True)
                label = f"{name} Tq={tq} C={c} d={d}"
                check(out.dtype == q_dt and bool(torch.isfinite(out).all()),
                      f"{label}: {out.dtype}, or non-finite output")
                err = (out.float() - ref.float()).abs()
                bar = decode_bar(q_dt, kv_dt, ref)
                if bar is None:
                    check(bool((err <= TOL + TOL * ref.abs()).all()),
                          f"{label}: max err {err.max().item():.3e} over "
                          f"atol=rtol={TOL}")
                else:
                    check(err.max().item() <= bar, f"{label}: max err "
                          f"{err.max().item():.3e} > bar {bar:.3e}")
                lerr = (lse - ref_lse).abs()
                check(bool((lerr <= TOL + TOL * ref_lse.abs()).all()),
                      f"{label}: lse err {lerr.max().item():.3e}")
                top = ref.float().abs().max().item()
                worst[name] = max(worst[name], err.max().item())
                rel = max(rel, err.max().item() / top)
                n += 1
        print(f"  {name}: {len(DEC16_SHAPES) * len(DEC16_D)} cases (Tq "
              "1/3/8/9/64/256, C 100/1024, d 36/64/128, an inert row and "
              f"one at the capacity's edge), max abs err {worst[name]:.3e} "
              f"({rel:.3e} x max|ref|)")
    print(f"phase 35 decode kernels, every (query, cache) pair vs plain: {n} "
          "cases within their bars (2^-7 bf16, 2^-10 f16 x max|ref|; "
          f"atol=rtol={TOL} f32), NaN past every window never read")
    return worst


def dec_mma_terms(q_dt, kv_dt):
    """``(S, P V)``: the 16-bit MMAs a product of the pair's split-K takes
    where it runs on tensor cores (a 16-bit cache, or int8 under 16-bit
    queries): S one a term of q in the cache's type (f32 three, f16 into
    bf16 two, else one), P V one, or three over int8 (w = p * v_scale
    as three bf16 terms); None where it runs on CUDA cores."""
    half = (torch.bfloat16, torch.float16)
    if kv_dt in half:
        return (1 if q_dt in (kv_dt, torch.bfloat16) else
                3 if q_dt == torch.float32 else 2, 1)
    if kv_dt == torch.int8 and q_dt in half:
        return 1, 3
    return None


def dec16_bound(q_dt, kv_dt, b, tq, c, d, lens):
    """Least time (ms) of a decode call: each input read once (the
    attended cache positions only), the output written once, at 3.35e12
    B/s; or its multiply-adds (2 d flops an attended pair a product) at
    the peak of the units that run them: on the chunk path (Tq > 8 where
    q and the cache share a float type, or f32 over int8) 16-bit MMAs
    (989e12), one each for S and P V; on split-K 16-bit MMAs as many as
    ``dec_mma_terms`` counts where it runs on tensor cores, f32 CUDA cores
    (67e12) for S and P V elsewhere."""
    qe = torch.tensor([], dtype=q_dt).element_size()
    ke = torch.tensor([], dtype=kv_dt).element_size()
    kv_pos = sum(min(x + tq, c) for x in lens) * H
    nbytes = (2 * b * H * tq * d * qe + 2 * kv_pos * d * ke + b * 4
              + (2 * kv_pos * 4 if kv_dt == torch.int8 else 0))
    attended = sum(min(x + i + 1, c) for x in lens for i in range(tq)) * H
    chunk = tq > 8 and (q_dt == kv_dt or (q_dt == torch.float32
                                         and kv_dt == torch.int8))
    terms = (1, 1) if chunk else dec_mma_terms(q_dt, kv_dt)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * d * attended * sum(terms) / HALF_FLOP_PER_S if terms
             else 4 * d * attended / F32_FLOP_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def time_decode16(q_dt, kv_dt, b, tq, c, lens, dev, d=D):
    """The pair's device time (profiler) beside its plain version (CUDA
    events), SDPA in the same types with the boolean decode mask where q
    and the cache share a float type (no one call takes a mixed or int8
    pair), and the bound."""
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.test_utils import decode_bar, decode_case

    ke = torch.tensor([], dtype=kv_dt).element_size()
    one = 2 * b * H * c * d * ke
    nbuf = max(1, math.ceil(200e6 / one)) if one > 4e6 else 1
    cases = [decode_case(q_dt, kv_dt, b, H, tq, c, d, lens, seed=50 + i,
                         device=dev) for i in range(nbuf)]
    bufs, plains = [c_[0] for c_ in cases], [c_[1] for c_ in cases]
    mask = att.decode_mask(bufs[0]["cache_len"], tq, c)
    out = att.flash_attention_decode(**bufs[0])
    ref = att.flash_attention_decode_reference(**plains[0])
    err = (out.float() - ref.float()).abs().max().item()
    bar = decode_bar(q_dt, kv_dt, ref)
    check(err <= (bar if bar is not None else TOL * (1 + ref.abs().max()
                                                      .item())),
          f"timed {q_dt} over {kv_dt}: off by {err:.3e}")

    def kern_fn(i):
        return att.flash_attention_decode(**bufs[i])

    same = q_dt == kv_dt
    dev_ms = device_ms_per_call(kern_fn, nbuf)
    per_call = kernels_per_call(kern_fn, nbuf)
    lib_ms = device_ms_per_call(lambda i: F.scaled_dot_product_attention(
        plains[i]["q"], plains[i]["k"], plains[i]["v"], attn_mask=mask),
        nbuf) if same else None
    plain_ms = cuda_time_ms(lambda i: att.flash_attention_decode_reference(
        **plains[i]), nbuf, iters=5, reps=3)
    bnd, by, nbytes = dec16_bound(q_dt, kv_dt, b, tq, c, d, lens)
    name = att.decode_kernel_name(q_dt, kv_dt)
    length, splits = att.split_plan(
        b * H, tq, c, d, torch.cuda.get_device_properties(dev)
        .multi_processor_count, grouped=not att._has_chunk_path(q_dt, kv_dt))
    path = f"split-K S={splits} L={length}" if splits else "chunk"
    print(f"  time {name}: B={b} H={H} Tq={tq} C={c} d={d} cache_len "
          f"{min(lens)}..{max(lens)} ({path}) device {dev_ms:.4f} ms "
          f"({per_call} kernel launches a call), bound "
          f"{bnd:.4f} ms ({by}; {nbytes} B), plain {plain_ms:.4f} ms "
          f"(events), SDPA "
          f"{'n/a (no one call)' if lib_ms is None else f'{lib_ms:.4f} ms'}"
          f" (device); {nbuf} input copies")
    return dict(shape=dict(B=b, H=H, Tq=tq, C=c, d=d,
                           cache_len=[min(lens), max(lens)],
                           q=_SHORT[q_dt], cache=_SHORT[kv_dt]),
                ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bnd, bound_by=by, nbytes=nbytes, splits=splits,
                split_len=length, launches_per_call=per_call,
                max_abs_err=err)


def phase_decode16_times(dev):
    """Phase 35b: each new pair at the decode shape; the main path's pair
    (bf16 over bf16) also at a 256-token prefill chunk; the six pairs
    whose split-K moved from CUDA cores onto tensor cores (a mixed pair
    over a 16-bit cache, 16-bit queries over int8: no chunk path) also
    with 8 query rows (the most a split-K block takes) and at a 256-token
    prefill chunk (split-K in 32 query groups of 8)."""
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.test_utils import DECODE_PAIRS

    decode_lens = [1000 - 3 * i for i in range(B)]
    rows = {}
    for q_dt, kv_dt in DECODE_PAIRS:
        name = att.decode_kernel_name(q_dt, kv_dt)
        if name in ("flash_attention_decode", "flash_attention_decode_int8"):
            continue                      # phase 3 times them
        rows[name] = dict(decode=time_decode16(q_dt, kv_dt, B, 1, 1024,
                                               decode_lens, dev))
        if kv_dt != torch.float32 and not att._has_chunk_path(q_dt, kv_dt):
            rows[name]["tq8"] = time_decode16(
                q_dt, kv_dt, B, 8, 1024, [992 - 3 * i for i in range(B)],
                dev)
            rows[name]["prefill"] = time_decode16(q_dt, kv_dt, 1, 256, 256,
                                                  [0], dev)
    rows["flash_attention_decode.bf16_bf16"]["prefill"] = time_decode16(
        torch.bfloat16, torch.bfloat16, 1, 256, 256, [0], dev)
    print("phase 35b decode kernel times: done")
    return rows


SHORT_SERVE = dict(slots=4, prompt_buckets=(32, 64),
                   capacity_buckets=(256, 512), max_new_tokens=8)


def decode_step_launches(lm, slots=8, cache_len=500):
    """Kernels a decode step of ``lm`` launches (one forward of ``slots``
    rows at capacity 1024 and ``cache_len``, as
    ``tools/torch_decode_profile.py`` runs the step): ``torch.profiler``'s
    kernel records of one step a profile, taken when two profiles in a row
    agree (late in a long process CUPTI loses records; a loss repeated to
    the record is unlikely), and the decode kernel's launches in it (the
    registry's count); None where no two agreed."""
    from mxnet_tpu_torch.kernels import registry

    cache = lm.begin_cache(slots, 1024)
    lens = np.full(slots, cache_len, np.int64)
    toks = np.zeros((slots, 1), np.int64)

    def step(_):
        with torch.inference_mode():
            lm(toks, cache, lens, np.ones(slots, np.int64))

    step(0)
    torch.cuda.synchronize()
    prev = None
    for _ in range(2 * PROFILER_TRIES):
        before = sum(v for k, v in registry.launches().items()
                     if k.startswith("flash_attention_decode"))
        rec = kernel_records(step, 1, 1)
        decode = (sum(v for k, v in registry.launches().items()
                      if k.startswith("flash_attention_decode")) - before)
        n = None if rec is None else rec[1]
        if n is not None and n == prev:
            return n, decode
        prev = n
    return None, None


def short_serve(lm, name, want, precision=None):
    """A short decode run of a model built another way (4 requests of
    16-64 tokens, 8 new tokens each): ``want``'s kernel launched 12 times
    a step and a prefill, no other decode kernel."""
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.kernels import registry

    serve.register_decode(name, lm, precision=precision, **SHORT_SERVE)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, GPT2_SMALL["vocab_size"], size=n).tolist()
               for n in rs.randint(16, 65, size=4)]
    telemetry.reset()
    registry.reset_launches()
    results = [f.result(600.0) for f in
               [serve.decode_submit(name, p) for p in prompts]]
    launches = registry.launches()
    snap = telemetry.snapshot()
    serve.shutdown_decode(120.0)
    lm.hybridize(False)
    steps = snap["serve.decode_step_seconds"]["count"]
    prefills = snap["serve.prefill_seconds"]["count"]
    others = {k: v for k, v in launches.items()
              if k.startswith("flash_attention_decode") and k != want and v}
    check(all(len(r) == SHORT_SERVE["max_new_tokens"] for r in results),
          f"{name}: a future resolved short")
    check(launches[want] >= 12 * (steps + prefills) and not others,
          f"{name}: {want} launched {launches[want]} times for {steps} steps "
          f"+ {prefills} prefills; others {others}")
    return launches[want]


def phase_serve_bf16(dev, card, f32):
    """Phase 36: GPT-2-small all in bf16 (bf16 cache) served as phase 4
    serves f32; then short runs of every other way the public API builds
    a 16-bit model, each through its pair of the decode kernel."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm
    from mxnet_tpu_torch.ops import attention as att

    bf16, f16 = torch.bfloat16, torch.float16
    t0 = time.perf_counter()
    base = xavier_init(transformer_lm(device=dev, **GPT2_SMALL), 0)
    state = base.state_dict()
    del base

    def build(dtype=torch.float32, cast=None, **kw):
        lm = transformer_lm(device=dev, dtype=dtype, **GPT2_SMALL, **kw)
        lm.load_state_dict(state)
        return lm.cast(cast) if cast is not None else lm

    lm = build(bf16, bf16)
    torch.cuda.synchronize()
    print(f"  bf16 model on {dev}: built in {time.perf_counter() - t0:.2f} "
          f"s; parameters {sorted({str(p.dtype) for p in lm.parameters()})}")
    main = "flash_attention_decode.bf16_bf16"
    run = serve_run(lm, "gpt2s_bf16", 16, seed=1)
    snap, launches = run["snap"], run["launches"]
    steps = snap["serve.decode_step_seconds"]["count"]
    prefills = snap["serve.prefill_seconds"]["count"]
    n_main = launches[main]
    check(all(len(r) == SERVE_CFG["max_new_tokens"] for r in run["results"]),
          "a bf16 future resolved short of max_new_tokens")
    check(n_main >= GPT2_SMALL["num_layers"] * (steps + prefills) and
          launches["flash_attention_decode"] == 0,
          f"{main} launches {n_main} < 12 x ({steps} steps + {prefills} "
          f"prefills), or f32 launches {launches['flash_attention_decode']}")
    tokens = sum(len(r) for r in run["results"])

    # teacher-forced logits on the card vs the port's plain path on the CPU
    seq = run["prompts"][1] + run["results"][1]
    cap = 512 if len(seq) > 256 else 256
    cpu_lm = transformer_lm(device="cpu", dtype=bf16, **GPT2_SMALL).cast(bf16)
    cpu_lm.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    gpu_logits, _ = lm(np.asarray([seq]), lm.begin_cache(1, cap), [0],
                       [len(seq)])
    cpu_logits, _ = cpu_lm(np.asarray([seq]), cpu_lm.begin_cache(1, cap),
                           [0], [len(seq)])
    del cpu_lm
    check(gpu_logits.dtype == cpu_logits.dtype == bf16, "logits not bf16")
    delta = (gpu_logits.float().cpu() - cpu_logits.float()).abs().max().item()
    scale = cpu_logits.float().abs().max().item()
    check(delta <= 2.0 ** -4 * scale, f"bf16 teacher-forced logits differ by "
          f"{delta:.3e} > 2^-4 x {scale:.3e}")
    same = total = 0
    for prompt, got in zip(run["prompts"], run["results"]):
        want = greedy_unbatched(lm, prompt, len(got))
        same += sum(a == b_ for a, b_ in zip(got, want))
        total += len(got)
    agree = same / total
    check(agree >= 0.9, f"bf16 served greedy agrees with unbatched greedy in "
          f"{agree:.3f} of positions < 0.9")
    # K and V of every layer at the largest capacity bucket
    cache_bytes = {dt: 2 * GPT2_SMALL["num_layers"] * SERVE_CFG["slots"]
                   * GPT2_SMALL["units"] * 1024
                   * torch.tensor([], dtype=dt).element_size()
                   for dt in (torch.float32, bf16)}
    ttft = snap["serve.ttft_seconds"]["p50"]
    step = snap["serve.decode_step_seconds"]["p50"]
    step_launches, step_decode = decode_step_launches(lm)
    print(f"  a decode step (8 slots, C=1024, cache_len 500): "
          f"{step_launches} kernel launches (profiler; None: every "
          f"profile lost records), {step_decode} of them the decode "
          f"kernel's")
    del lm
    # the other ways to a 16-bit model, each its own pair of the kernel
    routes = {}
    for label, kw, want, prec in (
            ("dtype=bf16 (f32 cells, bf16 cache)", dict(dtype=bf16),
             "flash_attention_decode.f32_bf16", None),
            ("cast bf16 (f32 cache)", dict(cast=bf16),
             "flash_attention_decode.bf16_f32", None),
            ("cast bf16, int8 cache", dict(dtype=bf16, cast=bf16),
             "flash_attention_decode.bf16_int8", "int8"),
            ("dtype=f16 + cast", dict(dtype=f16, cast=f16),
             "flash_attention_decode.f16_f16", None),
            ("dtype=f16", dict(dtype=f16), "flash_attention_decode.f32_f16",
             None),
            ("cast f16", dict(cast=f16), "flash_attention_decode.f16_f32",
             None),
            ("cast f16, int8 cache", dict(dtype=f16, cast=f16),
             "flash_attention_decode.f16_int8", "int8"),
            ("dtype=bf16, cast f16", dict(dtype=bf16, cast=f16),
             "flash_attention_decode.f16_bf16", None),
            ("dtype=f16, cast bf16", dict(dtype=f16, cast=bf16),
             "flash_attention_decode.bf16_f16", None)):
        lm2 = build(**kw)
        routes[want] = short_serve(lm2, f"gpt2s_{want[-9:]}", want, prec)
        print(f"  {label}: {routes[want]} launches of {want}")
        del lm2
    routes[main] = n_main
    print(f"  launches {launches} for {steps} steps + {prefills} prefills; "
          f"KV cache at 8 slots x C=1024: bf16 {cache_bytes[bf16]} B, f32 "
          f"{cache_bytes[torch.float32]} B")
    print(f"  teacher-forced bf16 logits over {len(seq)} tokens: max |gpu - "
          f"cpu| {delta:.3e} = {delta / scale:.3e} x max|logit| (bar 2^-4); "
          f"greedy agreement with the unbatched loop {agree:.4f} over "
          f"{total} positions")
    print(f"phase 36 serve bf16: {tokens} tokens in {run['wall']:.3f} s = "
          f"{tokens / run['wall']:.1f} tokens/s (f32 {f32['tokens_per_s']:.1f}"
          f"), TTFT p50 {ttft * 1e3:.2f} ms (f32 {f32['ttft_p50_ms']:.2f}), "
          f"decode step p50 {step * 1e3:.3f} ms (f32 "
          f"{f32['step_p50_ms']:.3f}), warmup {run['warm']:.2f} s [{card}]")
    return dict(tokens_per_s=tokens / run["wall"], ttft_p50_ms=ttft * 1e3,
                step_p50_ms=step * 1e3, launches=routes, steps=steps,
                prefills=prefills, step_launches=step_launches,
                step_decode_launches=step_decode, agreement=agree,
                logit_delta=delta,
                logit_rel=delta / scale,
                cache_bytes={"bf16": cache_bytes[bf16],
                             "f32": cache_bytes[torch.float32]})


def phase_bert_bf16(dev, card, f32):
    """Phase 37: phase 7's batch serving on a ``cast(torch.bfloat16)``
    BERT-base."""
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.gluon.model_zoo import bert_12_768_12
    from mxnet_tpu_torch.kernels import registry

    bf16 = torch.bfloat16
    bert = xavier_init(bert_12_768_12(dropout=0.0, device=dev, **BERT_BASE),
                       0).cast(bf16)
    t0 = time.perf_counter()
    entry = serve.register(
        "bert16", bert, bucketer=BERT_BUCKETS,
        sample=(np.zeros(32, np.int32), np.zeros(32, np.int32),
                np.asarray(32, np.int32)))
    warm = time.perf_counter() - t0
    reqs = bert_requests(BERT_REQUESTS, seed=3)
    srv = serve.Server(max_wait_ms=5, max_batch=16)
    telemetry.reset()
    registry.reset_launches()
    t0 = time.perf_counter()
    futs = [srv.submit("bert16", *r) for r in reqs]
    outs = [f.result(600.0) for f in futs]
    wall = time.perf_counter() - t0
    launches = registry.launches()
    snap = telemetry.snapshot()
    srv.close(120.0)
    serve.unregister("bert16")
    bert.hybridize(False)        # the references below run eagerly
    batches = snap["serve.batches"]["value"]
    n_flash = launches["flash_attention.bf16"]
    check(n_flash == 12 * batches, f"flash_attention.bf16 launches {n_flash} "
          f"!= 12 x {batches} batches")
    check(all(v == 0 for k, v in launches.items()
              if k != "flash_attention.bf16"),
          f"other kernels launched while serving bf16 BERT: {launches}")
    # every answer against a one-request forward on the card (bf16 GEMMs
    # of another shape: another summation order)
    worst, units = 0.0, bert.pooler.weight.shape[0]
    for (tok, seg, vl), (seq, pooled) in zip(reqs, outs):
        t = int(vl)
        check(seq.shape == (t, units) and pooled.shape == (units,),
              f"answer shapes {seq.shape}, {pooled.shape} for T={t}")
        with torch.inference_mode():
            ref_seq, ref_pooled = bert(tok[None], seg[None], np.asarray([t]))
        for got, want in ((seq, ref_seq[0]), (pooled, ref_pooled[0])):
            want = want.float().cpu().numpy()
            err = float(np.abs(got - want).max())
            top = float(np.abs(want).max())
            check(np.isfinite(got).all() and err <= 2.0 ** -4 * top,
                  f"bf16 answer off by {err:.3e} > 2^-4 x {top:.3e} (T={t})")
            worst = max(worst, err / top)
    # a padded batch on the card vs the port's bf16 plain path on the CPU
    batch, _, _ = entry.pad_requests(reqs[1:3])
    cpu_bert = bert_12_768_12(dropout=0.0, device="cpu", **BERT_BASE).cast(bf16)
    cpu_bert.load_state_dict({k: v.cpu() for k, v in bert.state_dict().items()})
    with torch.inference_mode():
        gpu_out = [x.float().cpu().numpy() for x in bert(*batch)]
        cpu_out = [x.float().numpy() for x in cpu_bert(*batch)]
    del cpu_bert
    cpu_err = 0.0
    for g_, c_ in zip(gpu_out, cpu_out):
        delta = float(np.abs(g_ - c_).max())
        top = float(np.abs(c_).max())
        check(delta <= 2.0 ** -4 * top, f"bf16 padded batch "
              f"{batch[0].shape}: card vs CPU {delta:.3e} > 2^-4 x {top:.3e}")
        cpu_err = max(cpu_err, delta / top)
    e2e = snap["serve.e2e_seconds"]
    occupancy = snap["serve.rows"]["value"] / snap["serve.padded_rows"]["value"]
    print(f"  launches {launches} for {batches} batches (12 layers each); "
          f"warmup {entry.warmed} shapes in {warm:.2f} s")
    print(f"  answers vs one-request forwards: max err {worst:.3e} x max|ref|"
          f" (bar 2^-4); padded batch {batch[0].shape} card vs CPU bf16 "
          f"{cpu_err:.3e} x max|cpu| (bar 2^-4)")
    print(f"phase 37 serve BERT-base bf16: {BERT_REQUESTS} requests in "
          f"{wall:.3f} s = {BERT_REQUESTS / wall:.1f} requests/s (f32 "
          f"{f32['requests_per_s']:.1f}), e2e p50 {e2e['p50'] * 1e3:.2f} ms "
          f"(f32 {f32['e2e_p50_ms']:.2f}), p99 {e2e['p99'] * 1e3:.2f} ms (f32 "
          f"{f32['e2e_p99_ms']:.2f}), {batches} batches, mean batch occupancy "
          f"{occupancy:.4f} (f32 {f32['occupancy']:.4f}) [{card}]")
    return dict(requests_per_s=BERT_REQUESTS / wall,
                e2e_p50_ms=e2e["p50"] * 1e3, e2e_p99_ms=e2e["p99"] * 1e3,
                batches=batches, occupancy=occupancy, launches=n_flash,
                answer_rel_err=worst, cpu_rel_err=cpu_err, warm_s=warm)


INFER_BATCHES = (32, 128)     # bench.py's resnet50_b32 and resnet50_b128
INFER_STEPS = 20


def score_run(net, x):
    """``bench.py``'s scoring loop: one f32 sum of the logits a batch,
    read once at the end; img/s over ``INFER_STEPS`` batches after 3
    warm ones, and the peak device memory."""
    with torch.inference_mode():
        for _ in range(3):
            float(net(x).float().sum())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        acc = None
        for _ in range(INFER_STEPS):
            acc = net(x).float().sum()
        float(acc)
        wall = time.perf_counter() - t0
    return dict(img_per_s=x.shape[0] * INFER_STEPS / wall,
                ms_per_batch=wall / INFER_STEPS * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_resnet_infer(dev, card):
    """Phase 38: ResNet-50 v1 scoring as ``bench.py --infer`` runs
    ``resnet50_b32`` and ``resnet50_b128``: NHWC, f32, then cast to bf16
    with a bf16 input from ``RandomState(0)``; then a small batch on the
    card against the CPU at phase 30's rule."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.kernels import registry

    bf16 = torch.bfloat16
    net = xavier_init(get_model("resnet50_v1", layout="NHWC", device=dev), 0)
    rows = {}
    registry.reset_launches()
    for label in ("f32", "bf16"):
        if label == "bf16":
            net.cast(bf16)
        for b in INFER_BATCHES:
            x = torch.from_numpy(np.random.RandomState(0).rand(
                b, 224, 224, 3).astype(np.float32)).to(dev)
            if label == "bf16":
                x = x.to(bf16)
            rows[f"{label}_b{b}"] = r = score_run(net, x)
            print(f"  {label} B={b}: {r['img_per_s']:.1f} img/s, "
                  f"{r['ms_per_batch']:.3f} ms a batch, peak "
                  f"{r['peak_gib']:.2f} GiB")
            del x
    launched = {k: v for k, v in registry.launches().items() if v}
    check(not launched, f"scoring launched the port's kernels: {launched}")
    check(all(p.dtype == bf16 for p in net.parameters()) and
          all(b_.dtype == bf16 for b_ in net.buffers()),
          "the cast left a parameter or running statistic in f32")
    # a small batch on the card against the CPU (phase 30's rule)
    xs = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    cpu32 = get_model("resnet50_v1", layout="NHWC", device="cpu")
    cpu32.load_state_dict({k: v.float().cpu()
                           for k, v in net.state_dict().items()})
    with torch.inference_mode():
        got = net(torch.from_numpy(xs).to(dev).to(bf16)).float().cpu()
        ref32 = cpu32(torch.from_numpy(xs))
        ref16 = cpu32.cast(bf16)(torch.from_numpy(xs).to(bf16)).float()
    own = (ref16 - ref32).abs().max().item()
    delta = (got - ref16).abs().max().item()
    bar = max(2.0 ** -4 * ref16.abs().max().item(), 3 * own)
    check(bool(torch.isfinite(got).all()) and delta <= bar,
          f"bf16 scores card vs CPU {delta:.3e} > {bar:.3e}")
    print(f"  B=2 64x64 card vs CPU bf16 scores: {delta:.3e} (bar {bar:.3e}: "
          f"the larger of 2^-4 x max|cpu| and 3 x the CPU's own bf16-f32 "
          f"distance {own:.3e})")
    print(f"phase 38 ResNet-50 scoring: bf16 "
          f"{rows['bf16_b32']['img_per_s']:.1f} img/s at B=32, "
          f"{rows['bf16_b128']['img_per_s']:.1f} at B=128; f32 "
          f"{rows['f32_b32']['img_per_s']:.1f} and "
          f"{rows['f32_b128']['img_per_s']:.1f} [{card}]")
    rows["card_vs_cpu"] = dict(delta=delta, bar=bar, cpu_bf16_vs_f32=own)
    return rows


# ------------------------------------ the verify skill's drive, as written
LENET_DRIVE = dict(batch=64, steps=120, val_batch=256, profiled=8)


def timer_total(name):
    from mxnet_tpu_torch import telemetry

    return telemetry.snapshot().get(name, {}).get("total", 0.0)


def lenet_drive(num_workers, pin_memory, card, hybridize=True, **loader):
    """The verify skill's canonical drive with ``import mxnet_tpu_torch
    as mx``: seed 42,
    ``DataLoader(MNIST(train=True).transform_first(ToTensor()),
    batch_size=64, shuffle=True)``, LeNet-5 initialized by
    ``mx.init.Xavier()``, sgd lr 0.05 momentum 0.9, ``record()`` ->
    ``loss.backward()`` -> ``step(64)`` for 120 batches; then accuracy
    over ``MNIST(train=False)`` at batch 256 through
    ``mx.gluon.metric.Accuracy``; then the epoch's last batches under the
    profiler for the busy share.  ``loader``: more ``DataLoader``
    arguments (``tools/torch_loader_drive.py``)."""
    import itertools

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import MNIST, transforms
    from mxnet_tpu_torch.kernels import registry

    steps, b = LENET_DRIVE["steps"], LENET_DRIVE["batch"]
    mx.random.seed(42)
    train_set, val_set = MNIST(train=True), MNIST(train=False)
    train = DataLoader(train_set.transform_first(transforms.ToTensor()),
                       batch_size=b, shuffle=True, num_workers=num_workers,
                       pin_memory=pin_memory, **loader)
    val = DataLoader(val_set.transform_first(transforms.ToTensor()),
                     batch_size=LENET_DRIVE["val_batch"],
                     num_workers=num_workers, pin_memory=pin_memory, **loader)
    net = mx.gluon.model_zoo.get_model('lenet')
    net.initialize(mx.init.Xavier()); net.hybridize(hybridize)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), 'sgd',
                               {'learning_rate': 0.05, 'momentum': 0.9})
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    firsts, losses = [], []
    torch.cuda.synchronize()
    registry.reset_launches()
    wait0 = timer_total("dataloader.wait_seconds")
    t0 = time.perf_counter()
    batches = iter(train)
    for i, (x, y) in enumerate(itertools.islice(batches, steps)):
        starts[i].record()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward(); trainer.step(x.shape[0])
        ends[i].record()
        losses.append(loss.detach().mean())
        if i == 0:
            firsts = [x, y]
            t1 = time.perf_counter()      # a pool's start is paid by now
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t0
    wait = timer_total("dataloader.wait_seconds") - wait0
    launches = {k: v for k, v in registry.launches().items() if v}
    x, y = firsts
    check(x.device == torch.device("cuda", 0) and x.dtype == torch.float32
          and tuple(x.shape) == (b, 1, 28, 28)
          and 0.0 <= float(x.min()) and float(x.max()) <= 1.0,
          f"drive batch: {x.device} {x.dtype} {tuple(x.shape)}")
    check(y.device == x.device and y.dtype == torch.int32
          and tuple(y.shape) == (b,), f"drive labels: {y.device} {y.dtype}")
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), "drive: non-finite loss")
    check(not launches, f"the LeNet drive launched the port's kernels: "
          f"{launches}")
    acc = mx.gluon.metric.Accuracy()
    for vx, vy in val:
        acc.update(vy, net(vx))
    name, value = acc.get()
    check(acc.num_inst == len(val_set) and value > 0.95,
          f"drive: {name} {value} over {acc.num_inst} held-out images")

    def step():
        x, y = next(batches)
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward(); trainer.step(x.shape[0])

    prof = profile_steps(step, LENET_DRIVE["profiled"])
    train.close()
    val.close()
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    out = dict(num_workers=num_workers, pin_memory=pin_memory, **loader,
               synthetic=[train_set.synthetic, val_set.synthetic],
               img_per_s=b * steps / wall,
               first_step_s=t1 - t0,
               img_per_s_after_first=b * (steps - 1) / (t_end - t1),
               step_p50_ms=statistics.median(step_ms),
               wall_ms_per_step=wall * 1e3 / steps,
               loader_wait_share=wait / wall, loader_wait_s=wait,
               accuracy=float(value), val_images=acc.num_inst,
               loss_first=vals[0], loss_last=vals[-1], losses=vals,
               hybridized=hybridize, busy_share=prof["busy_share"],
               launches_per_step=prof["launches"],
               device_busy_ms_per_step=prof["device_busy_ms"])
    print(f"  num_workers={num_workers}, pin_memory={pin_memory}: MNIST "
          f"synthetic (train, test) = {tuple(out['synthetic'])}; "
          f"{out['img_per_s']:.1f} img/s over {steps} steps "
          f"({out['img_per_s_after_first']:.1f} after the first, which "
          f"took {out['first_step_s'] * 1e3:.1f} ms), step p50 "
          f"{out['step_p50_ms']:.3f} ms (CUDA events), loader wait share "
          f"{out['loader_wait_share']:.4f}, busy share "
          f"{out['busy_share']:.4f} ({LENET_DRIVE['profiled']} profiled "
          f"steps), loss {vals[0]:.4f} -> {vals[-1]:.4f}, {name} "
          f"{value:.4f} on {acc.num_inst} images [{card}]")
    return out


def phase_lenet_drive(dev, card):
    """Phase 39: the verify skill's drive twice, with ``num_workers=0``
    and with ``num_workers=2, pin_memory=True``."""
    runs = {"workers0": lenet_drive(0, False, card),
            "workers2_pinned": lenet_drive(2, True, card)}
    print(f"phase 39 verify skill's LeNet drive as written (B=64, 120 "
          f"steps, val batch 256): " + "; ".join(
              f"{k} {r['img_per_s']:.1f} img/s, step p50 "
              f"{r['step_p50_ms']:.3f} ms, wait share "
              f"{r['loader_wait_share']:.4f}, accuracy {r['accuracy']:.4f}"
              for k, r in runs.items()) + f" [{card}]")
    return runs


# ------------------------------------------------ the LSTM family (A3)
RNN_OPS = dict(t=35, b=16, c=128, h=128, layers=2)
RNN_MODES = ("lstm", "gru", "rnn_relu", "rnn_tanh")
LSTM_LM = dict(vocab=10000, embed=650, hidden=650, layers=2, batch=64,
               seq=35, steps=20, profiled=3, cpu_steps=3)
LSTM_SERVE = dict(slots=8, prompt_buckets=(8, 16, 32),
                  capacity_buckets=(32, 64), max_new_tokens=40)
LSTM_REQUESTS = 512
LSTM_ARRIVALS_PER_S = 400        # above what 8 slots serve: they stay full
LSTM_TIE = 1e-4                  # a served token off the eager argmax must
                                 # trail it by <= this x max|logit|


def rnn_case(mode, bidir, seed):
    """Phase 40's inputs (numpy, from ``seed``): x, the flat parameters,
    h0, c0, per-row lengths (one full row) and a head gradient for each
    output."""
    from mxnet_tpu_torch.ops import rnn as ops_rnn

    c = RNN_OPS
    rs = np.random.RandomState(seed)
    d = 2 if bidir else 1
    n = ops_rnn.param_size(mode, c["c"], c["h"], c["layers"], bidir)
    state = (c["layers"] * d, c["b"], c["h"])
    lens = rs.randint(1, c["t"] + 1, size=c["b"]).astype(np.int32)
    lens[0] = c["t"]
    return dict(x=rs.uniform(-1, 1, (c["t"], c["b"], c["c"])).astype("f4"),
                params=rs.uniform(-0.15, 0.15, n).astype("f4"),
                h0=rs.uniform(-0.5, 0.5, state).astype("f4"),
                c0=rs.uniform(-0.5, 0.5, state).astype("f4"), lens=lens,
                heads=[rs.uniform(-1, 1, s).astype("f4") for s in
                       ((c["t"], c["b"], d * c["h"]), state, state)])


def rnn_run(v, mode, bidir, seq, where):
    """``ops.rnn.rnn_fused`` on ``v`` at ``where``, then the gradients of
    sum(out * head) over its inputs: the outputs and gradients on the
    CPU."""
    from mxnet_tpu_torch.ops import rnn as ops_rnn

    lstm = mode == "lstm"
    names = ("x", "params", "h0") + (("c0",) if lstm else ())
    ts = {k: torch.tensor(v[k], device=where, requires_grad=True)
          for k in names}
    outs = ops_rnn.rnn_fused(
        ts["x"], ts["params"], ts["h0"], ts.get("c0"), mode=mode,
        state_size=RNN_OPS["h"], num_layers=RNN_OPS["layers"],
        bidirectional=bidir,
        sequence_length=torch.tensor(v["lens"], device=where),
        use_sequence_length=seq)
    grads = torch.autograd.grad(
        sum((o * torch.tensor(h, device=where)).sum()
            for o, h in zip(outs, v["heads"])), [ts[k] for k in names])
    return [t.detach().cpu() for t in list(outs) + list(grads)]


def phase_rnn_ops(dev):
    """Phase 40: ``rnn_fused`` in every mode, 2 layers, one and two
    directions, with and without per-row lengths, forward and gradients,
    on the card against the same code on the CPU from the same inputs:
    each output and gradient within 1e-4 x its max|ref| (TF32 off)."""
    worst, n = 0.0, 0
    t0 = time.perf_counter()
    for i, mode in enumerate(RNN_MODES):
        for bidir in (False, True):
            for seq in (False, True):
                v = rnn_case(mode, bidir, seed=40 + 4 * i + 2 * bidir + seq)
                card = rnn_run(v, mode, bidir, seq, dev)
                cpu = rnn_run(v, mode, bidir, seq, "cpu")
                for g, c in zip(card, cpu):
                    err = (g - c).abs().max().item()
                    scale = c.abs().max().item()
                    check(err <= 1e-4 * scale,
                          f"rnn_fused {mode} bidir={bidir} seq={seq}: card "
                          f"vs CPU {err:.3e} > 1e-4 x {scale:.3e}")
                    worst = max(worst, err / scale)
                n += 1
    c = RNN_OPS
    print(f"phase 40 recurrent ops card vs CPU: {n} cases ({RNN_MODES}, "
          f"{c['layers']} layers, one and two directions, with and without "
          f"lengths; T={c['t']}, B={c['b']}, C={c['c']}, H={c['h']}), "
          f"outputs and gradients within {worst:.3e} x max|ref| (bar 1e-4) "
          f"in {time.perf_counter() - t0:.2f} s")
    return dict(cases=n, worst_rel_err=worst)


def bench_lstm_lm_net(**kw):
    """``bench.py``'s ``bench_lstm_lm`` net with ``import mxnet_tpu_torch
    as mx`` at BASELINE config #4's widths: ``mx.random.seed(0)``, the
    layers built with no device (so on ``cuda:0``) unless ``kw`` names
    one, ``initialize(mx.init.Xavier())``.  The port takes the widths at
    construction (``input_size``, ``in_units``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn, rnn

    c = LSTM_LM

    class LSTMLM(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(c["vocab"], c["embed"], **kw)
            self.lstm = rnn.LSTM(c["hidden"], num_layers=c["layers"],
                                 input_size=c["embed"], **kw)
            self.decoder = nn.Dense(c["vocab"], flatten=False,
                                    in_units=c["hidden"], **kw)

        def forward(self, x):          # (B, T) tokens
            e = self.embedding(x).transpose(0, 1)      # TNC for the RNN
            out = self.lstm(e)                          # (T, B, H)
            return self.decoder(out).transpose(0, 1)    # (B, T, V)

    mx.random.seed(0)
    net = LSTMLM()
    net.initialize(mx.init.Xavier())
    return net


def lstm_lm_loss(pred, y):
    """The bench's loss: log-softmax in f32, the NLL pick, the mean over T."""
    lp = torch.log_softmax(pred.float(), -1)
    return (-lp.gather(-1, y.long()[..., None])[..., 0]).mean(-1)


def lstm_yardstick(dev):
    """``torch.nn.LSTM`` (``torch._VF.lstm``: cuDNN) at the config's shape,
    forward and forward + backward, beside the port's ``rnn_fused`` on
    the same weights and input: device times (profiler) and CUDA-event
    times; the two outputs held within 1e-4 x max|cuDNN| first.  A
    yardstick only: the port never calls cuDNN's RNN."""
    from mxnet_tpu_torch.ops import rnn as ops_rnn

    c = LSTM_LM
    gen = torch.Generator(device="cpu").manual_seed(41)
    lstm = torch.nn.LSTM(c["embed"], c["hidden"], c["layers"]).to(dev)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) * 0.08 - 0.04)
    shape = (c["seq"], c["batch"], c["embed"])
    xs = [(torch.rand(shape, generator=gen) * 2 - 1).to(dev).requires_grad_()
          for _ in range(2)]
    gout = (torch.rand(c["seq"], c["batch"], c["hidden"], generator=gen)
            * 2 - 1).to(dev)
    h0 = torch.zeros(c["layers"], c["batch"], c["hidden"], device=dev)
    per_layer = [tuple(getattr(lstm, f"{w}_l{i}") for w in
                       ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
                 for i in range(c["layers"])]
    params = list(lstm.parameters())

    def cudnn(i):
        return lstm(xs[i], (h0, h0))[0]

    def ours(i):
        return ops_rnn.rnn_fused(xs[i], per_layer, h0, h0, mode="lstm",
                                 state_size=c["hidden"],
                                 num_layers=c["layers"])[0]

    want, got = cudnn(0), ours(0)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-4 * scale, f"rnn_fused vs cuDNN LSTM {err:.3e} > "
          f"1e-4 x {scale:.3e}")
    out = dict(shape=f"T={c['seq']}, B={c['batch']}, {c['embed']} -> "
                     f"{c['hidden']}, {c['layers']} layers, f32, TF32 off",
               ours_vs_cudnn_max_abs_err=err)
    for name, fn in (("cudnn", cudnn), ("ours", ours)):
        def both(i, fn=fn):
            torch.autograd.grad(fn(i), [xs[i]] + params, gout)
        fwd = device_ms_per_call(fn, 2, calls=5)
        fb = device_ms_per_call(both, 2, calls=5)
        out[name] = dict(fwd_device_ms=fwd, bwd_device_ms=fb - fwd,
                         fwd_bwd_device_ms=fb,
                         fwd_events_ms=cuda_time_ms(fn, 2, iters=5, reps=3),
                         fwd_bwd_events_ms=cuda_time_ms(both, 2, iters=5,
                                                        reps=3))
    return out


def phase_lstm_lm(dev, card):
    """Phase 41: BASELINE config #4 as ``bench_lstm_lm`` runs it (module
    docstring)."""
    from mxnet_tpu_torch.parallel import ShardedTrainer

    c = LSTM_LM
    t0 = time.perf_counter()
    net = bench_lstm_lm_net()
    devices = {p.device for p in net.parameters()}
    check(devices == {torch.device("cuda", 0)},
          f"a net built with no device landed on {devices}, not cuda:0")
    tr = ShardedTrainer(net, lstm_lm_loss, optimizer="sgd",
                        learning_rate=1.0)
    check(tr.uses_arena, "the trainer did not pick the arena adapter")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"  bench_lstm_lm's net on {dev}: {n_params} parameters, built in "
          f"{time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(0)
    x = rs.randint(0, c["vocab"], size=(c["batch"], c["seq"])).astype("int32")
    y = rs.randint(0, c["vocab"], size=(c["batch"], c["seq"])).astype("int32")
    steps = c["steps"]
    losses, p50, wall, launches, peak = timed_steps(tr, x, y, dev, steps)
    check(launches["opt_arena"] == steps,
          f"opt_arena: {launches['opt_arena']} launches in {steps} steps, "
          "want 1 a step")
    others = {k: v for k, v in launches.items() if v and k != "opt_arena"}
    check(not others, f"other port kernels launched: {others}")
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"loss did not fall: {vals[0]} -> {vals[-1]}")
    prof = profile_steps(lambda: tr.step(x, y), c["profiled"])
    tps = c["batch"] * c["seq"] * steps / wall
    del tr, net

    # card vs CPU: cpu_steps steps at the same widths from one seed
    runs = {}
    for where, kw in ((dev, {}), ("cpu", {"device": "cpu"})):
        net = bench_lstm_lm_net(**kw)
        tr = ShardedTrainer(net, lstm_lm_loss, optimizer="sgd",
                            learning_rate=1.0)
        runs[str(where)] = ([tr.step(x, y, block=True)
                             for _ in range(c["cpu_steps"])],
                            {n: p.detach().cpu().clone()
                             for n, p in net.named_parameters()})
        del tr, net
    (gl, gw), (cl, cw) = runs[str(dev)], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    check(loss_rel <= 1e-4, f"losses card {gl} vs CPU {cl}: rel "
          f"{loss_rel:.3e} > 1e-4")
    w_worst, w_name = 0.0, ""
    for name, w in cw.items():
        scale = w.abs().max().item()
        err = (gw[name] - w).abs().max().item()
        check(err <= 1e-4 * scale, f"weight {name}: card vs CPU {err:.3e} > "
              f"1e-4 x {scale:.3e}")
        if err / scale > w_worst:
            w_worst, w_name = err / scale, name
    yard = lstm_yardstick(dev)
    print(f"  port kernel launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; "
          f"{prof['launches']:.0f} CUDA kernels a step, busy share "
          f"{prof['busy_share']:.4f} ({c['profiled']} profiled steps)")
    print(f"  loss {vals[0]:.4f} (step 1) -> {vals[-1]:.4f} (step "
          f"{len(vals)}); card vs CPU over {c['cpu_steps']} steps: losses "
          f"within {loss_rel:.3e} relative, weights within {w_worst:.3e} x "
          f"max|w| ({w_name})")
    for name in ("cudnn", "ours"):
        r = yard[name]
        print(f"  {name} LSTM at {yard['shape']}: forward "
              f"{r['fwd_device_ms']:.3f} ms, backward "
              f"{r['bwd_device_ms']:.3f} ms device time; forward "
              f"{r['fwd_events_ms']:.3f} ms, forward + backward "
              f"{r['fwd_bwd_events_ms']:.3f} ms by events")
    print(f"phase 41 train bench_lstm_lm (vocab {c['vocab']}, "
          f"{c['embed']}/{c['hidden']} x {c['layers']}, B={c['batch']}, "
          f"T={c['seq']}, sgd lr 1.0): lstm_lm_tokens_per_sec_per_chip "
          f"{tps:.2f}, step p50 {p50:.3f} ms (CUDA events), wall "
          f"{wall * 1e3 / steps:.3f} ms per step, peak "
          f"{peak / 2**30:.2f} GiB [{card}]")
    return dict(lstm_lm_tokens_per_sec_per_chip=tps, step_p50_ms=p50,
                wall_ms_per_step=wall * 1e3 / steps, steps=steps,
                launches={k: v for k, v in launches.items() if v},
                launches_per_step=prof["launches"],
                busy_share=prof["busy_share"],
                device_busy_ms_per_step=prof["device_busy_ms"],
                loss_first=vals[0], loss_last=vals[-1], peak_bytes=peak,
                card_vs_cpu=dict(loss_rel_err=loss_rel,
                                 weight_rel_err=w_worst),
                yardstick=yard)


def eager_divergence(lm, prompt, got):
    """Hold a served answer to the eager greedy loop: the prompt's forward,
    then one-row steps, each taking the eager argmax.  None where every
    token agrees, else (position, eager top logit minus the served token's
    eager logit, max|logit|) at the first token that differs."""
    with torch.no_grad():
        logits, cache = lm(np.asarray([prompt]), lm.begin_cache(1), [0],
                           [len(prompt)])
        row = logits[0, -1]
        for k, tok in enumerate(got):
            want = int(row.argmax())
            if want != tok:
                return (k, float(row[want] - row[tok]),
                        float(row.abs().max()))
            if k + 1 < len(got):
                logits, cache = lm(np.asarray([[want]]), cache, [0], [1])
                row = logits[0, 0]
    return None


def lstm_traffic(rs):
    """Phase 42's requests: prompt lengths uniform over the prompt
    buckets' range, token ids uniform over the vocabulary, Poisson
    arrival offsets (seconds) at ``LSTM_ARRIVALS_PER_S``."""
    n, top = LSTM_REQUESTS, LSTM_SERVE["prompt_buckets"][-1]
    lengths = rs.randint(1, top + 1, size=n)
    prompts = [rs.randint(0, LSTM_LM["vocab"], size=k).tolist()
               for k in lengths]
    arrivals = np.cumsum(rs.exponential(1.0 / LSTM_ARRIVALS_PER_S, size=n))
    return prompts, arrivals - arrivals[0]


def phase_lstm_serve(dev, card):
    """Phase 42: ``LSTMLM`` (vocab 10,000, 650 units, 2 layers) behind
    ``serve.register_decode`` (module docstring)."""
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.model_zoo import LSTMLM
    from mxnet_tpu_torch.kernels import registry

    lm = xavier_init(LSTMLM(vocab_size=LSTM_LM["vocab"],
                            units=LSTM_LM["hidden"],
                            num_layers=LSTM_LM["layers"]), 0)
    check(lm.device == torch.device("cuda", 0), f"LSTMLM on {lm.device}")
    try:
        serve.register_decode("lstm_int8", lm, precision="int8",
                              **LSTM_SERVE)
        refused = ""
    except MXNetError as err:
        refused = str(err)
    check("LSTM carrier" in refused, "precision='int8' did not refuse the "
          f"LSTM carrier: {refused!r}")
    t0 = time.perf_counter()
    entry = serve.register_decode("lstm_lm", lm, **LSTM_SERVE)
    warm = time.perf_counter() - t0
    check(entry.capacity_static, "the LSTM cache was not found "
          "capacity-static")
    prompts, arrivals = lstm_traffic(np.random.RandomState(42))
    n_new = LSTM_SERVE["max_new_tokens"]
    check(max(map(len, prompts)) + n_new > LSTM_SERVE["capacity_buckets"][-1],
          "no request passes the last capacity bucket")
    telemetry.reset()
    registry.reset_launches()
    futs = []
    t0 = time.perf_counter()
    for p, at in zip(prompts, arrivals):
        lag = t0 + at - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        futs.append(serve.decode_submit("lstm_lm", p))
    results = [f.result(600.0) for f in futs]
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in registry.launches().items() if v}
    snap = telemetry.snapshot()
    truncated = [f.truncated for f in futs]
    pending = np.zeros(entry.slots, np.int64)
    lens = np.zeros(entry.slots, np.int64)
    cache = entry.batch_cache(entry.capacity_buckets[0])    # captured
    prof = profile_steps(lambda: entry.step(pending, cache, lens), 5)
    serve.shutdown_decode(120.0)
    lm.hybridize(False)          # the eager loop below runs eagerly
    check(all(len(r) == n_new for r in results) and not any(truncated),
          "a request resolved short of max_new_tokens or truncated")
    grows = snap.get("serve.cache_grows", {"value": 0})["value"]
    check(grows == 0, f"serve.cache_grows {grows} for a capacity-static cache")
    check(not launches, f"the LSTM decode path launched port kernels: "
          f"{launches}")
    t1 = time.perf_counter()
    ties = []
    for i, (prompt, got) in enumerate(zip(prompts, results)):
        div = eager_divergence(lm, prompt, got)
        if div is None:
            continue
        k, gap, scale = div
        check(gap <= LSTM_TIE * scale, f"request {i} (prompt of "
              f"{len(prompt)}): served token {k} differs from the eager "
              f"loop's by {gap:.3e} of logit > {LSTM_TIE} x {scale:.3e}")
        ties.append((i, k, gap / scale))
    check(len(ties) * 100 <= LSTM_REQUESTS, f"{len(ties)} of "
          f"{LSTM_REQUESTS} answers leave the eager loop at near ties: {ties}")
    check_s = time.perf_counter() - t1
    tokens = sum(len(r) for r in results)
    steps = snap["serve.decode_step_seconds"]["count"]
    prefills = snap["serve.prefill_seconds"]["count"]
    occupancy = (snap["serve.tokens"]["value"] - prefills) / steps
    step = snap["serve.decode_step_seconds"]
    ttft = snap["serve.ttft_seconds"]
    pre = snap["serve.prefill_seconds"]
    print(f"  {LSTM_REQUESTS} requests (prompts of 1-"
          f"{LSTM_SERVE['prompt_buckets'][-1]} tokens, {n_new} new each, "
          f"Poisson arrivals at {LSTM_ARRIVALS_PER_S}/s over "
          f"{arrivals[-1]:.3f} s) into {entry.slots} slots: {steps} steps "
          f"with {occupancy:.3f} rows each on average, {prefills} prefills; "
          f"{LSTM_REQUESTS - len(ties)} answers equal the eager greedy "
          f"loop's, {len(ties)} leave it at a near tie {ties} (checked in "
          f"{check_s:.2f} s); cache grows {grows}; {prof['launches']:.0f} "
          f"CUDA kernels a decode step, busy share "
          f"{prof['busy_share']:.4f}; int8 refused")
    print(f"phase 42 serve LSTMLM (vocab {LSTM_LM['vocab']}, "
          f"{LSTM_LM['hidden']} units, {LSTM_LM['layers']} layers): "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s "
          f"with the slots kept full, decode step p50 "
          f"{step['p50'] * 1e3:.3f} ms (mean "
          f"{step['total'] / steps * 1e3:.3f}), prefill p50 "
          f"{pre['p50'] * 1e3:.3f} ms, TTFT p50 {ttft['p50'] * 1e3:.2f} ms "
          f"and p99 {ttft['p99'] * 1e3:.2f} ms (queueing included), warmup "
          f"{warm:.2f} s [{card}]")
    return dict(tokens_per_s=tokens / wall, wall_s=wall, tokens=tokens,
                requests=LSTM_REQUESTS,
                arrivals_per_s=LSTM_ARRIVALS_PER_S,
                mean_rows_per_step=occupancy,
                step_p50_ms=step["p50"] * 1e3,
                step_mean_ms=step["total"] / steps * 1e3,
                prefill_p50_ms=pre["p50"] * 1e3,
                ttft_p50_ms=ttft["p50"] * 1e3, ttft_p99_ms=ttft["p99"] * 1e3,
                steps=steps, prefills=prefills, eager_equal=LSTM_REQUESTS
                - len(ties), near_ties=ties, cache_grows=grows,
                launches_per_step=prof["launches"],
                busy_share=prof["busy_share"], warmup_s=warm)


# -------------------------------- SSD-ResNet50 and the losses (A8, A1.4.8)
SSD = dict(batch=32, image=512, classes=20, warm=2, steps=10, profiled=3,
           cpu_batch=2, cpu_image=128, cpu_steps=3)
SSD_DRIVE_STEPS = 8              # tests/test_boxes.py's drive
BOX_TOL = 1e-6                   # x max|ref|: box ops, card vs CPU
LOSS_TOL = 1e-5                  # x max|ref|: losses and their gradients
LSTM_LM_PARAMS = 19_780_400      # bench_lstm_lm's net (phase 41)
# the SSD step's split of device time, first match wins (else
# "elementwise and reductions"): tools/torch_decode_profile.py's words
SSD_GROUPS = {
    "opt_arena": lambda k: "opt_arena_kernel" in k,
    "convolutions and GEMMs": lambda k: any(w in k.lower() for w in (
        "conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit", "winograd",
        "xmma", "gemm", "fft", "cutlass", "nvjet")),
}


def phase_boxes(dev):
    """Phase 43: every ``ops.boxes`` operator of the SSD path on the card
    against the same code on the CPU (``test_utils.box_op_runs`` at an
    SSD-512 batch's size: 16 images, NMS over 1,360 rows, topk 800):
    masks, classes, matched indices and NMS ids and fill equal, floats
    within ``BOX_TOL`` x max|ref|; the colliding forced match gives the
    last gt index every call; then the NMS time at that size."""
    from mxnet_tpu_torch.test_utils import box_exact_parts, box_op_runs

    t0 = time.perf_counter()
    runs = box_op_runs(seed=43, scale=8)
    worst = {}
    for op, run in runs.items():
        got, want = run(dev), run("cpu")
        for g, w in zip(box_exact_parts(op, got), box_exact_parts(op, want)):
            check(torch.equal(g, w), f"box op {op}: an exact output differs "
                  "between the card and the CPU")
        err = 0.0
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"box op {op}: {g.dtype} {tuple(g.shape)} on the card, "
                  f"{w.dtype} {tuple(w.shape)} on the CPU")
            scale = max(w.double().abs().max().item(), 1e-30)
            e = (g.double() - w.double()).abs().max().item() / scale
            check(e <= BOX_TOL, f"box op {op}: card vs CPU {e:.3e} x max|ref|"
                  f" > {BOX_TOL}")
            err = max(err, e)
        worst[op] = err
    for _ in range(5):
        _, _, cls_t = runs["multibox_target_colliding"](dev)
        check(cls_t[0, 0].item() == 8.0 and cls_t[1, 1].item() == 4.0,
              f"forced match: anchors took {cls_t.tolist()}, want the last "
              "gt index (classes 7 and 3)")
    nms_ms = cuda_time_ms(lambda i: runs["box_nms"](dev), 1, iters=3, reps=3)
    print(f"phase 43 box ops card vs CPU: {len(runs)} ops "
          f"({', '.join(runs)}) exact parts equal, floats within "
          f"{max(worst.values()):.3e} x max|ref| (bar {BOX_TOL}); forced "
          f"match takes the last gt 5 of 5 calls; box_nms over 16 x 1,360 "
          f"rows (topk 800) {nms_ms:.3f} ms (CUDA events, with the copy "
          f"back) in {time.perf_counter() - t0:.2f} s")
    return dict(worst_rel_err=worst, nms_ms=nms_ms)


def bench_ssd_loss(pred, y):
    """``bench_ssd``'s loss in PyTorch: f32 log-softmax, the class pick,
    L1 under the mask, each the mean over the anchors."""
    cls_preds, box_preds, _anchors = pred
    cls_t, box_t, box_m = y
    lp = torch.log_softmax(cls_preds.float(), -1)
    cls_l = -lp.gather(-1, cls_t.long()[..., None])[..., 0]
    box_l = (box_preds.float() - box_t).abs() * box_m
    return cls_l.mean(-1) + box_l.mean(-1)


def bench_ssd_batch(net, batch, image, dev):
    """``bench_ssd``'s data: the anchors from a forward on zeros, then
    ``RandomState(0)`` images and one synthetic box an image (padded
    label rows -1), and the targets from ``training_targets``: ``(x,
    (cls_t, box_t, box_m), labels)`` on ``dev``."""
    from mxnet_tpu_torch.gluon.model_zoo.ssd import training_targets

    with torch.no_grad():
        _, _, anchors = net(torch.zeros((2, 3, image, image), device=dev))
    rs = np.random.RandomState(0)
    x = np.asarray(rs.rand(batch, 3, image, image), np.float32)
    ncls = net.num_classes
    labels = np.full((batch, 3, 5), -1.0, "float32")
    labels[:, 0, 0] = rs.randint(0, ncls, size=batch)
    xy = rs.rand(batch, 2) * 0.5
    labels[:, 0, 1:3] = xy
    labels[:, 0, 3:5] = xy + 0.3
    bt, bm, ct = training_targets(anchors, labels)
    check(bt.device == anchors.device == torch.device(dev),
          f"targets on {bt.device}, anchors on {anchors.device}")
    return torch.from_numpy(x).to(dev), (ct, bt, bm), labels


def phase_ssd(dev, card):
    """Phase 44: BASELINE config #5 as ``bench.py``'s ``bench_ssd`` runs
    it (its full branch), with ``import mxnet_tpu_torch as mx``:
    ``mx.random.seed(0)``, ``get_model("ssd_512_resnet50_v1",
    classes=20)`` built with no device (it must land on ``cuda:0``),
    ``initialize(mx.init.Xavier())``, the bench's synthetic images and
    boxes from ``RandomState(0)``, targets from ``training_targets`` on
    the card, the bench's loss, ``ShardedTrainer("sgd", lr 0.01,
    momentum 0.9, compute_dtype=torch.bfloat16)``; B=32 at 512 x 512, 2
    warm + 10 timed steps: ``ssd_resnet50_train_imgs_per_sec_per_chip``
    (B x 10 over the wall of the 10 steps, ending in a synchronize),
    step p50 (CUDA events), peak memory, one ``opt_arena`` launch a step
    and no other kernel of the port; CUDA kernels a step, busy share and
    the split of device time between convolutions and elementwise work
    (3 profiled steps); the loss finite and lower at step 12 than at
    step 1.  Returns the trained net and the batch for phase 46."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.parallel import ShardedTrainer

    c = SSD
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = get_model("ssd_512_resnet50_v1", classes=c["classes"])
    net.initialize(mx.init.Xavier())
    devices = {p.device for p in net.parameters()}
    check(devices == {torch.device("cuda", 0)},
          f"a net built with no device landed on {devices}, not cuda:0")
    x, y, labels = bench_ssd_batch(net, c["batch"], c["image"], dev)
    tr = ShardedTrainer(net, bench_ssd_loss, optimizer="sgd",
                        learning_rate=0.01, momentum=0.9,
                        compute_dtype=torch.bfloat16)
    check(tr.uses_arena, "the trainer did not pick the arena adapter")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    n_anchors = y[0].shape[1]
    print(f"  ssd_512_resnet50_v1 on {dev}: {n_params} parameters, "
          f"{len(tr.aux_names)} buffers, {n_anchors} anchors, "
          f"{int((y[0] > 0).sum())} positive anchors in the batch, built in "
          f"{time.perf_counter() - t0:.2f} s")
    steps = c["steps"]
    losses, p50, wall, launches, peak = timed_steps(tr, x, y, dev, steps)
    check(launches["opt_arena"] == steps,
          f"opt_arena: {launches['opt_arena']} launches in {steps} steps, "
          "want 1 a step")
    others = {k: v for k, v in launches.items() if v and k != "opt_arena"}
    check(not others, f"other port kernels launched: {others}")
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"loss did not fall: {vals}")
    prof = profile_steps(lambda: tr.step(x, y), c["profiled"], SSD_GROUPS)
    ips = c["batch"] * steps / wall
    print(f"  loss by step: {' '.join(f'{v:.4f}' for v in vals)}")
    print(f"  port kernel launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; "
          f"{prof['launches']:.0f} CUDA kernels a step, device busy "
          f"{prof['device_busy_ms']:.3f} ms a step, busy share "
          f"{prof['busy_share']:.4f}; split "
          f"{ {k: round(v, 3) for k, v in prof['split_ms'].items()} } ms a "
          f"step ({c['profiled']} profiled steps)")
    print(f"phase 44 train bench_ssd (ssd_512_resnet50_v1, 20 classes, "
          f"B={c['batch']}, {c['image']}x{c['image']}, sgd lr 0.01 momentum "
          f"0.9, bf16): ssd_resnet50_train_imgs_per_sec_per_chip {ips:.2f}, "
          f"image_size {c['image']}, step p50 {p50:.3f} ms (CUDA events), "
          f"wall {wall * 1e3 / steps:.3f} ms per step, peak "
          f"{peak / 2**30:.2f} GiB [{card}]")
    del tr
    out = dict(ssd_resnet50_train_imgs_per_sec_per_chip=ips,
               image_size=c["image"], batch=c["batch"], step_p50_ms=p50,
               wall_ms_per_step=wall * 1e3 / steps, steps=steps,
               parameters=n_params, anchors=n_anchors,
               launches={k: v for k, v in launches.items() if v},
               launches_per_step=prof["launches"],
               device_busy_ms_per_step=prof["device_busy_ms"],
               busy_share=prof["busy_share"], split_ms=prof["split_ms"],
               loss_first=vals[0], loss_last=vals[-1], peak_bytes=peak)
    return out, net, x, labels


def ssd_cpu_step_runs(dev):
    """Phase 45's runs of ``ssd_512_resnet50_v1`` from one seed at
    ``cpu_batch`` x ``cpu_image``^2: f32 on the card, on the CPU, and on
    the CPU with half its threads and with one, and on the card again
    (other summation orders; cuDNN's backward sums in no fixed order),
    each ``cpu_steps`` steps (losses, the step-1 gradients, the weights
    after); bf16 on the card and on the CPU, one step (loss and
    gradients); the CPU's f32 step-1 gradients serve phase 30's rule."""
    # the f32 steps share one seed and batch with ssd_f64_step1_grads
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.parallel import ShardedTrainer

    c = SSD
    threads = torch.get_num_threads()
    runs = []
    for where, dt, steps, nthreads in (
            (dev, None, c["cpu_steps"], threads),
            ("cpu", None, c["cpu_steps"], threads),
            ("cpu", None, c["cpu_steps"], max(1, threads // 2)),
            ("cpu", None, c["cpu_steps"], 1),
            (dev, None, c["cpu_steps"], threads),
            (dev, torch.bfloat16, 1, threads),
            ("cpu", torch.bfloat16, 1, threads)):
        torch.set_num_threads(nthreads)
        net = xavier_init(get_model("ssd_512_resnet50_v1",
                                    classes=c["classes"], device=where), 45)
        x, y, _ = bench_ssd_batch(net, c["cpu_batch"], c["cpu_image"], where)
        tr = ShardedTrainer(net, bench_ssd_loss, optimizer="sgd",
                            learning_rate=0.01, momentum=0.9,
                            compute_dtype=dt)
        losses = [tr.step(x, y, block=True)]
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in zip(tr.train_names, tr.params)}
        losses += [tr.step(x, y, block=True) for _ in range(steps - 1)]
        weights = {n: p.detach().cpu().clone()
                   for n, p in net.named_parameters()}
        runs.append((losses, grads, weights))
        del tr, net
    torch.set_num_threads(threads)
    return runs


def ssd_f64_step1_grads(where):
    """Phase 45's step-1 loss and gradients in float64 on ``where`` (the
    same seed, batch and loss as its f32 runs, the net cast to float64,
    the gradients of the batch's mean loss through autograd, as the
    trainer takes them), as CPU tensors."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    c = SSD
    net = xavier_init(get_model("ssd_512_resnet50_v1", classes=c["classes"],
                                device=where), 45)
    x, (cls_t, box_t, box_m), _ = bench_ssd_batch(net, c["cpu_batch"],
                                                  c["cpu_image"], where)
    net.cast(torch.float64)
    names, params = zip(*sorted(net.named_parameters()))
    with autograd.record():
        cls_p, box_p, _ = net(x.double())
        lp = torch.log_softmax(cls_p, -1)
        loss = (-lp.gather(-1, cls_t.long()[..., None])[..., 0]).mean(-1) \
            + ((box_p - box_t).abs() * box_m).mean(-1)
        grads = torch.autograd.grad(loss.mean(), params)
    return loss.mean().item(), {n: g.cpu() for n, g in zip(names, grads)}


def _worst_rel(got, want):
    """``(max over tensors of max|g - w| / max|w|, its name)``."""
    worst, name = 0.0, ""
    for n, w in want.items():
        scale = w.abs().max().item()
        err = (got[n] - w).abs().max().item()
        if scale > 0 and err / scale > worst:
            worst, name = err / scale, n
    return worst, name


def phase_ssd_cpu(dev):
    """Phase 45: ``ssd_512_resnet50_v1`` (full depth, 20 classes) on the
    card against the CPU from one seed at B=2, 128 x 128, f32 with TF32
    off: step 1's loss within 1e-4 relative.  The gradients of step 1 in
    float64 on both (``ssd_f64_step1_grads``): the loss within 1e-9
    relative (the targets come from f32 anchors on each device, an ulp
    apart) and every gradient within 1e-9 x max|g|.  The f32 gradients
    are not compared: at this size the backward of a deep ResNet v1 at
    Xavier init cancels, and its f32 gradients carry rounding of a large
    share of some tensors' max against float64 on either device
    (``tools/torch_ssd_f32_rounding.py`` measures it), so two f32
    computations agree only to that noise.  Three steps: losses and
    weights within the larger of 1e-4 (relative; x max|w|) and 3 times
    the largest distance between runs in other summation orders (the
    CPU's on all threads against half of them and against one, the
    card's two), since the sgd-momentum steps magnify that rounding; the
    phase prints every run's losses.  One bf16 step under phase 30's
    rule (the loss within 2e-2, each gradient within the larger of 2^-4
    x max|g| and 3 times the CPU's own bf16-to-f32 distance)."""
    t0 = time.perf_counter()
    (gl, _, gw), (cl, cg, cw), (hl, _, hw), (ol, _, ow), (rl, _, rw), \
        (gl16, gg16, _), (cl16, cg16, _) = ssd_cpu_step_runs(dev)
    (l64, g64), (c64, cg64) = ssd_f64_step1_grads(dev), \
        ssd_f64_step1_grads("cpu")
    rel1 = abs(gl[0] - cl[0]) / abs(cl[0])
    check(rel1 <= 1e-4, f"SSD f32 step-1 loss card {gl[0]} vs CPU {cl[0]}: "
          f"rel {rel1:.3e} > 1e-4")
    rel64 = abs(l64 - c64) / abs(c64)
    check(rel64 <= 1e-9, f"SSD float64 step-1 loss card {l64} vs CPU {c64}:"
          f" rel {rel64:.3e} > 1e-9")
    g_rel, g_name = _worst_rel(g64, cg64)
    check(g_rel <= 1e-9, f"SSD float64 step-1 gradient {g_name}: card vs "
          f"CPU {g_rel:.3e} x max|g| > 1e-9")
    f32_noise, f32_name = _worst_rel({n: c.double() for n, c in cg.items()},
                                     cg64)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    own_loss = max(max(abs(a - b) / abs(b) for other in (hl, ol)
                       for a, b in zip(other, cl)),
                   max(abs(a - b) / abs(b) for a, b in zip(rl, gl)))
    check(loss_rel <= max(1e-4, HALF_NOISE_BARS * own_loss),
          f"SSD f32 losses card {gl} vs CPU {cl}: rel {loss_rel:.3e} > "
          f"max(1e-4, {HALF_NOISE_BARS} x the CPU's own {own_loss:.3e})")
    w_worst, w_name, w_to_own = 0.0, "", 0.0
    for name, w in cw.items():
        scale = w.abs().max().item()
        err = (gw[name] - w).abs().max().item()
        own = max([(other[name] - w).abs().max().item()
                   for other in (hw, ow)]
                  + [(rw[name] - gw[name]).abs().max().item()])
        bar = max(1e-4 * scale, HALF_NOISE_BARS * own)
        check(err <= bar, f"SSD weight {name} after {len(gl)} steps: card "
              f"vs CPU {err:.3e} > max(1e-4 x {scale:.3e}, "
              f"{HALF_NOISE_BARS} x the CPU's own {own:.3e})")
        if scale > 0 and err / scale > w_worst:
            w_worst, w_name = err / scale, name
        if own > 0:
            w_to_own = max(w_to_own, err / own)
    own_w, own_name = max(_worst_rel(hw, cw), _worst_rel(ow, cw),
                          _worst_rel(rw, gw))
    rel16 = abs(gl16[0] - cl16[0]) / abs(cl16[0])
    check(rel16 <= HALF_LOSS_RTOL, f"SSD bf16 loss card {gl16} vs CPU "
          f"{cl16}: rel {rel16:.3e} > {HALF_LOSS_RTOL}")
    g16_worst, g16_name, to_noise = 0.0, "", 0.0
    for name, c in cg16.items():
        top = c.abs().max().item()
        err = (gg16[name] - c).abs().max().item()
        noise = (c - cg[name]).abs().max().item()
        bar = max(HALF_GRAD_TOL * top, HALF_NOISE_BARS * noise)
        check(err <= bar, f"SSD bf16 gradient {name}: card vs CPU {err:.3e} "
              f"> max({HALF_GRAD_TOL} x {top:.3e}, {HALF_NOISE_BARS} x the "
              f"CPU's bf16 vs f32 {noise:.3e})")
        if top > 0 and err / top > g16_worst:
            g16_worst, g16_name = err / top, name
        if noise > 0:
            to_noise = max(to_noise, err / noise)
    print(f"phase 45 ssd_512_resnet50_v1 card vs CPU (B={SSD['cpu_batch']}, "
          f"{SSD['cpu_image']}x{SSD['cpu_image']}, f32, TF32 off): step 1 "
          f"loss rel {rel1:.3e}; in float64 loss rel {rel64:.3e} and "
          f"gradients within {g_rel:.3e} x max|g| ({g_name}; the CPU's f32 "
          f"gradients lie up to {f32_noise:.3e} x max|g| from them, "
          f"{f32_name}); over {SSD['cpu_steps']} steps losses card {gl} vs "
          f"CPU {cl} (rel {loss_rel:.3e}; the CPU at half its threads "
          f"{hl}, at one {ol}, the card again {rl}: rel {own_loss:.3e}), "
          f"weights within {w_worst:.3e} x max|w| ({w_name}; the other "
          f"runs {own_w:.3e}, "
          f"{own_name}; at most {w_to_own:.3f}x their distance); bf16 step "
          f"loss rel "
          f"{rel16:.3e}, worst gradient {g16_worst:.3e} x max|g| "
          f"({g16_name}), at most {to_noise:.3f}x the CPU's bf16-to-f32 "
          f"distance, in {time.perf_counter() - t0:.2f} s")
    return dict(step1_loss_rel_err=rel1, f64_loss_rel_err=rel64,
                f64_grad_rel_err=g_rel, cpu_f32_grad_from_f64=f32_noise,
                loss_rel_err=loss_rel, cpu_own_loss_rel=own_loss,
                weight_rel_err=w_worst, cpu_own_weight_rel=own_w,
                weight_to_cpu_own=w_to_own, bf16_loss_rel_err=rel16,
                bf16_grad_rel_err=g16_worst, bf16_grad_to_noise=to_noise)


def phase_detections(dev, net, x):
    """Phase 46: ``detections`` (softmax, decode, NMS: topk 400) on the
    trained model's f32 outputs for phase 44's batch, on the card and on
    the CPU from the same outputs: class ids and the -1 fill equal,
    scores and boxes within ``BOX_TOL`` x max|ref|; the card's time of
    the call (CUDA events) and its CUDA kernels."""
    from mxnet_tpu_torch.gluon.model_zoo.ssd import detections

    with torch.no_grad():
        cls_p, box_p, anchors = net(x)
    got = detections(cls_p, box_p, anchors)
    want = detections(cls_p.cpu(), box_p.cpu(), anchors.cpu())
    got = got.cpu()
    check(got.shape == want.shape == (x.shape[0], anchors.shape[0], 6),
          f"detections {tuple(got.shape)}, want {tuple(want.shape)}")
    ids_equal = torch.equal(got[..., 0], want[..., 0])
    fill_equal = torch.equal(got[..., 1] < 0, want[..., 1] < 0)
    if not (ids_equal and fill_equal):
        rows = (got != want).any(-1).sum().item()
        check(False, f"detections: {rows} rows differ in class or fill "
              "between the card and the CPU")
    err = (got - want).abs().max().item() / want.abs().max().item()
    check(err <= BOX_TOL, f"detections: card vs CPU {err:.3e} x max|ref| > "
          f"{BOX_TOL}")
    kept = int((got[..., 1] >= 0).sum())
    ms = cuda_time_ms(lambda i: detections(cls_p, box_p, anchors), 1,
                      iters=3, reps=3)
    kernels = kernels_per_call(lambda i: detections(cls_p, box_p, anchors),
                               1, calls=2)
    print(f"phase 46 detections on the trained SSD's outputs (B="
          f"{x.shape[0]}, {anchors.shape[0]} anchors, 21 classes, NMS topk "
          f"400): {kept} rows kept, ids and fill equal to the CPU's, floats "
          f"within {err:.3e} x max|ref|; softmax + decode + NMS {ms:.3f} ms "
          f"a call on the card (CUDA events), {kernels} CUDA kernels a call")
    return dict(rows_kept=kept, rel_err=err, ms=ms, kernels_per_call=kernels)


def phase_ssd_drive(dev, card):
    """Phase 47: the JAX package's SSD drive (``tests/test_boxes.py``'s
    tiny SSD: two stride-2 convolutions, 3 classes, 2 extras) through
    ``autograd.record()`` and ``gluon.Trainer`` (sgd, lr 0.1, momentum
    0.9) with ``SoftmaxCrossEntropyLoss`` + ``HuberLoss`` and the targets
    from ``training_targets``, 8 steps on the card: the loss falls; the
    detections have the JAX shape."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.ssd import (SSD as SSDNet,
                                                     detections,
                                                     training_targets)

    mx.random.seed(0)
    backbone = nn.HybridSequential().add(
        nn.Conv2D(16, 3, strides=2, padding=1, activation="relu",
                  in_channels=3),
        nn.Conv2D(32, 3, strides=2, padding=1, activation="relu",
                  in_channels=16))
    net = SSDNet([backbone], num_classes=3,
                 sizes=[[0.2, 0.3], [0.4, 0.5], [0.6, 0.7]],
                 ratios=[[1, 2, 0.5]] * 3, num_extras=2)
    net.initialize(mx.init.Xavier())
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 64, 64)
                         .astype("float32")).to(dev)
    labels = np.array([[[1.0, 0.1, 0.1, 0.4, 0.4], [-1, 0, 0, 0, 0]],
                       [[2.0, 0.5, 0.5, 0.9, 0.9], [0.0, 0.0, 0.0, 0.3, 0.3]]],
                      "float32")
    l_cls = gluon.loss.SoftmaxCrossEntropyLoss()
    l_box = gluon.loss.HuberLoss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    losses = []
    t0 = time.perf_counter()
    for _ in range(SSD_DRIVE_STEPS):
        with autograd.record():
            cls_preds, box_preds, anchors = net(x)
            bt, bm, ct = training_targets(anchors, labels)
            loss = l_cls(cls_preds.reshape(-1, 4),
                         ct.reshape(-1).int()).mean() + \
                l_box(box_preds * bm, bt * bm).mean()
            loss.backward()
        tr.step(2)
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(anchors.device == torch.device(dev) == bt.device,
          f"anchors on {anchors.device}, targets on {bt.device}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"the tiny SSD's loss did not fall: {losses}")
    dets = detections(cls_preds.detach(), box_preds.detach(), anchors)
    check(dets.shape == (2, anchors.shape[0], 6), f"detections {dets.shape}")
    print(f"phase 47 the JAX package's SSD drive on the card (tiny SSD, "
          f"gluon.Trainer sgd lr 0.1 momentum 0.9, SoftmaxCE + Huber, "
          f"{SSD_DRIVE_STEPS} steps): loss "
          f"{' '.join(f'{v:.4f}' for v in losses)} in {secs:.2f} s [{card}]")
    return dict(losses=losses, seconds=secs)


def phase_losses(dev):
    """Phase 48: every loss of ``gluon.loss`` but softmax cross entropy,
    each with its options (``test_utils.LOSS_CASES``, the CPU tests'
    cases against the JAX package), CTC included: the value and the
    gradients of its sum on the card against the CPU, within
    ``LOSS_TOL`` x max|ref|."""
    from mxnet_tpu_torch.test_utils import LOSS_CASES, loss_run

    worst, name = 0.0, ""
    for case in LOSS_CASES:
        for i, (g, w) in enumerate(zip(loss_run(case, dev),
                                       loss_run(case, "cpu"))):
            scale = max(w.abs().max().item(), 1e-30)
            e = (g - w).abs().max().item() / scale
            check(e <= LOSS_TOL, f"loss {case[0]} output {i}: card vs CPU "
                  f"{e:.3e} x max|ref| > {LOSS_TOL}")
            if e > worst:
                worst, name = e, f"{case[0]} output {i}"
    print(f"phase 48 losses card vs CPU: {len(LOSS_CASES)} cases over "
          f"{len({c[1] for c in LOSS_CASES})} losses, values and gradients "
          f"within {worst:.3e} x max|ref| ({name}; bar {LOSS_TOL})")
    return dict(cases=len(LOSS_CASES), worst_rel_err=worst)


def phase_arena_sgd(dev, ssd_params):
    """Phase 49: the arena kernel's ``sgd`` and ``momentum`` modes beside
    ``torch._fused_sgd_`` (one call over the same flat f32 tensors: a
    yardstick the port never calls; it also reads and writes the
    parameters, where the arena writes a delta) at the SSD's parameter
    count (phase 44) and ``bench_lstm_lm``'s 19,780,400 (phase 41):
    device time (``torch.profiler``) of each, the plain version's by
    events, and the bytes bound (sgd: g read, delta written; momentum: g
    and m read, m and delta written; 4 bytes each)."""
    from mxnet_tpu_torch.kernels import opt_arena as oa

    out = {}
    for label, n in (("ssd_512_resnet50_v1", ssd_params),
                     ("bench_lstm_lm", LSTM_LM_PARAMS)):
        lay = oa.build_layout([(n,)])
        for variant, kw in (("sgd", {}), ("momentum", dict(momentum=0.9))):
            g, st = arena_inputs(lay, oa.VARIANT_STATES[variant], seed=49,
                                 dev=dev)
            ref = [s.clone() for s in st]
            d, _ = oa.arena_update(variant, g, st, 0.01, 3, **kw)
            d_ref, _ = oa.arena_update_reference(variant, g, ref, 0.01, 3,
                                                 **kw)
            err = (d - d_ref).abs().max().item()
            check(err <= 1e-6 * d_ref.abs().max().item(),
                  f"arena {variant} at {n}: {err:.3e}")
            ms = device_ms_per_call(lambda i: oa.arena_update(
                variant, g, st, 0.01, 3, **kw), 1, calls=10)
            plain = cuda_time_ms(lambda i: oa.arena_update_reference(
                variant, g, st, 0.01, 3, **kw), 1, iters=5, reps=3)
            p = torch.zeros_like(g)
            bufs = [torch.zeros_like(g)] if variant == "momentum" else []
            lib = None
            if hasattr(torch, "_fused_sgd_"):
                lib = device_ms_per_call(lambda i: torch._fused_sgd_(
                    [p], [g], bufs, weight_decay=0.0,
                    momentum=0.9 if variant == "momentum" else 0.0, lr=0.01,
                    dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False), 1, calls=10)
            nbytes = (2 if variant == "sgd" else 4) * lay.padded * 4
            bnd = nbytes / HBM_BYTES_PER_S * 1e3
            out[f"{label}.{variant}"] = dict(
                elements=lay.padded, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bnd, bound_by="bytes", max_abs_err=err)
            print(f"  arena {variant} at {label}'s {n} parameters ("
                  f"{lay.padded} padded): kernel {ms:.4f} ms device time, "
                  f"bound {bnd:.4f} ms ({nbytes} B / 3.35e12 B/s; "
                  f"{bnd / ms:.2f} of it), plain {plain:.4f} ms (events), "
                  f"torch._fused_sgd_ "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'} device time")
    print("phase 49 arena sgd / momentum beside torch._fused_sgd_: done")
    return out


# ------------------------------------- hybridize(): CUDA-graph capture (A9)
HYB_BAR = 1e-6          # captured vs eager, x max|eager| (bits expected)
HYB_DECODE = dict(f32=16, bf16=16, int8=16)    # phase 4's requests
HYB_INFER = dict(batches=6)         # B x 6 requests stay under the queue bound


def profile_calls(fn, n):
    """``fn`` run ``n`` times under ``torch.profiler``: device kernels a
    call, the host's launch calls a call (``cudaLaunchKernel``,
    ``cudaLaunchKernelExC``, ``cuLaunchKernel``, ``cudaGraphLaunch``) and
    the device busy share of the window."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels, calls, graphs = 0.0, 0, 0, 0
    for evt in prof.key_averages():
        us = next((float(getattr(evt, k)) for k in (
            "self_device_time_total", "self_cuda_time_total")
            if hasattr(evt, k)), 0.0)
        if us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
            busy_us += us
            kernels += evt.count
        elif evt.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx",
                         "cudaGraphLaunch"):
            calls += evt.count
            graphs += evt.count if evt.key == "cudaGraphLaunch" else 0
    return dict(kernels=kernels / n, launch_calls=calls / n,
                graph_launches=graphs / n,
                busy_share=busy_us / 1e3 / window_ms,
                ms_per_call=window_ms / n)


def hyb_dist(got, want):
    """max |got - want| / max |want| over matching tensors (0 when equal)."""
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.detach().float().abs().max()) or 1.0
        worst = max(worst, float((g.detach().float() - w.detach().float())
                                 .abs().max()) / scale)
    return worst


def phase_hybrid_block(dev, card):
    """Phase 50: a HybridSequential (Dense, BatchNorm, Dropout, Dense) and
    a 2-layer BERT at 256 units (the flash-attention kernel), each eager
    and hybridized in one process, in inference and under record()."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError, autograd, telemetry
    from mxnet_tpu_torch.gluon import HybridBlock, nn
    from mxnet_tpu_torch.gluon.model_zoo import get_bert
    from mxnet_tpu_torch.kernels import registry

    def seq():
        return xavier_init(nn.HybridSequential().add(
            nn.Dense(1024, activation="relu", in_units=256, device=dev),
            nn.BatchNorm(in_channels=1024, device=dev), nn.Dropout(0.1),
            nn.Dense(256, in_units=1024, device=dev)), 0)

    def bert():
        return xavier_init(get_bert(num_layers=2, units=256, hidden_size=1024,
                                    num_heads=4, vocab_size=1000,
                                    max_length=128, dropout=0.1,
                                    device=dev), 0)

    rs = np.random.RandomState(50)
    inputs = {
        "seq": (torch.as_tensor(rs.rand(128, 256), dtype=torch.float32,
                                device=dev),),
        "bert": (torch.as_tensor(rs.randint(0, 1000, (16, 128)), device=dev),
                 torch.zeros(16, 128, dtype=torch.int32, device=dev),
                 torch.as_tensor(rs.randint(32, 129, 16), dtype=torch.int32,
                                 device=dev))}
    telemetry.set_enabled(True)
    rows = {}
    for name, make in (("seq", seq), ("bert", bert)):
        eager, hyb = make(), make()
        hyb.load_state_dict(eager.state_dict())
        hyb.hybridize()
        args = inputs[name]
        for mode in ("infer", "record"):
            telemetry.reset()
            dist, launches = 0.0, []
            for step in range(5):
                res = []
                for net in (eager, hyb):
                    mx.random.seed(500 + step)   # the same dropout masks
                    registry.reset_launches()
                    if mode == "infer":
                        with torch.no_grad():
                            out = net(*args)
                        res.append([out] if torch.is_tensor(out)
                                   else list(out))
                    else:
                        net.zero_grad()
                        with autograd.record():
                            out = net(*args)
                            outs = [out] if torch.is_tensor(out) else list(out)
                            loss = sum((o.float() ** 2).mean() for o in outs)
                        loss.backward()
                        res.append([o.detach() for o in outs] +
                                   [p.grad.clone() for p in net.parameters()
                                    if p.grad is not None])
                    launches.append({k: v for k, v in
                                     registry.launches().items() if v})
                if step >= 2:                    # captured replays
                    dist = max(dist, hyb_dist(res[1], res[0]))
                    check(launches[-1] == launches[-2],
                          f"phase 50 {name} {mode}: launches on replay "
                          f"{launches[-1]} != eager {launches[-2]}")
            snap = telemetry.snapshot()
            miss = snap["hybridize.cache_misses"]["value"]
            hits = snap["hybridize.cache_hits"]["value"]
            check(dist <= HYB_BAR, f"phase 50 {name} {mode}: captured vs "
                  f"eager {dist:.3e} > {HYB_BAR} x max|eager|")
            # inference: the eager first call, the capture, 3 replays;
            # record: the capture, 4 replays
            want_hits = 3 if mode == "infer" else 4
            check(miss == 1 and hits == want_hits, f"phase 50 {name} "
                  f"{mode}: {miss} misses, {hits} hits for one signature")
            rows[f"{name}_{mode}"] = dict(max_rel_dist=dist, misses=miss,
                                          hits=hits, launches=launches[-1])
            print(f"  {name} {mode}: captured vs eager {dist:.3e} x "
                  f"max|eager| (bar {HYB_BAR}), {miss} miss, {hits} hits, "
                  f"launches a call {launches[-1]} both")
        # an update in place is read without a capture
        telemetry.reset()
        with torch.no_grad():
            for net in (eager, hyb):
                for p in net.parameters():
                    p.mul_(0.5)
            got, want = hyb(*args), eager(*args)
        got = [got] if torch.is_tensor(got) else list(got)
        want = [want] if torch.is_tensor(want) else list(want)
        d = hyb_dist(got, want)
        check(d <= HYB_BAR and telemetry.snapshot().get(
            "hybridize.cache_misses", {}).get("value", 0) == 0,
            f"phase 50 {name}: an update in place: {d:.3e}, misses "
            f"{telemetry.snapshot().get('hybridize.cache_misses')}")
        rows[f"{name}_in_place"] = d
        if name == "seq":
            # two replays in training draw different masks, so give
            # different outputs (BatchNorm's batch statistics do not
            # depend on the mask, which follows it)
            outs = []
            for _ in range(2):
                with autograd.record():
                    outs.append(hyb(*args).detach().clone())
            check(not torch.equal(outs[0], outs[1]), "phase 50: two "
                  "replays drew the same dropout mask")
            # load_parameters(cast_dtype=True): one new capture
            path = "build/smoke_hyb.params"
            os.makedirs("build", exist_ok=True)
            eager.cast("float16").save_parameters(path)
            telemetry.reset()
            with torch.no_grad():
                hyb.load_parameters(path, cast_dtype=True)
                eager.load_parameters(path, cast_dtype=True)
                x16 = args[0].half()
                d16 = hyb_dist([hyb(x16)], [eager(x16)])
                hyb(x16)
            os.remove(path)
            n = telemetry.snapshot()["hybridize.cache_misses"]["value"]
            check(n == 1 and d16 <= 1e-3, f"phase 50: load_parameters("
                  f"cast_dtype=True) gave {n} captures, {d16:.3e} off")
            rows["cast_recaptures"] = n
    class Reads(HybridBlock):
        def forward(self, x):
            return x * float(x.sum().item())

    net = Reads()
    net.hybridize()
    x = torch.ones(8, device=dev)
    net(x)
    raised = ""
    try:
        net(x)
    except MXNetError as err:
        raised = str(err)
    check("cannot be captured" in raised and
          not torch.cuda.is_current_stream_capturing(),
          f"phase 50: a forward calling .item() did not raise: {raised!r}")
    print(f"phase 50 hybridized blocks: every replay within {HYB_BAR} x "
          f"max|eager| of the eager block, launches equal, an update in "
          f"place read without a capture, cast_dtype load one capture, "
          f"dropout masks differ between replays, .item() raises "
          f"MXNetError [{card}]")
    rows["item_raises"] = raised[:120]
    return rows


def hyb_serve(lm, name, prompts, hybridize, cfg=None, precision=None,
              arrivals=None):
    """Serve ``prompts`` greedily through ``serve.register_decode``, the
    entry's blocks hybridized or (with ``hybridize`` False) turned back
    to eager before its warmup: all queued before the worker admits any
    (so admission and growth do not depend on timing), or submitted at
    ``arrivals`` (seconds from the start).  Returns tokens, timings,
    counters, whether the server ended on the entry's own batch cache,
    and a profiled step at the last capacity."""
    from mxnet_tpu_torch import serve, telemetry

    cfg = cfg or SERVE_CFG
    telemetry.set_enabled(True)
    telemetry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    entry = serve.register_decode(name, lm, precision=precision,
                                  warmup=False, **cfg)
    if not hybridize:
        for blk in entry.blocks:
            blk.hybridize(False)
    entry.warmup()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - m0
    peak = torch.cuda.max_memory_allocated() - m0
    snap = telemetry.snapshot()
    capture_s = snap.get("hybridize.compile_seconds", {}).get("total", 0.0)
    graphs = snap.get("hybridize.cache_misses", {}).get("value", 0)
    telemetry.reset()
    srv = serve.decode_server(name)
    t0 = time.perf_counter()
    if arrivals is None:
        with srv._cv:
            futs = [srv.submit(p) for p in prompts]
    else:
        futs = []
        for p, at in zip(prompts, arrivals):
            lag = t0 + at - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            futs.append(srv.submit(p))
    results = [f.result(600.0) for f in futs]
    wall = time.perf_counter() - t0
    snap = telemetry.snapshot()
    last = entry.batch_cache(entry.capacity_buckets[srv._cap_i])
    own = all(a.data_ptr() == b.data_ptr() for a, b in zip(
        [x for layer in srv._cache for x in layer],
        [x for layer in last for x in layer]))
    cap = entry.capacity_buckets[0 if entry.capacity_static else -1]
    cache = entry.batch_cache(cap)
    pending = np.zeros(entry.slots, np.int64)
    lens = np.full(entry.slots, cap // 2, np.int64)
    prof = profile_calls(lambda: entry.step(pending, cache, lens), 5)
    serve.shutdown_decode(120.0)
    lm.hybridize(False)
    tokens = sum(len(r) for r in results)
    return dict(results=results, tokens_per_s=tokens / wall,
                step_p50_ms=snap["serve.decode_step_seconds"]["p50"] * 1e3,
                warm_s=warm, capture_s=capture_s, graphs=graphs,
                held_mib=held / 2 ** 20, peak_mib=peak / 2 ** 20,
                misses=snap.get("hybridize.cache_misses",
                                {}).get("value", 0),
                own_cache=own,
                grows=snap.get("serve.cache_grows", {}).get("value", 0),
                step_profile=prof)


def hyb_compare(label, eager, hyb, card):
    same = eager["results"] == hyb["results"]
    check(same, f"{label}: captured answers differ from the eager server's")
    check(hyb["misses"] == 0, f"{label}: {hyb['misses']} captures after "
          "warmup")
    check(hyb["own_cache"], f"{label}: the server ended on another batch "
          "cache than the entry's own")
    e, h = eager["step_profile"], hyb["step_profile"]
    print(f"  {label}: answers equal token for token; eager "
          f"{eager['tokens_per_s']:.1f} tokens/s, step p50 "
          f"{eager['step_p50_ms']:.3f} ms, a step {e['kernels']:.0f} kernels "
          f"/ {e['launch_calls']:.0f} launch calls, busy {e['busy_share']:.4f}"
          f"; captured {hyb['tokens_per_s']:.1f} tokens/s, step p50 "
          f"{hyb['step_p50_ms']:.3f} ms, a step {h['kernels']:.0f} kernels / "
          f"{h['launch_calls']:.0f} launch calls ({h['graph_launches']:.0f} "
          f"graph), busy {h['busy_share']:.4f}; {hyb['graphs']} graphs "
          f"captured in {hyb['capture_s']:.2f} s (warmup {hyb['warm_s']:.2f}"
          f" s), graphs and buffers hold {hyb['held_mib']:.1f} MiB, peak "
          f"{hyb['peak_mib']:.1f} MiB; ended on the entry's own cache "
          f"(no donated-cache copy), growths {hyb['grows']} [{card}]")
    out = {k: {kk: vv for kk, vv in r.items() if kk != "results"}
           for k, r in (("eager", eager), ("captured", hyb))}
    out["equal"] = same
    return out


def phase_hybrid_decode(dev, card):
    """Phase 51: GPT-2 small served eager and hybridized (f32, bf16 and
    int8 caches), the same greedy requests, in one process."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm

    rows = {}
    for variant, n in HYB_DECODE.items():
        dt = torch.bfloat16 if variant == "bf16" else torch.float32
        lm = xavier_init(transformer_lm(device=dev, dtype=dt, **GPT2_SMALL), 0)
        if variant == "bf16":
            lm.cast(dt)
        rs = np.random.RandomState(51)
        lengths = rs.randint(16, 257, size=n)
        lengths[0] = 256             # 256 + 64 tokens outgrow C = 256
        prompts = [rs.randint(0, GPT2_SMALL["vocab_size"], size=k).tolist()
                   for k in lengths]
        prec = "int8" if variant == "int8" else None
        eager = hyb_serve(lm, f"e_{variant}", prompts, False, precision=prec)
        hyb = hyb_serve(lm, f"h_{variant}", prompts, True, precision=prec)
        rows[variant] = hyb_compare(f"GPT-2 small {variant}", eager, hyb,
                                    card)
        del lm
        torch.cuda.empty_cache()
    print(f"phase 51 GPT-2 small decode hybridized: answers equal the eager "
          f"server's in " + ", ".join(rows) + "; captured / eager tokens/s "
          + ", ".join(f"{k} {r['captured']['tokens_per_s']:.1f} / "
                      f"{r['eager']['tokens_per_s']:.1f}"
                      for k, r in rows.items()) + f" [{card}]")
    return rows


def phase_hybrid_lstm(dev, card):
    """Phase 52: phase 42's LSTMLM served eager and hybridized."""
    from mxnet_tpu_torch.gluon.model_zoo import LSTMLM

    lm = xavier_init(LSTMLM(vocab_size=LSTM_LM["vocab"],
                            units=LSTM_LM["hidden"],
                            num_layers=LSTM_LM["layers"]), 0)
    prompts, arrivals = lstm_traffic(np.random.RandomState(52))
    eager = hyb_serve(lm, "lstm_e", prompts, False, cfg=LSTM_SERVE,
                      arrivals=arrivals)
    hyb = hyb_serve(lm, "lstm_h", prompts, True, cfg=LSTM_SERVE,
                    arrivals=arrivals)
    check(hyb["grows"] == 0, f"phase 52: {hyb['grows']} growths")
    row = hyb_compare("LSTMLM", eager, hyb, card)
    print(f"phase 52 LSTMLM served hybridized at phase 42's traffic: "
          f"{len(prompts)} answers equal the eager server's; "
          f"{row['captured']['tokens_per_s']:.1f} vs "
          f"{row['eager']['tokens_per_s']:.1f} tokens/s; no cache copy in "
          f"steady state [{card}]")
    return row


def scorer(net):
    """ResNet-50 in bf16 behind the batch tier: the request's f32 image
    cast to bf16 inside the forward (numpy has no bf16), the scores
    back in f32."""
    from mxnet_tpu_torch.gluon import HybridBlock

    class Bf16Scorer(HybridBlock):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x.to(torch.bfloat16)).float()

    return Bf16Scorer()


def hyb_batch(name, block, bucketer, sample, reqs, max_batch, hybridize):
    from mxnet_tpu_torch import serve, telemetry

    telemetry.set_enabled(True)
    telemetry.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    entry = serve.register(name, block, bucketer=bucketer, sample=sample,
                           warmup=hybridize, background=hybridize)
    if hybridize:
        entry.warmup_handle.wait(900)
    else:
        block.hybridize(False)
        entry.warm()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    capture_s = telemetry.snapshot().get("hybridize.compile_seconds",
                                         {}).get("total", 0.0)
    telemetry.reset()
    srv = serve.Server(max_wait_ms=5, max_batch=max_batch)
    t0 = time.perf_counter()
    outs = [f.result(600.0) for f in [srv.submit(name, *r) for r in reqs]]
    wall = time.perf_counter() - t0
    snap = telemetry.snapshot()
    srv.close(120.0)
    batch, _, _ = entry.pad_requests(reqs[:max_batch])
    dev_batch = tuple(torch.as_tensor(l, device=entry.device) for l in batch)

    def call():
        with torch.inference_mode():
            block(*dev_batch)

    call()
    prof = profile_calls(call, 5)
    serve.unregister(name)
    block.hybridize(False)
    return outs, dict(per_s=len(reqs) / wall, warm_s=warm,
                      capture_s=capture_s,
                      misses=snap.get("hybridize.cache_misses",
                                      {}).get("value", 0),
                      batches=snap["serve.batches"]["value"],
                      model_call=prof)


def phase_hybrid_batch(dev, card):
    """Phase 53: the batch tier eager and hybridized (registered with
    ``background=True``, then ``warmup_handle.wait()``): BERT-base in
    bf16 at phase 37's requests, and ResNet-50 bf16 scoring at B = 32 and
    128."""
    from mxnet_tpu_torch.gluon.model_zoo import bert_12_768_12
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    rows = {}
    bert = xavier_init(bert_12_768_12(dropout=0.0, device=dev, **BERT_BASE),
                       0).cast(torch.bfloat16)
    reqs = bert_requests(BERT_REQUESTS, seed=53)
    sample = (np.zeros(32, np.int32), np.zeros(32, np.int32),
              np.asarray(32, np.int32))
    runs = {}
    for hyb in (False, True):
        runs[hyb] = hyb_batch(f"bert_{hyb}", bert, BERT_BUCKETS, sample, reqs,
                              16, hyb)
    dist = max(hyb_dist([torch.from_numpy(np.asarray(x)) for x in g],
                        [torch.from_numpy(np.asarray(x)) for x in w])
               for g, w in zip(runs[True][0], runs[False][0]))
    check(dist <= HYB_BAR and runs[True][1]["misses"] == 0,
          f"phase 53 BERT bf16: captured vs eager {dist:.3e}, misses "
          f"{runs[True][1]['misses']}")
    rows["bert_bf16"] = dict(eager=runs[False][1], captured=runs[True][1],
                             max_rel_dist=dist)
    del bert
    torch.cuda.empty_cache()
    net = xavier_init(get_model("resnet50_v1", layout="NHWC", device=dev),
                      0).cast(torch.bfloat16)
    block = scorer(net)
    for b in INFER_BATCHES:
        imgs = np.random.RandomState(0).rand(
            b * HYB_INFER["batches"], 224, 224, 3).astype(np.float32)
        reqs = [(x,) for x in imgs]
        runs = {}
        for hyb in (False, True):
            runs[hyb] = hyb_batch(f"resnet_{b}_{hyb}", block, {0: [b]},
                                  np.zeros((224, 224, 3), np.float32), reqs,
                                  b, hyb)
        dist = max(hyb_dist([torch.from_numpy(g)], [torch.from_numpy(w)])
                   for g, w in zip(runs[True][0], runs[False][0]))
        check(dist <= HYB_BAR and runs[True][1]["misses"] == 0,
              f"phase 53 ResNet-50 B={b}: captured vs eager {dist:.3e}, "
              f"misses {runs[True][1]['misses']}")
        rows[f"resnet50_bf16_b{b}"] = dict(
            eager=runs[False][1], captured=runs[True][1], max_rel_dist=dist)
        del imgs, reqs
    for k, r in rows.items():
        e, h = r["eager"], r["captured"]
        unit = "requests/s" if k.startswith("bert") else "img/s"
        print(f"  {k}: captured vs eager {r['max_rel_dist']:.3e} x max|eager|"
              f" (bar {HYB_BAR}); through the server {h['per_s']:.1f} vs "
              f"{e['per_s']:.1f} {unit}; one model call "
              f"{h['model_call']['ms_per_call']:.3f} vs "
              f"{e['model_call']['ms_per_call']:.3f} ms, busy "
              f"{h['model_call']['busy_share']:.4f} vs "
              f"{e['model_call']['busy_share']:.4f}, launch calls "
              f"{h['model_call']['launch_calls']:.0f} vs "
              f"{e['model_call']['launch_calls']:.0f}; {h['misses']} misses "
              f"after the background warmup (captured in "
              f"{h['capture_s']:.2f} s) [{card}]")
    print(f"phase 53 batch tier hybridized: BERT-base bf16 and ResNet-50 "
          f"bf16 at B={INFER_BATCHES} equal eager within {HYB_BAR} [{card}]")
    return rows


def phase_hybrid_lenet(dev, card):
    """Phase 54: the verify skill's drive as written (hybridized: forward
    and backward captured under ``record()``) against the same drive
    without ``hybridize()``, same seed and batches, both with cuDNN's
    deterministic algorithms (its default backward sums in no fixed
    order): the loss trajectory within 1e-6."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # the shuffle draws from numpy's global state (as the JAX
        # sampler does): one seed before each drive gives one batch order
        np.random.seed(54)
        eager = lenet_drive(0, False, card, hybridize=False)
        np.random.seed(54)
        hyb = lenet_drive(0, False, card)
    finally:
        torch.backends.cudnn.deterministic = prev
    worst = max(abs(a - b) for a, b in zip(hyb["losses"], eager["losses"]))
    check(worst <= 1e-6, f"phase 54: hybridized drive's losses leave the "
          f"eager drive's by {worst:.3e} > 1e-6")
    print(f"phase 54 the LeNet drive hybridized vs eager (cuDNN "
          f"deterministic): losses within {worst:.3e} over "
          f"{len(eager['losses'])} steps (bar 1e-6); {hyb['img_per_s']:.1f} "
          f"vs {eager['img_per_s']:.1f} img/s, step p50 "
          f"{hyb['step_p50_ms']:.3f} vs {eager['step_p50_ms']:.3f} ms, busy "
          f"share {hyb['busy_share']:.4f} vs {eager['busy_share']:.4f}, "
          f"device kernels a step {hyb['launches_per_step']:.1f} vs "
          f"{eager['launches_per_step']:.1f} [{card}]")
    return dict(max_loss_dist=worst,
                **{k: {kk: vv for kk, vv in r.items() if kk != "losses"}
                   for k, r in (("eager", eager), ("captured", hyb))})


# ------------------------- the prefill pool and the prefix cache (A4)
POOL_CFG = dict(SERVE_CFG, max_new_tokens=48)
POOL_PREFIX = 192                # tokens every request shares
POOL_UNIQUE = (8, 56)            # unique tokens after it, uniform
POOL_REQUESTS = dict(f32=64, bf16=16, int8=16)
# an answer may leave the unified server's only where the top two logits
# lie within this x max|logit|: phase 42's rule where the logits are f32;
# a bf16 model's logits resolve 2^-8 of their value, so there 2^-6 (2-4
# of their ulps at the top)
POOL_TIE = dict(f32=1e-4, int8=1e-4, bf16=2.0 ** -6)
POOL_MODES = ("unified", "pool", "prefix")
HIT_SHAPES = [(tq, c) for c in (256, 512) for tq in (32, 64)]
HIT_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.int8)]


def phase_bn_workspace(dev, card):
    """Phase 55: a hybridized channel-last ``BatchNormReLU`` captured
    under ``autograd.record()`` at B = 2, 16 (the statistics workspace
    grows) and 8, other work on its capture stream, then the B = 2 graph
    replayed on new values: outputs, gradients and running statistics
    against an eager twin's (C14)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.kernels import bn_act

    def make():
        return xavier_init(nn.BatchNormReLU(axis=-1, in_channels=64,
                                            device=dev), 0)

    eager, hyb = make(), make()
    hyb.load_state_dict(eager.state_dict())
    hyb.hybridize()
    gen = torch.Generator().manual_seed(14)
    xs = {b: (torch.rand(int(b), 14, 14, 64, generator=gen) - 0.3).to(dev)
          for b in (2, 16, 8, "2")}    # "2": new values for the last replay

    def step(net, b):
        with autograd.record():
            out = net(xs[b])
            loss = (out * out).sum()
        loss.backward()
        return [out.detach().clone()] + \
            [p.grad.clone() for p in net.parameters()] + \
            [t.clone() for t in net.buffers()]

    runs = {}
    for name, net in (("eager", eager), ("hyb", hyb)):
        runs[name] = [step(net, b) for b in (2, 2, 16, 16, 8, 8)]
        if name == "hyb":
            (cs,) = hyb._cached_op._streams.values()
            with torch.cuda.stream(cs):
                junk = [torch.full((64 * (i % 16 + 1),), 7, device=dev,
                                   dtype=torch.int32) for i in range(512)]
            cs.synchronize()
            del junk
        runs[name].append(step(net, "2"))
    graphs = len(hyb._cached_op._graphs)
    check(graphs == 3, f"phase 55: {graphs} signatures captured, not 3")
    worst = max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                for got, want in zip(runs["hyb"], runs["eager"])
                for g, w in zip(got, want))
    check(worst <= 1e-6, f"phase 55: the B = 2 replay after the workspace "
          f"grew leaves eager by {worst:.3e} x max|eager| > 1e-6")
    print(f"phase 55 bn_act workspace growth under captured graphs (C14): "
          f"BatchNormReLU captured at B = 2, 16, 8 under record(), "
          f"{len(bn_act._RETIRED)} workspace(s) retired and kept, the B = 2 "
          f"graph replayed after other work on its stream: outputs, "
          f"gradients and running statistics within {worst:.3e} x max|eager|"
          f" [{card}]")
    return dict(max_rel_err=worst, graphs=graphs,
                retired=len(bn_act._RETIRED))


def pool_traffic(n, seed=56):
    """Phase 56's requests: one shared ``POOL_PREFIX``-token prefix drawn
    once from the seed, then 8-56 unique tokens each (uniform)."""
    rs = np.random.RandomState(seed)
    vocab = GPT2_SMALL["vocab_size"]
    head = rs.randint(0, vocab, size=POOL_PREFIX).tolist()
    return [head + rs.randint(0, vocab, size=int(k)).tolist()
            for k in rs.randint(POOL_UNIQUE[0], POOL_UNIQUE[1] + 1, size=n)]


def pool_serve(lm, name, prompts, kernel, precision=None, **srv_kw):
    """Register ``lm`` (warmup included), queue every prompt at once, and
    read the answers, telemetry, captures while serving and the decode
    kernel's launches."""
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.kernels import registry

    telemetry.set_enabled(True)
    t0 = time.perf_counter()
    serve.register_decode(name, lm, precision=precision, **POOL_CFG,
                          **srv_kw)
    warm = time.perf_counter() - t0
    srv = serve.decode_server(name)
    torch.cuda.synchronize()
    telemetry.reset()
    registry.reset_launches()
    t0 = time.perf_counter()
    with srv._cv:
        futs = [srv.submit(p) for p in prompts]
    results = [f.result(600.0) for f in futs]
    wall = time.perf_counter() - t0
    launches = registry.launches().get(kernel, 0)
    snap = telemetry.snapshot()
    stats = srv.prefix.stats() if srv.prefix is not None else None
    serve.shutdown_decode(120.0)

    def count(key, field="count"):
        return snap.get(key, {}).get(field, 0)

    def p50_ms(key):
        return snap[key]["p50"] * 1e3 if key in snap else None

    tokens = sum(len(r) for r in results)
    steps = count("serve.decode_step_seconds")
    return dict(results=results, wall_s=wall, warm_s=warm,
                tokens_per_s=tokens / wall, tokens=tokens,
                ttft_p50_ms=snap["serve.ttft_seconds"]["p50"] * 1e3,
                ttft_p99_ms=snap["serve.ttft_seconds"]["p99"] * 1e3,
                step_p50_ms=p50_ms("serve.decode_step_seconds"),
                prefill_p50_ms=p50_ms("serve.prefill_seconds"),
                prefix_fill_p50_ms=p50_ms("serve.prefix_fill_seconds"),
                move_p50_ms=p50_ms("serve.cache_move_seconds"),
                rows_per_step=(tokens - len(prompts)) / max(steps, 1),
                steps=count("serve.decode_step_seconds"),
                prefills=count("serve.prefill_seconds"),
                prefix_fills=count("serve.prefix_fill_seconds"),
                moves=count("serve.cache_move_seconds"),
                grows=count("serve.cache_grows", "value"),
                misses=count("hybridize.cache_misses", "value"),
                launches=launches, prefix=stats)


def _ms(v):
    return "-" if v is None else f"{v:.3f}"


def pool_ties(lm, prompts, want, got, label, rel=1e-4):
    """Hold every answer to the unified server's by the near-tie rule at
    ``rel`` x max|logit|; returns the answers that leave it (all at near
    ties)."""
    from mxnet_tpu_torch.test_utils import near_tie

    ties = []
    for i, (p, w, g) in enumerate(zip(prompts, want, got)):
        if w == g:
            continue
        k, gap, scale, tie = near_tie(lm, p, w, g, rel)
        check(tie, f"{label}: request {i} leaves the unified server's "
              f"answer at token {k} by {gap:.3e} of logit, not a near tie "
              f"(bar {rel} x {scale:.3e})")
        ties.append((i, k, gap / scale))
    return ties


def hit_logit_gap(lm, prompt):
    """The last prompt token's logits from a cold forward of ``prompt``
    against the prefix-hit route (the shared prefix's forward, then the
    rest from ``cache_len`` = ``POOL_PREFIX``), as max|difference| over
    max|logit|: the two routes compute one function, so only rounding
    (GEMMs of another M) tells them apart."""
    with torch.no_grad():
        cold, _ = lm(np.asarray([prompt]), lm.begin_cache(1, 256), [0],
                     [len(prompt)])
        cache = lm.begin_cache(1, 256)
        lm(np.asarray([prompt[:POOL_PREFIX]]), cache, [0], [POOL_PREFIX])
        hit, _ = lm(np.asarray([prompt[POOL_PREFIX:]]), cache, [POOL_PREFIX],
                    [len(prompt) - POOL_PREFIX])
    a, b = cold[0, -1].float(), hit[0, -1].float()
    return (a - b).abs().max().item() / a.abs().max().item()


def hit_kernel_rows(dev):
    """The decode kernel at a prefix hit's shapes (one row, Tq 32 / 64
    from cache_len = 192, C 256 / 512) against its plain version, and its
    device time beside the plain version's, SDPA's and the bound (the f32
    query pairs' chunk path on 3xTF32 tensor cores)."""
    from mxnet_tpu_torch.ops import attention as att

    rows = {}
    for q_dt, kv_dt in HIT_PAIRS:
        name = att.decode_kernel_name(q_dt, kv_dt)
        for tq, c in HIT_SHAPES:
            row = time_decode16(q_dt, kv_dt, 1, tq, c, [POOL_PREFIX], dev)
            if q_dt == torch.float32:
                bnds, nbytes, _ = bound(1, H, tq, c, D, [POOL_PREFIX],
                                        kv_dt == torch.int8)
                row["bound_ms"], row["bound_by"] = bnds["tf32x3"]
                row["nbytes"] = nbytes
            rows.setdefault(name, []).append(row)
    return rows


def phase_pool_serve(dev, card):
    """Phase 56: GPT-2 small through the prefill pool and the prefix
    cache beside the unified server (module docstring)."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm
    from mxnet_tpu_torch.ops import attention as att

    n_layers = GPT2_SMALL["num_layers"]
    out = {}
    for variant, n in POOL_REQUESTS.items():
        dt = torch.bfloat16 if variant == "bf16" else torch.float32
        lm = xavier_init(transformer_lm(device=dev, dtype=dt, **GPT2_SMALL), 0)
        if variant == "bf16":
            lm.cast(dt)
        prec = "int8" if variant == "int8" else None
        kernel = att.decode_kernel_name(
            dt, torch.int8 if prec else dt)
        prompts = pool_traffic(n)
        runs = {mode: pool_serve(lm, f"p56_{mode}_{variant}", prompts, kernel,
                                 precision=prec, **kw)
                for mode, kw in (("unified", dict(prefill_workers=0)),
                                 ("pool", dict(prefill_workers=2,
                                               prefix_cache=False)),
                                 ("prefix", dict(prefill_workers=2)))}
        want = runs["unified"]["results"]
        check(all(len(r) == POOL_CFG["max_new_tokens"] for r in want),
              f"phase 56 {variant}: an answer resolved short")
        for mode, r in runs.items():
            label = f"phase 56 {variant} {mode}"
            check(r["misses"] == 0, f"{label}: {r['misses']} captures after "
                  "warmup")
            forwards = r["steps"] + r["prefills"] + r["prefix_fills"]
            check(r["launches"] >= n_layers * forwards, f"{label}: {kernel} "
                  f"launched {r['launches']} < {n_layers} x {forwards} "
                  "(steps + prefills + prefix fills)")
            check(r["grows"] >= 1, f"{label}: the batch never grew")
            if mode != "unified":
                check(r["moves"] == n, f"{label}: {r['moves']} moves for "
                      f"{n} requests")
                r["ties"] = pool_ties(lm, prompts, want, r["results"], label,
                                      POOL_TIE[variant])
        pre = runs["prefix"]
        st = pre["prefix"]
        check(pre["prefix_fills"] == st["hits"] >= n - 8 and
              pre["prefills"] == st["misses"] == n - st["hits"],
              f"phase 56 {variant} prefix: {pre['prefills']} prefills, "
              f"{pre['prefix_fills']} prefix fills for {st}")
        check(runs["pool"]["prefix_fills"] == 0 and
              runs["pool"]["prefills"] == n == runs["unified"]["prefills"],
              f"phase 56 {variant}: prefill counts {runs['pool']['prefills']}"
              f" / {runs['unified']['prefills']} for {n} requests")
        gap = max(hit_logit_gap(lm, p) for p in prompts[:4])
        check(gap <= 2.0 ** -6, f"phase 56 {variant}: a hit's logits leave "
              f"a cold prefill's by {gap:.3e} x max|logit| > 2^-6")
        out_gap = gap
        for mode, r in runs.items():
            print(f"  {variant} {mode}: {r['tokens']} tokens in "
                  f"{r['wall_s']:.3f} s = {r['tokens_per_s']:.1f} tokens/s, "
                  f"TTFT p50 {r['ttft_p50_ms']:.2f} ms p99 "
                  f"{r['ttft_p99_ms']:.2f} ms, {r['steps']} steps "
                  f"({r['rows_per_step']:.2f} rows each, p50 "
                  f"{r['step_p50_ms']:.3f} ms), prefill / prefix fill / "
                  f"move p50 {_ms(r['prefill_p50_ms'])} / "
                  f"{_ms(r['prefix_fill_p50_ms'])} / {_ms(r['move_p50_ms'])} "
                  "ms, "
                  f"{r['prefills']} prefills, {r['prefix_fills']} prefix "
                  f"fills, {r['moves']} moves, growths {r['grows']}, "
                  f"{r['launches']} {kernel} launches, warmup "
                  f"{r['warm_s']:.2f} s, answers leaving the unified "
                  f"server's at near ties: {r.get('ties', [])}")
        print(f"  {variant} trie: {st['hits']} hits / {st['misses']} misses "
              f"(hit rate {st['hit_rate']:.4f}), {st['nodes']} nodes, "
              f"{st['bytes']} bytes of pages on the card, {st['evictions']} "
              f"evictions; a hit's last-token logits against a cold "
              f"prefill's (4 prompts, eager): {out_gap:.3e} x max|logit|")
        out[variant] = {m: {k: v for k, v in r.items() if k != "results"}
                        for m, r in runs.items()}
        out[variant]["hit_vs_cold_logits"] = out_gap
        del lm
        torch.cuda.empty_cache()
    hits = hit_kernel_rows(dev)
    print(f"phase 56 GPT-2 small through the prefill pool and the prefix "
          f"cache ({POOL_REQUESTS['f32']} requests of a shared "
          f"{POOL_PREFIX}-token prefix + {POOL_UNIQUE[0]}-{POOL_UNIQUE[1]} "
          f"unique tokens, {POOL_CFG['max_new_tokens']} new each, all at "
          f"once; bf16 and int8 caches at {POOL_REQUESTS['bf16']}): every "
          "pool and prefix answer "
          "equals the unified server's or leaves it at a near tie ("
          + ", ".join(f"{v} {len(r['pool']['ties'])} + "
                      f"{len(r['prefix']['ties'])}" for v, r in out.items())
          + "), hits add no prefill, no capture after warmup; tokens/s "
          "unified / pool / prefix " + ", ".join(
              f"{v} " + " / ".join(f"{r[m]['tokens_per_s']:.1f}"
                                   for m in ("unified", "pool", "prefix"))
              for v, r in out.items()) + f" [{card}]")
    out["hit_shapes"] = hits
    return out


def phase_pool_lstm(dev, card):
    """Phase 57: ``LSTMLM`` at ``LSTM_SERVE`` widths through a prefill
    pool (``prefill_workers=1``) beside the unified server; an explicit
    prefix cache refused."""
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.model_zoo import LSTMLM

    lm = xavier_init(LSTMLM(vocab_size=LSTM_LM["vocab"],
                            units=LSTM_LM["hidden"],
                            num_layers=LSTM_LM["layers"]), 0)
    try:
        serve.register_decode("p57_refused", lm, prefill_workers=1,
                              prefix_cache=True, warmup=False, **LSTM_SERVE)
        refused = ""
    except MXNetError as err:
        refused = str(err)
    check("capacity-independent" in refused, "phase 57: prefix_cache=True "
          f"was not refused for LSTMLM: {refused!r}")
    prompts, _ = lstm_traffic(np.random.RandomState(57))
    prompts = prompts[:64]
    runs = {}
    for mode, workers in (("unified", 0), ("pool", 1)):
        entry = serve.register_decode(f"p57_{mode}", lm,
                                      prefill_workers=workers, **LSTM_SERVE)
        srv = serve.decode_server(f"p57_{mode}")
        check(srv.prefix is None, f"phase 57 {mode}: a prefix cache was made")
        t0 = time.perf_counter()
        with srv._cv:
            futs = [srv.submit(p) for p in prompts]
        runs[mode] = [f.result(600.0) for f in futs]
        wall = time.perf_counter() - t0
        serve.shutdown_decode(120.0)
        tokens = sum(len(r) for r in runs[mode])
        print(f"  LSTMLM {mode}: {tokens} tokens in {wall:.3f} s = "
              f"{tokens / wall:.1f} tokens/s (capacity-static: "
              f"{entry.capacity_static})")
    ties = pool_ties(lm, prompts, runs["unified"], runs["pool"],
                     "phase 57 LSTMLM pool", LSTM_TIE)
    print(f"phase 57 LSTMLM through a prefill pool: {len(prompts)} answers, "
          f"{len(prompts) - len(ties)} equal the unified server's, "
          f"{len(ties)} leave it at a near tie {ties}; prefix_cache=True "
          f"refused [{card}]")
    return dict(requests=len(prompts), near_ties=ties)


# phase 58: tracing and observability behind both serving tiers
OBS_REQUESTS = 16
OBS_MAX_OVERHEAD = 1.05          # tools/trace_smoke.py's and obs_smoke.py's bar
# alternated on / off pairs a gate: an even count, so the order (on off,
# off on, ...) gives both sides the same mean place in the gate
OBS_GATE_PAIRS = 8
# a gate's pass serves the 16 requests this many times over: one round
# (≈ 0.4 s) spread ±5% between passes on the card, tracing or not
OBS_GATE_ROUNDS = 3
OBS_DIR = Path(__file__).resolve().parent / "build" / "obs_smoke"
# the symbol of the decode kernel a step launches (split-K, Tq = 1) in a
# profiler trace; a prefill's chunk path runs the forward core's kernel
DECODE_STEP_SYMBOL = "decode_split_kernel"
OBS_BERT_BUCKETS = {0: [4, 8, 16], 1: [128]}


def obs_get(url, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def obs_pass(name, prompts, rounds=1):
    """``rounds`` rounds of ``prompts`` through decode server ``name``,
    one after another: tokens/s over the pass."""
    from mxnet_tpu_torch import serve

    srv = serve.decode_server(name)
    gc.collect()                 # no collection left over from before
    tokens = 0
    t0 = time.perf_counter()
    for _ in range(rounds):
        with srv._cv:
            futs = [srv.submit(p) for p in prompts]
        results = [f.result(600.0) for f in futs]
        check(all(len(r) == SERVE_CFG["max_new_tokens"] for r in results),
              "phase 58: an answer resolved short of max_new_tokens")
        tokens += sum(len(r) for r in results)
    return tokens / (time.perf_counter() - t0)


def obs_gate(name, prompts, flip, label):
    """``OBS_GATE_PAIRS`` alternated pairs of passes with ``flip(True)``
    and ``flip(False)``, the side that goes first alternating too (on
    off, off on, ...); the overhead is mean(tokens/s off) / mean(tokens/s
    on), the same tokens a pass.  A served pass drifts by up to 20% over
    a minute on the card (``tools/torch_obs_gate_spread.py``): with an
    even count of pairs a steady drift adds as much to each side's mean,
    where the best pass of each side is the one the drift favours (the
    last, on a rising drift)."""
    on, off = [], []
    for i in range(OBS_GATE_PAIRS):
        pair = ((True, on), (False, off))
        for flag, out in (pair if i % 2 == 0 else pair[::-1]):
            prev = flip(flag)
            try:
                out.append(obs_pass(name, prompts, OBS_GATE_ROUNDS))
            finally:
                flip(prev)
    ratio = float(np.mean(off) / np.mean(on))
    check(ratio <= OBS_MAX_OVERHEAD, f"phase 58: {label} on costs "
          f"{(ratio - 1) * 100:.2f}% of tokens/s > "
          f"{(OBS_MAX_OVERHEAD - 1) * 100:.0f}% (on {on}, off {off})")
    return dict(on_tokens_per_s=on, off_tokens_per_s=off, ratio=ratio)


def timer_count(name):
    from mxnet_tpu_torch import telemetry

    t = telemetry.peek(name)
    return t.count if t is not None else 0


def obs_profile(name, dev):
    """Profile 2 decode steps with ``torch.profiler``, merge the session
    into one ``mx.trace`` document and hold every split-K decode kernel
    event inside a ``serve.decode_step`` span.  The profiler starts while
    the decode loop is idle (CUPTI enabled under a thread that is
    replaying graphs kept no kernel record, and a later session hung, on
    an H100), then 8 requests are admitted and served for 2 steps under
    it; it stops with the loop held at a step boundary (the server's
    condition, which the loop takes before each step) and the card
    drained, since a session stopped while the loop replayed its graphs
    hung once in a whole-script run.  A profile without the steps'
    kernels is taken again, up to ``PROFILER_TRIES`` times (CUPTI now and
    then keeps no record, ``kernel_records``)."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import serve, trace
    from mxnet_tpu_torch.trace import export

    srv = serve.decode_server(name)
    rs = np.random.RandomState(581)
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    raw = str(OBS_DIR / "profile.json")
    for attempt in range(PROFILER_TRIES):
        prompts = [rs.randint(0, GPT2_SMALL["vocab_size"], size=40).tolist()
                   for _ in range(SERVE_CFG["slots"])]
        trace.reset()
        deadline = time.perf_counter() + 120.0
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        export.mark_profiler()
        with srv._cv:            # the loop is idle: no step under way
            began, ended = srv._steps, timer_count(
                "serve.decode_step_seconds")
            ttft0 = timer_count("serve.ttft_seconds")
            futs = [srv.submit(p) for p in prompts]
        while timer_count("serve.ttft_seconds") < ttft0 + len(prompts):
            check(time.perf_counter() < deadline,
                  "phase 58: prompts not admitted")
            time.sleep(0.0005)
        steps0 = timer_count("serve.decode_step_seconds")
        while timer_count("serve.decode_step_seconds") < steps0 + 2:
            check(time.perf_counter() < deadline, "phase 58: no steps")
            time.sleep(0.0005)
        with srv._cv:            # the loop takes it before each step
            while timer_count("serve.decode_step_seconds") - ended \
                    < srv._steps - began:        # a step is under way
                check(time.perf_counter() < deadline,
                      "phase 58: the step under way did not end")
                time.sleep(0.0005)
            torch.cuda.synchronize()
            prof.stop()
        for f in futs:
            f.result(600.0)
        prof.export_chrome_trace(raw)
        path = trace.export_chrome(str(OBS_DIR / "trace.json"),
                                   profiler_trace=raw)
        with open(path) as f:
            doc = json.load(f)
        kern = [e for e in doc["traceEvents"] if e.get("ph") == "X"
                and e.get("cat") == "kernel"
                and DECODE_STEP_SYMBOL in e["name"]]
        if len(kern) >= 2 * GPT2_SMALL["num_layers"]:
            break
        print(f"  profile {attempt + 1}: {len(kern)} decode kernel events "
              f"(CUPTI kept too few); taking it again")
    check(len(kern) >= 2 * GPT2_SMALL["num_layers"],
          f"phase 58: {len(kern)} decode kernel events in the profile of 2 "
          f"steps (< {2 * GPT2_SMALL['num_layers']}) in {PROFILER_TRIES} "
          "profiles")
    align = doc["metadata"]["profiler_alignment"]
    steps = [e for e in doc["traceEvents"] if e["name"] == "serve.decode_step"]
    slack = align["error_us"]
    margins = [max(min(k["ts"] - s["ts"],
                       s["ts"] + s["dur"] - k["ts"] - k["dur"])
                   for s in steps) for k in kern]
    worst = min(margins)
    for k, m in zip(kern, margins):
        if m < -slack:       # what the host was doing when it ran
            near = sorted((round(e["ts"] - k["ts"], 1), e["name"],
                           round(e.get("dur", 0.0), 1))
                          for e in doc["traceEvents"] if e.get("ph") == "X"
                          and "." in e.get("name", "") and e.get("cat")
                          == e["name"].split(".", 1)[0]
                          and abs(e["ts"] - k["ts"]) < 20000)
            print(f"  outside by {-m:.1f} us: {k['name'][:60]} at "
                  f"{k['ts']:.1f}, host spans within 20 ms (offset us, "
                  f"name, dur us): {near[:16]}")
    check(worst >= -slack, f"phase 58: a decode kernel event lies "
          f"{-worst:.1f} us outside every serve.decode_step span (alignment "
          f"error {slack:.1f} us)")
    os.remove(raw)
    return dict(kernel_events=len(kern), step_spans=len(steps),
                align_error_us=slack, worst_margin_us=worst,
                device=align["device"],
                document_events=len(doc["traceEvents"]),
                profiles=attempt + 1, kernel=kern[0]["name"][:80])


def obs_c15(name, url):
    """C15 on the card: a step raising ``MXNetError`` with the flight
    recorder armed ends the loop; the resident futures raise it;
    ``/readyz`` is 503 naming the loop; the dump names the error."""
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.trace import flight

    srv = serve.decode_server(name)
    real, calls = srv.entry.step, []

    def failing(*args):
        calls.append(1)
        if len(calls) == 4:
            raise MXNetError("phase 58: injected decode step fault")
        return real(*args)

    fdir = OBS_DIR / "flight"
    if fdir.exists():
        for f in fdir.iterdir():
            f.unlink()
    flight.arm(str(fdir))
    try:
        srv.entry.step = failing
        rs = np.random.RandomState(582)
        with srv._cv:
            futs = [srv.submit(rs.randint(0, 1000, size=20).tolist())
                    for _ in range(SERVE_CFG["slots"])]
        failed = 0
        for f in futs:
            try:
                f.result(600.0)
            except MXNetError as err:
                failed += "injected decode step fault" in str(err)
        check(failed == len(futs), f"phase 58: {failed} of {len(futs)} "
              "resident futures raised the step's error")
        srv._thread.join(60.0)
        check(not srv.alive, "phase 58: the decode loop lives on after the "
              "step raised")
        code, body = obs_get(url, "/readyz")
        dead = json.loads(body)["checks"]["decode_loops_alive"]["dead"]
        check(code == 503 and dead == [name], f"phase 58: /readyz {code} "
              f"naming {dead} after the step raised")
    finally:
        flight.disarm()
        serve.shutdown_decode(120.0)
    dumps = sorted(fdir.glob("flight-*.json"))
    check(dumps, "phase 58: no flight dump on disk")
    with open(dumps[0]) as f:
        doc = json.load(f)
    reason = doc["metadata"]["flight"]["reason"]
    check("injected decode step fault" in reason,
          f"phase 58: the dump names {reason!r}")
    return dict(futures_failed=failed, readyz=code, dumps=len(dumps),
                dump_events=len(doc["traceEvents"]), reason=reason[:80])


def obs_bert(dev):
    """16 BERT-base requests through the batch tier, a 17th shed at a
    full queue: every served request's ``serve.queue`` and
    ``serve.respond`` under its id and its batch's ``serve.dispatch`` and
    ``serve.sync``; the shed one's ``serve.shed``."""
    from mxnet_tpu_torch import serve, trace
    from mxnet_tpu_torch.gluon.model_zoo import bert_12_768_12
    from mxnet_tpu_torch.kernels import registry

    bert = xavier_init(bert_12_768_12(dropout=0.0, device=dev, **BERT_BASE),
                       0)
    t0 = time.perf_counter()
    serve.register("bert_obs", bert, bucketer=OBS_BERT_BUCKETS,
                   sample=(np.zeros(32, np.int32), np.zeros(32, np.int32),
                           np.asarray(32, np.int32)))
    warm = time.perf_counter() - t0
    reqs = [r for r in bert_requests(12 * OBS_REQUESTS, seed=58)
            if r[2] <= 128][:OBS_REQUESTS + 1]
    check(len(reqs) == OBS_REQUESTS + 1, "phase 58: too few BERT requests")
    srv = serve.Server(max_wait_ms=5, max_batch=16, queue_max=OBS_REQUESTS)
    trace.reset()
    registry.reset_launches()
    srv._ensure_threads = lambda: None          # hold the dispatcher
    futs = [srv.submit("bert_obs", *r) for r in reqs[:OBS_REQUESTS]]
    try:
        srv.submit("bert_obs", *reqs[-1])
        shed = False
    except serve.RejectedError:
        shed = True
    check(shed, "phase 58: the 17th request was not shed at a full queue")
    del srv._ensure_threads
    srv._ensure_threads()
    outs = [f.result(600.0) for f in futs]
    srv.close(120.0)
    launches = registry.launches()["flash_attention"]
    check(launches >= 12, f"phase 58: {launches} flash_attention launches")
    bert.hybridize(False)        # the references below run eagerly
    worst = 0.0
    for i, ((tok, seg, vl), (seq, pooled)) in enumerate(zip(reqs, outs)):
        check(seq.shape == (int(vl), 768) and np.isfinite(seq).all()
              and np.isfinite(pooled).all(),
              "phase 58: a BERT answer is not finite or of the wrong shape")
        if i < 2:                # against a one-request forward
            with torch.inference_mode():
                ref = bert(tok[None], seg[None], np.asarray([int(vl)]))
            for got, want in zip((seq, pooled), (ref[0][0], ref[1][0])):
                want = want.cpu().numpy()
                err = float(np.abs(got - want).max()) / max(
                    float(np.abs(want).max()), 1e-30)
                check(err <= 1e-4, f"phase 58: a served BERT answer is "
                      f"{err:.3e} x max|ref| off a one-request forward")
                worst = max(worst, err)
    ids = {f.id for f in futs}
    per, batches, sheds = {}, {}, []
    for e in trace.events():
        if e["name"] in ("serve.queue", "serve.respond"):
            per.setdefault(e["corr"]["request"], []).append(e["name"])
        elif e["name"] == "serve.shed":
            sheds.append(e["corr"]["request"])
        elif e["name"] in ("serve.dispatch", "serve.sync"):
            batches.setdefault(e["corr"]["serve_batch"], []).append(e["name"])
    check(set(per) == ids and all(sorted(v) == ["serve.queue",
                                                "serve.respond"]
                                  for v in per.values()),
          f"phase 58: requests' queue / respond spans {per}")
    check(len(sheds) == 1 and sheds[0] not in ids, "phase 58: shed spans "
          f"{sheds}")
    check(batches and all(sorted(v) == ["serve.dispatch", "serve.sync"]
                          for v in batches.values()),
          f"phase 58: batches' dispatch / sync spans {batches}")
    serve.unregister("bert_obs")
    return dict(requests=len(ids), batches=len(batches), shed=len(sheds),
                warm_s=warm, flash_attention_launches=launches,
                answer_rel_err=worst)


def phase_obs(dev, card):
    """Phase 58: GPT-2-small (phase 4's model, f32, captured) served with
    ``obs.serve_metrics(0)`` armed and scraped mid-load; histograms
    against timers at quiesce; trace-on and obs-on overhead gates; a
    ``torch.profiler`` session merged into one ``mx.trace`` document;
    C15 with the flight recorder armed; BERT-base through the batch
    tier with every request's spans."""
    import importlib
    import threading

    from mxnet_tpu_torch import obs, serve, telemetry, trace
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm
    from mxnet_tpu_torch.kernels import registry

    t_phase = time.perf_counter()
    telemetry.set_enabled(True)
    trace.set_enabled(True)
    obs.set_enabled(True)
    # CUPTI set up before any serving thread runs (a first profiler
    # session beside a thread replaying graphs kept no kernel record)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    lm = xavier_init(transformer_lm(device=dev, **GPT2_SMALL), 0)
    rs = np.random.RandomState(58)
    prompts = [rs.randint(0, GPT2_SMALL["vocab_size"], size=int(n)).tolist()
               for n in rs.randint(16, 129, size=OBS_REQUESTS)]
    name = "gpt2s_obs"
    serve.register_decode(name, lm, **SERVE_CFG)
    ms = obs.serve_metrics(0, host="127.0.0.1")
    try:
        obs_pass(name, prompts)                     # settle the allocator
        # -- scraped mid-load; histograms against timers ------------------
        hists = importlib.import_module(
            "mxnet_tpu_torch.obs.histogram").histograms()
        names = ("serve.decode_step_seconds", "serve.ttft_seconds")
        h0 = {n: hists[n].count for n in names}
        t0 = {n: timer_count(n) for n in names}
        codes, stop = [], threading.Event()

        def scrape():            # a poller's cadence, not a tight loop
            while not stop.is_set():
                codes.append(obs_get(ms.url, "/metrics")[0])
                codes.append(obs_get(ms.url, "/statusz")[0])
                stop.wait(0.05)

        registry.reset_launches()
        scraper = threading.Thread(target=scrape, name="phase58-scraper")
        scraper.start()
        try:
            tps = obs_pass(name, prompts)
        finally:
            stop.set()
            scraper.join(60.0)
        launches = registry.launches()
        check(launches["flash_attention_decode"] >= GPT2_SMALL["num_layers"],
              "phase 58: the decode kernel was not launched")
        check(len(codes) >= 4 and set(codes) == {200},
              f"phase 58: mid-load scrapes answered {sorted(set(codes))} "
              f"({len(codes)} scrapes)")
        counts = {n: (hists[n].count - h0[n], timer_count(n) - t0[n])
                  for n in names}
        check(all(h == t > 0 for h, t in counts.values()),
              f"phase 58: histogram vs timer counts {counts}")
        code, body = obs_get(ms.url, "/readyz")
        check(code == 200, f"phase 58: /readyz {code} at quiesce: {body}")
        print(f"  {tps:.1f} tokens/s scraped mid-load: {len(codes)} scrapes "
              f"(all 200); histogram = timer counts {counts}; /readyz 200 "
              "at quiesce")
        # -- overhead gates ------------------------------------------------
        tgate = obs_gate(name, prompts, trace.set_enabled, "trace")
        ogate = obs_gate(name, prompts, obs.set_enabled, "obs")
        print(f"  trace on/off tokens/s {tgate['on_tokens_per_s']} / "
              f"{tgate['off_tokens_per_s']} (ratio {tgate['ratio']:.4f}); "
              f"obs on/off {ogate['on_tokens_per_s']} / "
              f"{ogate['off_tokens_per_s']} (ratio {ogate['ratio']:.4f})")
        # -- the card's kernels on the host timeline -----------------------
        prof = obs_profile(name, dev)
        print(f"  profile of 2 steps: {prof['kernel_events']} decode kernel "
              f"events inside {prof['step_spans']} serve.decode_step spans, "
              f"worst margin {prof['worst_margin_us']:.1f} us, alignment "
              f"error {prof['align_error_us']:.1f} us (device clock fitted "
              f"to {prof['device']['launches']} launches: offset "
              f"{prof['device']['offset_us']} us, drift "
              f"{prof['device']['drift_us_per_ms']} us/ms), "
              f"{prof['document_events']} events in the document, "
              f"{prof['profiles']} profile(s)")
        # -- C15 ------------------------------------------------------------
        c15 = obs_c15(name, ms.url)
        bert = obs_bert(dev)
        print(f"  C15: {c15['futures_failed']} resident futures raised, "
              f"/readyz {c15['readyz']}, {c15['dumps']} flight dump(s) naming "
              f"{c15['reason']!r}; BERT-base: {bert['requests']} requests in "
              f"{bert['batches']} batch(es) with their spans, {bert['shed']} "
              f"shed, answers {bert['answer_rel_err']:.3e} x max|ref| off "
              "one-request forwards")
    finally:
        obs.stop_metrics()
        serve.shutdown_decode(120.0)
    took = time.perf_counter() - t_phase
    print(f"phase 58 tracing and observability: GPT-2 small {tps:.1f} "
          f"tokens/s scraped, trace overhead "
          f"{(tgate['ratio'] - 1) * 100:+.2f}%, obs overhead "
          f"{(ogate['ratio'] - 1) * 100:+.2f}% (bar "
          f"{(OBS_MAX_OVERHEAD - 1) * 100:.0f}%), {took:.1f} s [{card}]")
    return dict(tokens_per_s=tps, scrapes=len(codes), counts=counts,
                trace_gate=tgate, obs_gate=ogate, profile=prof, c15=c15,
                bert=bert, launches={k: v for k, v in launches.items() if v},
                seconds=took)


# phase 59: BERT-base bf16 pretraining built from mx.np as bench_bert runs
# it, FLOP-counted (trace.cost) and profiled (mx.profiler); the trainer's,
# the checkpoint's and the loader's seams on the card
PROFILE_DIR = Path(__file__).resolve().parent / "build" / "profile_smoke"
BERT_BENCH = dict(batch=32, seq=128, masked=20, warm=2, timed=10,
                  cpu_batch=1, cpu_seq=32, units=768, hidden=3072,
                  layers=12, heads=12)
# the kernels of the step: bf16 at T = 128 (the fused backward); the
# bench's AdamW updates each parameter on its own, so the arena is not
# on this path
PROFILE_SYMBOLS = {"flash_attention.bf16": "flash_fwd16_kernel",
                   "flash_attention_bwd_dkv.bf16": "flash_bwd16_dkv_kernel"}


def bert_analytic_flops(b, t, p, lens, half=True):
    """The FLOPs of one BERTForPretrain step: 2 M N K for every product,
    times 3 (forward, dX, dW: every product's input carries a gradient),
    plus attention's products an attended pair: 4 d forward (q k^T, p v),
    8 d for their gradients, and what the backward kernels compute again
    (q k^T, 2 d, in the 16-bit fused mode; 6 d in the dq + dk/dv pair).
    The attention term is what the wrappers report; the CPU test
    test_cost_attention_work_is_the_plain_products holds those reports
    to FlopCounterMode's count of the plain function, so here the
    equality checks the counted products and that every launch
    reported."""
    c = BERT_BENCH
    u, h, v = c["units"], c["hidden"], BERT_BASE["vocab_size"]
    n = b * t
    per_layer = 2 * n * (4 * u * u + 2 * u * h)
    heads = 2 * b * u * u + 2 * b * u * 2 + 2 * b * p * u * u + \
        2 * b * p * u * v
    d = u // c["heads"]
    pairs = c["heads"] * t * sum(min(int(x), t) for x in lens)
    return 3 * (c["layers"] * per_layer + heads) + \
        c["layers"] * d * pairs * (4 + 8 + (2 if half else 6))


def bench_bert_inputs(vocab, seq, npred, batch):
    """bench_bert_base's inputs in its order of draws (RandomState(0)):
    the first call's (2, seq) rows, then the training batch."""
    rs = np.random.RandomState(0)
    first = (rs.randint(0, vocab, size=(2, seq)).astype("int32"),
             np.zeros((2, seq), "int32"), np.full((2,), seq, "int32"),
             rs.randint(0, seq, size=(2, npred)).astype("int32"))
    x = (rs.randint(0, vocab, size=(batch, seq)).astype("int32"),
         np.zeros((batch, seq), "int32"), np.full((batch,), seq, "int32"),
         rs.randint(0, seq, size=(batch, npred)).astype("int32"))
    y = (rs.randint(0, vocab, size=(batch, npred)).astype("int32"),
         rs.randint(0, 2, size=(batch,)).astype("int32"))
    return first, x, y


def trainer_state(tr):
    """Copies of every piece of a trainer's state (bit for bit)."""
    from mxnet_tpu_torch import random as mxrandom

    return dict(params=[p.detach().clone() for p in tr.params],
                opt=[t.clone() for t in tr._adapter.leaves()],
                arena=tr._garena.clone(), t=tr._t,
                gen=mxrandom.generator(tr.device).get_state().clone())


def same_state(a, b):
    for k in a:
        x, y = a[k], b[k]
        for u, w in (zip(x, y) if isinstance(x, list) else [(x, y)]):
            if torch.is_tensor(u):
                if not torch.equal(u.view(torch.uint8) if u.is_floating_point()
                                   and u.ndim else u,
                                   w.view(torch.uint8) if w.is_floating_point()
                                   and w.ndim else w):
                    return k
            elif u != w:
                return k
    return None


def profile_doc_checks(doc, launched):
    """The merged profile: every profiled flash kernel event inside
    a trainer.step span (at the alignment bound phase 58 uses), every
    trainer.dispatch under its step id, one kernels.dispatch instant per
    kernel signature, and profiler.* entries from a Scope and a Marker."""
    align = doc["metadata"]["profiler_alignment"]
    evs = doc["traceEvents"]
    steps = [e for e in evs if e.get("name") == "trainer.step"
             and e.get("ph") == "X"]
    check(len(steps) == BERT_BENCH["timed"], f"phase 59: {len(steps)} "
          f"trainer.step spans, {BERT_BENCH['timed']} steps")
    kern = {name: [e for e in evs if e.get("ph") == "X"
                   and e.get("cat") == "kernel" and sym in e.get("name", "")]
            for name, sym in PROFILE_SYMBOLS.items()}
    slack = align["error_us"]
    worst = None
    for name, ks in kern.items():
        if launched.get(name, 0):
            check(ks, f"phase 59: no {name} kernel event in the profile "
                  f"({launched[name]} launches)")
        for k in ks:
            m = max(min(k["ts"] - s["ts"], s["ts"] + s["dur"] - k["ts"]
                        - k["dur"]) for s in steps)
            worst = m if worst is None else min(worst, m)
    check(worst is not None and worst >= -slack, f"phase 59: a kernel event "
          f"lies {-(worst or 0):.1f} us outside every trainer.step span "
          f"(alignment error {slack:.1f} us)")
    disp = [e for e in evs if e.get("name") == "trainer.dispatch"]
    step_ids = sorted(e.get("args", {}).get("step") for e in steps)
    check(len(disp) == len(steps) and sorted(
        e.get("args", {}).get("step") for e in disp) == step_ids
        and None not in step_ids, f"phase 59: trainer.dispatch step ids "
        f"{[e.get('args', {}).get('step') for e in disp]} against {step_ids}")
    inst = [e["args"] for e in evs if e.get("name") == "kernels.dispatch"]
    sigs = [(a["kernel"], str(a["shapes"]), str(a["dtypes"])) for a in inst]
    check(len(sigs) == len(set(sigs)) and {a["kernel"] for a in inst}
          == {k for k, n in launched.items() if n},
          f"phase 59: kernels.dispatch instants {sigs} for launches "
          f"{launched}")
    names = {e.get("name") for e in evs}
    check({"profiler.bert_steps", "profiler.smoke::steps_done"} <= names,
          "phase 59: the profiler Scope / Marker entries are missing")
    return dict(kernel_events={k: len(v) for k, v in kern.items()},
                step_spans=len(steps), align_error_us=slack,
                device=align["device"],
                worst_margin_us=worst, kernels_dispatch=len(sigs),
                document_events=len(evs))


def seams_on_card(dev):
    """The checkpoint's and the loader's seams on the card, small: one
    save_states of LeNet (ckpt.save_states around ckpt.write, ckpt.saves
    1; ckpt.write error keeps the old file byte for byte, torn commits
    half and load_states raises), a 20-batch inline LeNet drive (20
    dataloader.fetch spans), mx.np on cuda:0 against device='cpu'."""
    import itertools

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry, trace
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import MNIST, transforms
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.resilience import chaos

    out = {}
    mx.random.seed(42)
    net = mx.gluon.model_zoo.get_model("lenet")
    net.initialize(mx.init.Xavier())
    tr = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                        optimizer="sgd", learning_rate=0.05)
    rs = np.random.RandomState(59)
    x = rs.rand(64, 1, 28, 28).astype("f4")
    y = rs.randint(0, 10, 64).astype("int32")
    tr.step(x, y, block=True)
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    path = str(PROFILE_DIR / "lenet_states.npz")
    telemetry.reset()
    trace.reset()
    tr.save_states(path)
    evs = {e["name"]: e for e in trace.events()
           if e["name"].startswith("ckpt.")}
    outer, inner = evs.get("ckpt.save_states"), evs.get("ckpt.write")
    check(outer is not None and inner is not None and outer["ts"] <=
          inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"]
          + outer["dur"], f"phase 59: ckpt spans {sorted(evs)}")
    saves = telemetry.peek("ckpt.saves")
    check(saves is not None and saves.value == 1, "phase 59: ckpt.saves")
    with open(path, "rb") as f:
        saved = f.read()
    tr.step(x, y, block=True)
    try:
        chaos.configure("ckpt.write:error:1.0")
        raised = False
        try:
            tr.save_states(path)
        except chaos.ChaosError:
            raised = True
        with open(path, "rb") as f:
            kept = f.read() == saved
        check(raised and kept, f"phase 59: ckpt.write error raised "
              f"{raised}, old file kept {kept}")
        chaos.configure("ckpt.write:torn:1.0")
        tr.save_states(path)
    finally:
        chaos.reset()
    size = os.path.getsize(path)
    try:
        tr.load_states(path)
        torn_raised = False
    except Exception:
        torn_raised = True
    check(torn_raised and size < len(saved), f"phase 59: a torn write of "
          f"{size} bytes (whole {len(saved)}) loaded")
    os.remove(path)
    out["ckpt"] = dict(save_states_ms=outer["dur"] * 1e3,
                       write_ms=inner["dur"] * 1e3, bytes=len(saved),
                       torn_bytes=size)
    # the loader's span: the verify drive's loop, inline, 20 batches
    train = DataLoader(MNIST(train=True).transform_first(
        transforms.ToTensor()), batch_size=64, shuffle=True)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gtr = mx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9})
    trace.reset()
    for bx, by in itertools.islice(train, 20):
        with mx.autograd.record():
            loss = loss_fn(net(bx), by)
        loss.backward()
        gtr.step(bx.shape[0])
    torch.cuda.synchronize()
    fetch = [e for e in trace.events() if e["name"] == "dataloader.fetch"]
    steps = [e for e in trace.events() if e["name"] == "trainer.step"]
    check(len(fetch) == 20 and len(steps) == 20, f"phase 59: {len(fetch)} "
          f"dataloader.fetch and {len(steps)} trainer.step spans for 20 "
          "batches")
    out["loader"] = dict(fetch_spans=len(fetch),
                         fetch_ms_p50=statistics.median(
                             e["dur"] * 1e3 for e in fetch))
    # mx.np on the card by default, against the CPU
    a = np.random.RandomState(5).rand(64, 33).astype("f4")
    g = mx.np.array(a)
    c = mx.np.array(a, device="cpu")
    check(g.device == dev and mx.np.zeros(3).device == dev
          and mx.np.arange(5).dtype == torch.int32, "phase 59: mx.np's "
          "default device or types")
    worst = 0.0
    for fn in (lambda P, t: P.sum(t, axis=1), lambda P, t: P.mean(t),
               lambda P, t: P.std(t, axis=0), lambda P, t: P.argmax(t, 1),
               lambda P, t: P.cumsum(t, axis=1), lambda P, t: P.exp(t),
               lambda P, t: P.matmul(t, P.transpose(t)),
               lambda P, t: P.sort(t, axis=0),
               lambda P, t: P.quantile(t, 0.3, axis=1)):
        r, w = fn(mx.np, g), fn(mx.np, c)
        check(r.device == dev and r.dtype == w.dtype and r.shape == w.shape,
              "phase 59: mx.np card / CPU types or shapes")
        if r.dtype.is_floating_point:
            worst = max(worst, float((r.cpu() - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
        else:
            check(torch.equal(r.cpu(), w), "phase 59: mx.np ints differ")
    check(worst <= 1e-5, f"phase 59: mx.np card vs CPU {worst:.3e}")
    mx.random.seed(3)
    u = mx.np.random.uniform(size=20000)
    n = mx.np.random.normal(1.0, 2.0, size=20000)
    check(u.device == dev and 0 <= float(u.min()) and float(u.max()) < 1
          and abs(float(u.mean()) - 0.5) < 3 * (1 / 12 / 20000) ** 0.5
          and abs(float(n.mean()) - 1.0) < 3 * 2 / 20000 ** 0.5,
          "phase 59: mx.np.random on the card off its law")
    out["np"] = dict(worst_rel=worst)
    return out


def phase_bert_profile(dev, card):
    """Phase 59: BASELINE config #3 as bench_bert_base writes it, at full
    width: mx.random.seed(0), BERTForPretrain(get_bert("bert_12_768_12",
    vocab_size=30522, max_length=512)), mx.init.Xavier(); the first call
    on mx.np arrays; ShardedTrainer(adamw, lr 1e-4, wd 0.01, bf16) at
    B = 32, T = 128, 20 masked; 2 warm steps; the step's count
    (trace.cost: equal to the analytic count, to the CPU's count of the
    same net at B = 1, T = 32, and leaving the trainer bit for bit); 10 steps
    timed; 10 steps under mx.profiler, merged and checked; the
    utilization published from the profiled steps' time."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry, trace
    from mxnet_tpu_torch.gluon.model_zoo import BERTForPretrain, get_bert
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.trace import cost

    c = BERT_BENCH
    t_phase = time.perf_counter()
    vocab = BERT_BASE["vocab_size"]
    first, x, y = bench_bert_inputs(vocab, c["seq"], c["masked"],
                                    c["batch"])
    mx.random.seed(0)
    net = BERTForPretrain(get_bert("bert_12_768_12", vocab_size=vocab,
                                   max_length=BERT_BASE["max_length"]))
    net.initialize(mx.init.Xavier())
    ins = [mx.np.array(a) for a in first]
    check(all(t.device == dev for t in ins) and ins[0].dtype == torch.int32,
          "phase 59: mx.np.array is not int32 on cuda:0")
    mlm, nsp = net(*ins)
    check(tuple(mlm.shape) == (2, c["masked"], vocab) and tuple(nsp.shape)
          == (2, 2) and bool(torch.isfinite(mlm).all()), "phase 59: the "
          "first call's scores")
    tr = ShardedTrainer(net, pretrain_loss, optimizer="adamw",
                        learning_rate=1e-4, weight_decay=0.01,
                        compute_dtype=torch.bfloat16)
    for _ in range(c["warm"]):
        tr.step(x, y)
    tr.drain()
    built_s = time.perf_counter() - t_phase
    # the count: the CPU's of the same net at B = 1, T = 32 first (the
    # registry's key holds no device), then the card's at that shape and
    # at the bench's batch: the analytic figure, the state kept
    _, xs, ys = bench_bert_inputs(vocab, c["cpu_seq"], c["masked"],
                                  c["cpu_batch"])
    mx.random.seed(0)
    cpu_net = BERTForPretrain(get_bert(
        "bert_12_768_12", vocab_size=vocab,
        max_length=BERT_BASE["max_length"], device="cpu"))
    cpu_net.initialize(mx.init.Xavier())
    cpu_tr = ShardedTrainer(cpu_net, pretrain_loss, optimizer="adamw",
                            learning_rate=1e-4, weight_decay=0.01,
                            compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    cpu_small = cpu_tr.xla_cost((xs, ys))
    cpu_count_s = time.perf_counter() - t0
    del cpu_tr, cpu_net
    cost.reset()
    card_small = tr.xla_cost((xs, ys))
    check(cpu_small["flops"] == card_small["flops"], f"phase 59: card "
          f"{card_small['flops']} FLOPs, CPU {cpu_small['flops']} at "
          f"B={c['cpu_batch']}, T={c['cpu_seq']}")
    before = trainer_state(tr)
    t0 = time.perf_counter()
    info = tr.xla_cost((x, y))
    count_s = time.perf_counter() - t0
    want = bert_analytic_flops(c["batch"], c["seq"], c["masked"], x[2])
    check(info["flops"] == want, f"phase 59: counted {info['flops']} "
          f"FLOPs a step, analytic {want}")
    moved = same_state(before, trainer_state(tr))
    check(moved is None, f"phase 59: the count moved the trainer's {moved}")
    del before
    counted_s = time.perf_counter() - t_phase
    # timed steps, then the same under mx.profiler
    n = c["timed"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        tr.step(x, y)
    tr.drain()
    plain_s = time.perf_counter() - t0
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    mx.profiler.set_config(filename=str(PROFILE_DIR / "bert.json"))
    trace.reset()
    registry._DISPATCHED.clear()      # the signatures' instants, again
    registry.reset_launches()
    telemetry.reset()
    marker = mx.profiler.Domain("smoke").new_marker("steps_done")
    mx.profiler.set_state("run")
    t0 = time.perf_counter()
    with mx.profiler.Scope("bert_steps"):
        for _ in range(n):
            tr.step(x, y)
        tr.drain()
    prof_s = time.perf_counter() - t0
    marker.mark()
    mx.profiler.set_state("stop")
    launched = {k: v for k, v in registry.launches().items() if v}
    for name, per_step in (("flash_attention.bf16", 12),
                           ("flash_attention_bwd_dkv.bf16", 12)):
        check(launched.get(name, 0) == per_step * n, f"phase 59: {name} "
              f"launched {launched.get(name, 0)} times in {n} steps")
    path = mx.profiler._state["trace"]
    with open(path) as f:
        doc = json.load(f)
    prof = profile_doc_checks(doc, launched)
    del doc
    cols = tr.publish_xla_utilization((x, y), prof_s / n)
    util = cols["xla_utilization"]
    check(util is not None and 0 < util <= 1.05, f"phase 59: utilization "
          f"{util}")
    gauge = telemetry.peek("trainer.xla_utilization")
    check(gauge is not None and gauge.value == util, f"phase 59: gauge "
          f"{gauge and gauge.value}, returned {util}")
    plain_util = info["flops"] / (plain_s / n) / 989e12
    check(0 < plain_util <= 1.05, f"phase 59: unprofiled utilization "
          f"{plain_util}")
    for f_ in (path, mx.profiler._state["raw"]):
        os.remove(f_)
    del tr, net
    torch.cuda.empty_cache()
    profiled_s = time.perf_counter() - t_phase
    seams = seams_on_card(dev)
    secs = time.perf_counter() - t_phase
    out = dict(flops_per_step=info["flops"], bytes_per_step=info[
        "bytes_accessed"], analytic_flops=want,
        count_s=count_s,
        cpu_count=dict(batch=c["cpu_batch"], seq=c["cpu_seq"],
                       flops=cpu_small["flops"],
                       bytes=cpu_small["bytes_accessed"],
                       card_bytes=card_small["bytes_accessed"],
                       seconds=cpu_count_s),
        step_ms_profiled=prof_s / n * 1e3, step_ms=plain_s / n * 1e3,
        samples_per_s=c["batch"] * n / plain_s,
        tflops_per_s=info["flops"] / (prof_s / n) / 1e12,
        tflops_per_s_unprofiled=info["flops"] / (plain_s / n) / 1e12,
        utilization=util, utilization_unprofiled=plain_util,
        columns=cols, launches=launched, profile=prof, seams=seams,
        phase_s=secs, seconds_to=dict(built=built_s, counted=counted_s,
                                      profiled=profiled_s, seams=secs),
        card=card)
    check(secs <= 40.0, f"phase 59 took {secs:.1f} s (built "
          f"{built_s:.1f}, counted {counted_s:.1f}, profiled "
          f"{profiled_s:.1f})")
    print(f"phase 59 BERT-base bf16 from mx.np (B={c['batch']}, T="
          f"{c['seq']}, {c['masked']} masked, adamw): "
          f"{info['flops']:.6e} FLOPs a step (= analytic; CPU count of the "
          f"same net at B={c['cpu_batch']}, T={c['cpu_seq']} equal: "
          f"{cpu_small['flops']:.6e} "
          f"FLOPs, bytes card {card_small['bytes_accessed']:.6e} / CPU "
          f"{cpu_small['bytes_accessed']:.6e}, {cpu_count_s:.1f} s),"
          f" {info['bytes_accessed']:.6e} bytes a step (an upper bound); "
          f"step {prof_s / n * 1e3:.3f} ms profiled, {plain_s / n * 1e3:.3f}"
          f" ms not; {out['tflops_per_s']:.3f} TFLOP/s, "
          f"trainer.xla_utilization {util:.6f} of 989 TFLOP/s "
          f"({plain_util:.6f} unprofiled); kernel events inside "
          f"trainer.step spans (worst margin {prof['worst_margin_us']:.1f} "
          f"us, alignment error {prof['align_error_us']:.1f} us); seams: "
          f"ckpt {seams['ckpt']}, {seams['loader']['fetch_spans']} fetch "
          f"spans, mx.np card vs CPU {seams['np']['worst_rel']:.2e}; "
          f"{secs:.1f} s (built {built_s:.1f}, counted {counted_s:.1f}, "
          f"profiled {profiled_s:.1f}) [{card}]")
    return out


# ------------------------------ the network edge and the replica fleet (A5b)
# phase 60: two replica processes of this file's ``fleet_spec`` behind a
# Router; 4 clients x 16 requests, every other one a streamed generate
FLEET = dict(replicas=2, clients=4, per_client=16, spawn_timeout=300.0,
             kill_bound_s=300.0, chaos_requests=10)
# the batch tier's settings in each replica: phase 7's Server
FLEET_ENV = {"MXNET_SERVE_MAX_WAIT_MS": "5", "MXNET_SERVE_MAX_BATCH": "16"}
FLEET_SECS, EDGE_SECS, BUCKETED_SECS = 60.0, 10.0, 20.0


def pooled_bert(dev):
    """``bert_12_768_12`` as phase 7 builds it, answering its pooled
    [CLS] vector a request (what a classifier head reads): 768 floats
    of JSON an answer, not a (T, 768) sequence."""
    from mxnet_tpu_torch.gluon.block import HybridBlock
    from mxnet_tpu_torch.gluon.model_zoo import bert_12_768_12

    class PooledBert(HybridBlock):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, token_types, valid_length):
            return self.bert(tokens, token_types, valid_length)[1]

    return PooledBert(xavier_init(bert_12_768_12(
        dropout=0.0, device=dev, **BERT_BASE), 0))


BERT_SAMPLE = (np.zeros(32, np.int32), np.zeros(32, np.int32),
               np.asarray(32, np.int32))


def fleet_spec():
    """Phase 60's replica spec, run inside each worker process: phase 4's
    GPT-2 small behind ``serve.register_decode`` and phase 7's BERT-base
    behind ``serve.register``, both warmed on the card; READY carries the
    kernel launches of the warmup and the peak memory."""
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm
    from mxnet_tpu_torch.kernels import registry

    dev = torch.device("cuda", 0)
    lm = xavier_init(transformer_lm(device=dev, **GPT2_SMALL), 0)
    serve.register_decode("gpt2s", lm, **SERVE_CFG)
    serve.register("bert", pooled_bert(dev), bucketer=BERT_BUCKETS,
                   sample=BERT_SAMPLE)
    torch.cuda.synchronize()
    return {"launches": registry.launches(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def fleet_traffic(seed=60):
    """The clients' requests, in order: even ones generate (prompts of
    32-256 tokens), odd ones predict (BERT requests of 16-512 tokens)."""
    n = FLEET["clients"] * FLEET["per_client"]
    rs = np.random.RandomState(seed)
    vocab = GPT2_SMALL["vocab_size"]
    prompts = [rs.randint(0, vocab, size=int(k)).tolist()
               for k in rs.randint(32, 257, size=n // 2)]
    return prompts, bert_requests(n // 2, seed)


def mx_threads():
    import threading

    return {t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("mx-")}


def fleet_load(router, prompts, reqs):
    """4 client threads, 16 requests each, through ``router``: returns
    each generate's (tokens, TTFT, first and last chunk times) and each
    predict's answer, with the wall time."""
    import threading

    per = FLEET["per_client"]
    gens, preds, errors = {}, {}, []

    def client(c):
        for j in range(per):
            i = c * per + j
            try:
                t0 = time.perf_counter()
                if j % 2 == 0:
                    k = i // 2
                    out = router.generate("gpt2s", prompts[k], stream=True,
                                          timeout=600.0)
                    ts = out["chunk_ts"]
                    gens[k] = dict(tokens=out["tokens"],
                                   finish=out["finish_reason"],
                                   ttft=ts[0] - t0 if ts else None,
                                   first=ts[0] if ts else None,
                                   last=ts[-1] if ts else None)
                else:
                    k = i // 2
                    out = router.predict("bert", [reqs[k]], timeout=600.0,
                                         dtype=["int32"] * 3)
                    preds[k] = np.asarray(out["outputs"][0], np.float32)
            except Exception as e:  # noqa: BLE001 — checked below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"smoke-fleet-client-{c}")
               for c in range(FLEET["clients"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900.0)
    return gens, preds, errors, time.perf_counter() - t0


def fleet_references(dev, prompts, reqs):
    """The same models served in this process on the card: the decode
    answers (every prompt queued at once) and the batch answers through
    phase 7's ``Server``."""
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm

    lm = xavier_init(transformer_lm(device=dev, **GPT2_SMALL), 0)
    serve.register_decode("gpt2s_ref", lm, **SERVE_CFG)
    srv = serve.decode_server("gpt2s_ref")
    with srv._cv:
        futs = [srv.submit(p) for p in prompts]
    want = [f.result(600.0) for f in futs]
    bert = pooled_bert(dev)
    serve.register("bert_ref", bert, bucketer=BERT_BUCKETS,
                   sample=BERT_SAMPLE)
    bsrv = serve.Server(max_wait_ms=5, max_batch=16)
    bwant = [f.result(600.0) for f in [bsrv.submit("bert_ref", *r)
                                       for r in reqs]]
    bsrv.close(120.0)
    serve.unregister("bert_ref")
    del bert
    return lm, want, bwant


def replica_launches(rep):
    """A replica's kernel launch counts now, from its ``/statusz``."""
    import urllib.request

    with urllib.request.urlopen(rep.obs_url + "/statusz",
                                timeout=30.0) as r:
        return json.loads(r.read())["kernel_launches"]


def fleet_kill(fleet):
    """Two predict loaders against the fleet; SIGKILL one replica under
    them and wait for the respawn to be READY: returns the loaders'
    outcomes and the kill-to-ready seconds."""
    import signal
    import threading

    from mxnet_tpu_torch.serve import RejectedError

    reqs = bert_requests(8, seed=61)
    stop = threading.Event()
    outcomes = []

    def loader(c):
        i = 0
        while not stop.is_set():
            r = reqs[(c + i) % len(reqs)]
            i += 1
            try:
                out = fleet.router.predict("bert", [r], timeout=600.0,
                                           dtype=["int32"] * 3)
                a = np.asarray(out["outputs"][0], np.float32)
                outcomes.append("ok" if a.shape == (768,) and
                                np.isfinite(a).all() else "bad")
            except RejectedError:
                outcomes.append("shed")
            except Exception as e:  # noqa: BLE001 — checked below
                outcomes.append(f"error: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=loader, args=(c,),
                                name=f"smoke-fleet-load-{c}")
               for c in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    victim = fleet.ready_replicas()[0]
    before = len(outcomes)
    os.kill(victim.pid, signal.SIGKILL)
    t_kill = time.perf_counter()
    ready_s = None
    while time.perf_counter() - t_kill < FLEET["kill_bound_s"]:
        if fleet.stats["respawns"] >= 1 and \
                len(fleet.ready_replicas()) >= FLEET["replicas"]:
            ready_s = time.perf_counter() - t_kill
            break
        time.sleep(0.05)
    time.sleep(0.5)              # the load goes on against the new replica
    stop.set()
    for t in threads:
        t.join(600.0)
    return outcomes, before, ready_s, victim.pid


def phase_fleet(dev, card):
    """Phase 60: two replica processes of ``fleet_spec`` on the one card
    behind ``Fleet(min_replicas=2, max_replicas=2)``; streamed GPT-2
    small generates and ragged BERT-base predicts from 4 clients; a
    SIGKILL under load; ``fleet.dispatch`` chaos; a clean close."""
    import threading

    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.resilience import chaos

    t_phase = time.perf_counter()
    threads_before = mx_threads()
    telemetry.set_enabled(True)
    prompts, reqs = fleet_traffic()
    box = {}

    def boot():
        try:
            box["fleet"] = serve.Fleet(
                f"{Path(__file__).resolve()}:fleet_spec",
                min_replicas=FLEET["replicas"],
                max_replicas=FLEET["replicas"], env=FLEET_ENV,
                spawn_timeout=FLEET["spawn_timeout"])
        except BaseException as e:  # noqa: BLE001 — raised below
            box["error"] = e

    # the replicas boot while this process serves the references
    booter = threading.Thread(target=boot, name="smoke-fleet-boot")
    booter.start()
    lm, want, bwant = fleet_references(dev, prompts, reqs)
    refs_s = time.perf_counter() - t_phase
    booter.join(FLEET["spawn_timeout"] * 2)
    if "error" in box:
        raise box["error"]
    fleet = box["fleet"]
    boot_s = time.perf_counter() - t_phase
    try:
        reps = fleet.ready_replicas()
        check(len(reps) == FLEET["replicas"] and len({r.pid for r in reps})
              == FLEET["replicas"], f"phase 60: replicas {reps}")
        for r in reps:
            ln = r.doc["launches"]
            check(ln["flash_attention_decode"] > 0 and
                  ln["flash_attention"] > 0, f"phase 60: replica {r.idx}'s "
                  f"warmup launched {ln}")
        # the routed traffic's own launches: each replica's counts read
        # from its /statusz once it is READY and again after the load
        at_ready = {r.idx: replica_launches(r) for r in reps}
        telemetry.reset()
        gens, preds, errors, wall = fleet_load(fleet.router, prompts, reqs)
        served = {}
        for r in reps:
            now = replica_launches(r)
            served[r.idx] = {k: v - at_ready[r.idx].get(k, 0)
                             for k, v in now.items()
                             if v - at_ready[r.idx].get(k, 0)}
            check(served[r.idx].get("flash_attention_decode", 0) > 0 and
                  served[r.idx].get("flash_attention", 0) > 0,
                  f"phase 60: replica {r.idx}'s routed traffic launched "
                  f"{served[r.idx]}")
        check(not errors, f"phase 60: {errors[:3]}")
        check(len(gens) == len(prompts) and len(preds) == len(reqs),
              f"phase 60: {len(gens)} generates, {len(preds)} predicts")
        got = [gens[k]["tokens"] for k in range(len(prompts))]
        # incremental: the first chunk 63 decode steps before the last
        check(all(g["last"] - g["first"] >= 0.02 for g in gens.values()),
              "phase 60: a stream's first chunk came with its last")
        check(all(g["finish"] == "length" and len(g["tokens"]) ==
                  SERVE_CFG["max_new_tokens"] for g in gens.values()),
              "phase 60: a stream resolved short")
        same = sum(g == w for g, w in zip(got, want))
        ties = pool_ties(lm, prompts, want, got, "phase 60")
        worst = 0.0
        for k, (a, w) in enumerate(zip((preds[i] for i in range(len(reqs))),
                                       bwant)):
            err = float(np.abs(a - w).max()) / float(np.abs(w).max())
            check(np.isfinite(a).all() and err <= 1e-4, f"phase 60: "
                  f"predict {k} is {err:.3e} x max|ref| off the in-process "
                  "Server's")
            worst = max(worst, err)
        ttft = sorted(g["ttft"] for g in gens.values())
        tokens = sum(len(g) for g in got)
        load = dict(requests=len(gens) + len(preds), wall_s=wall,
                    requests_per_s=(len(gens) + len(preds)) / wall,
                    stream_tokens_per_s=tokens / wall,
                    ttft_p50_ms=pct(ttft, 0.5) * 1e3,
                    ttft_p99_ms=pct(ttft, 0.99) * 1e3,
                    streams_equal=same, streams_at_near_ties=len(ties),
                    predict_worst_rel=worst)
        # a replica killed under load; its respawn READY again
        outcomes, before, ready_s, victim = fleet_kill(fleet)
        bad = [o for o in outcomes if o not in ("ok", "shed")]
        check(not bad, f"phase 60: admitted requests lost to the kill: "
              f"{bad[:3]}")
        check(ready_s is not None, "phase 60: no replica READY again within "
              f"{FLEET['kill_bound_s']} s of the kill")
        check(len(outcomes) > before, "phase 60: no request answered after "
              "the kill")
        new = [r for r in fleet.ready_replicas() if r.pid != victim]
        check(len(new) == FLEET["replicas"] and all(
            r.doc["launches"]["flash_attention_decode"] > 0 and
            r.doc["launches"]["flash_attention"] > 0 for r in new),
            f"phase 60: the fleet after the respawn {new}")
        kill = dict(requests=len(outcomes), ok=outcomes.count("ok"),
                    shed=outcomes.count("shed"), kill_to_ready_s=ready_s,
                    recovery_s=fleet.stats["recoveries_secs"],
                    respawns=fleet.stats["respawns"])
        # fleet.dispatch chaos: every predict still answered
        retries0 = telemetry.snapshot().get(
            "fleet.dispatch_retries", {"value": 0})["value"]
        chaos.configure("fleet.dispatch:error:0.5", seed=7)
        try:
            chaos_out = [fleet.router.predict(
                "bert", [reqs[i % len(reqs)]], timeout=600.0,
                dtype=["int32"] * 3) for i in range(FLEET["chaos_requests"])]
        finally:
            chaos.reset()
        retries = telemetry.snapshot()["fleet.dispatch_retries"]["value"] - \
            retries0
        check(all(len(o["outputs"][0]) == 768 for o in chaos_out) and
              retries > 0, f"phase 60: chaos {retries} retries")
        replicas = [dict(idx=r.idx, pid=r.pid,
                         startup_s=r.startup_secs,
                         build_s=r.doc["build_secs"],
                         captures=r.doc["warmup_compiles"],
                         max_memory_allocated=r.doc["max_memory_allocated"],
                         launches_warmup={k: v for k, v in r.doc[
                             "launches"].items() if v},
                         launches_served=served.get(r.idx))
                    for r in fleet.replicas()]
        launches_served = [served[r.idx] for r in reps]
        stats = dict(fleet.stats)
    finally:
        fleet.close(120.0)
        serve.shutdown_decode(120.0)
        serve.unregister("bert")
    left = sorted(mx_threads() - threads_before)
    check(not left, f"phase 60: threads left after Fleet.close(): {left}")
    secs = time.perf_counter() - t_phase
    out = dict(load=load, kill=kill, chaos_retries=retries,
               replicas=replicas, launches_served=launches_served,
               cold_start_s=stats["cold_start_secs"],
               cold_build_s=stats["cold_build_secs"],
               initial_start_s=stats["initial_start_secs"],
               warm_start_s=stats["warm_start_secs"],
               warm_build_s=stats["warm_build_secs"],
               kernel_build_s=stats["kernel_build_secs"],
               refs_s=refs_s, boot_s=boot_s, phase_s=secs, card=card)
    print(f"  replicas {[(r['pid'], r['startup_s'], r['build_s'], r['max_memory_allocated']) for r in replicas]} "
          f"(pid, startup s, build s, peak bytes); launches of the routed "
          f"traffic by replica {launches_served}; kill: {kill}; chaos: "
          f"{FLEET['chaos_requests']} predicts, {retries} dispatch retries")
    print(f"phase 60 fleet of {FLEET['replicas']} replicas (GPT-2 small + "
          f"BERT-base each): {load['requests']} routed requests in "
          f"{wall:.3f} s = {load['requests_per_s']:.2f} requests/s, streams "
          f"{load['stream_tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{load['ttft_p50_ms']:.2f} ms p99 {load['ttft_p99_ms']:.2f} ms; "
          f"{same} of {len(got)} streams equal the in-process server's, "
          f"{len(ties)} leave it at near ties; predicts within "
          f"{worst:.3e} x max|ref|; cold start "
          f"{stats['cold_start_secs']} s (build {stats['cold_build_secs']} s),"
          f" respawn start {stats['warm_start_secs']} s (build "
          f"{stats['warm_build_secs']} s), kill to ready {ready_s:.2f} s; "
          f"{secs:.1f} s (references {refs_s:.1f}, booted {boot_s:.1f}) "
          f"[{card}]")
    check(secs <= FLEET_SECS, f"phase 60 took {secs:.1f} s")
    return out, lm


def sse_frames(sock):
    """Read an SSE response from a raw socket until its first data frame."""
    buf = b""
    while b"data:" not in buf:
        chunk = sock.recv(4096)
        check(chunk, "phase 61: the stream closed before its first token")
        buf += chunk
    return buf


def phase_edge(dev, card, lm):
    """Phase 61: one ``EdgeServer`` in this process over phase 60's
    in-process GPT-2 small decode server on the card: a deadline that
    expires mid-generate answers 504 and frees its slot; a client that
    hangs up mid-stream cancels its request; ``close()`` drains a stream
    in flight."""
    import socket
    import struct
    import threading
    import urllib.error
    import urllib.request

    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.serve.edge import DEADLINE_HEADER, EdgeServer

    t_phase = time.perf_counter()
    serve.register_decode("gpt2s_edge", lm, **SERVE_CFG)
    dsrv = serve.decode_server("gpt2s_edge")
    telemetry.set_enabled(True)
    telemetry.reset()

    def slots():
        return telemetry.snapshot().get("serve.decode_slots_active",
                                        {"value": 0})["value"]

    def settle(what):
        deadline = time.monotonic() + 60.0
        while slots() and time.monotonic() < deadline:
            time.sleep(0.01)
        check(slots() == 0, f"phase 61: a slot still held after {what}")

    def slow(tok):
        if tok is not None:
            time.sleep(0.03)

    prompt = fleet_traffic()[0][0]
    edge = EdgeServer(port=0)
    try:
        # a deadline that expires mid-generate: 504, the slot freed
        anchor = dsrv.submit(prompt, max_new_tokens=40, on_token=slow)
        req = urllib.request.Request(
            edge.url + "/v1/generate", data=json.dumps(
                {"model": "gpt2s_edge", "prompt": prompt, "stream": False,
                 "max_new_tokens": 40}).encode(),
            headers={DEADLINE_HEADER: "300"})
        try:
            urllib.request.urlopen(req, timeout=120.0)
            code, doc = 200, {}
        except urllib.error.HTTPError as e:
            code, doc = e.code, json.loads(e.read())
        check(code == 504 and doc.get("finish_reason") == "deadline" and
              0 < len(doc["tokens"]) < 40, f"phase 61: deadline answered "
              f"{code} {doc.get('finish_reason')}")
        anchor.result(120.0)
        settle("the deadline")
        # a client that hangs up mid-stream
        anchor = dsrv.submit(prompt, max_new_tokens=40, on_token=slow)
        body = json.dumps({"model": "gpt2s_edge", "prompt": prompt,
                           "max_new_tokens": 40}).encode()
        s = socket.create_connection(("127.0.0.1", edge.port), timeout=60.0)
        try:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
                      b"Content-Type: application/json\r\nContent-Length: "
                      + str(len(body)).encode() + b"\r\n\r\n" + body)
            sse_frames(s)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
        finally:
            s.close()
        deadline = time.monotonic() + 60.0
        while telemetry.snapshot().get("serve.cancelled", {"value": 0})[
                "value"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        check(telemetry.snapshot().get("serve.cancelled", {"value": 0})[
            "value"] >= 1, "phase 61: the hang-up did not cancel")
        anchor.result(120.0)
        settle("the hang-up")
        # close() drains a stream in flight; the launches counted from
        # here on are the drained request's alone, which only the edge
        # serves
        got = {}
        registry.reset_launches()

        def reader():
            conn = urllib.request.urlopen(urllib.request.Request(
                edge.url + "/v1/generate", data=json.dumps(
                    {"model": "gpt2s_edge", "prompt": prompt}).encode()),
                timeout=120.0)
            got["body"] = conn.read().decode()

        t = threading.Thread(target=reader, name="smoke-edge-reader")
        t.start()
        deadline = time.monotonic() + 60.0
        while edge.inflight() == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        t_close = time.perf_counter()
        edge.close(120.0)
        close_s = time.perf_counter() - t_close
        t.join(120.0)
        launches = registry.launches()
    finally:
        edge.close(120.0)
    frames = [json.loads(l[len("data: "):]) for l in
              got.get("body", "").splitlines() if l.startswith("data: ")]
    check(len(frames) == SERVE_CFG["max_new_tokens"] + 1 and
          frames[-1].get("finish_reason") == "length",
          f"phase 61: the drained stream ended with {frames[-1:]}")
    want = dsrv.generate(prompt, timeout=120.0)
    check([f["token"] for f in frames[:-1]] == want, "phase 61: the "
          "drained stream's tokens differ from a direct submit's")
    serve.shutdown_decode(120.0)
    check(launches["flash_attention_decode"] > 0, "phase 61: the decode "
          f"kernel was not launched by the edge's request: {launches}")
    secs = time.perf_counter() - t_phase
    out = dict(deadline_code=code, drain_close_s=close_s,
               launches={k: v for k, v in launches.items() if v},
               phase_s=secs, card=card)
    print(f"phase 61 the edge in process over GPT-2 small: a mid-generate "
          f"deadline answered 504 ({len(doc['tokens'])} tokens) and freed "
          f"its slot, a hang-up cancelled its request, close() drained a "
          f"stream of {len(frames) - 1} tokens in {close_s:.3f} s; launches "
          f"{out['launches']}; {secs:.1f} s [{card}]")
    check(secs <= EDGE_SECS, f"phase 61 took {secs:.1f} s")
    return out


# phase 62: bench_bert's pretraining (bf16, adamw) from a bucketed,
# prefetching loader (docs/jit.md, "Putting it together";
# docs/pipeline.md, "Usage"): rows of 20-128 tokens, 20 masked a row,
# batches padded to the batch's longest row, then to its bucket
BUCKETED = dict(batch=32, steps=20, tail=25, lengths=(20, 128), masked=20,
                spec={1: ("pow2", 32, 128)})


def bucketed_dataset(seed=62):
    """``steps - 1`` full batches and a tail of ``tail`` rows, in length
    order (a length-grouped stream): tokens, token types (a second
    segment from mid-row), the row's valid length, masked positions
    inside the row, their weights (1), MLM labels and an NSP label."""
    c = BUCKETED
    rs = np.random.RandomState(seed)
    vocab = BERT_BASE["vocab_size"]
    n = c["batch"] * (c["steps"] - 1) + c["tail"]
    samples = []
    for t in np.sort(rs.randint(c["lengths"][0], c["lengths"][1] + 1, n)):
        types = np.zeros(t, np.int32)
        types[t // 2:] = 1
        samples.append((
            rs.randint(0, vocab, t).astype(np.int32), types, np.int32(t),
            np.sort(rs.choice(t, c["masked"], replace=False)).astype(
                np.int32),
            np.ones(c["masked"], np.float32),
            rs.randint(0, vocab, c["masked"]).astype(np.int32),
            np.int32(rs.randint(0, 2))))
    return samples


def pad_batchify(samples):
    """A text pipeline's batchify: tokens and types padded to the batch's
    longest row, the valid lengths and fixed-width leaves stacked."""
    t = max(len(s[0]) for s in samples)
    tok = np.zeros((len(samples), t), np.int32)
    typ = np.zeros((len(samples), t), np.int32)
    for i, s in enumerate(samples):
        tok[i, :len(s[0])] = s[0]
        typ[i, :len(s[1])] = s[1]
    return (tok, typ) + tuple(np.stack([s[j] for s in samples])
                              for j in range(2, 7))


def bucketed_loss(pred, label):
    """The pretraining loss of a padded batch: the masked-LM cross
    entropy over a row's real masked positions (weight 1; padded ones
    weigh 0) plus the next-sentence one, for the rows the mask keeps,
    scaled so the trainer's mean is over those rows alone."""
    (mlm, nsp), (mlm_y, w, nsp_y, mask) = pred, label
    lp = torch.log_softmax(mlm.float(), -1).gather(
        -1, mlm_y.long()[..., None])[..., 0]
    w = w.float()
    mlm_ce = -(lp * w).sum(1) / w.sum(1).clamp(min=1.0)
    nsp_ce = -torch.log_softmax(nsp.float(), -1).gather(
        -1, nsp_y.long()[:, None])[:, 0]
    rows = mask[:, 0].float()
    return (mlm_ce + nsp_ce) * rows * (rows.numel() / rows.sum())


def bucketed_run(dev, data, prefetch):
    """BERT-base from ``mx.random.seed(0)``, ``ShardedTrainer("adamw",
    bf16)`` as phase 24 sets it, over one epoch of the bucketed loader,
    prefetching to the trainer or inline."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer

    c = BUCKETED
    mxrandom.seed(0)
    net = pretrain_model(dev, dropout=0.1)
    tr = ShardedTrainer(net, bucketed_loss, optimizer="adamw",
                        learning_rate=1e-4, weight_decay=0.01,
                        compute_dtype=torch.bfloat16)
    loader = DataLoader(data, batch_size=c["batch"], last_batch="keep",
                        pin_memory=True, batchify_fn=pad_batchify,
                        bucket_spec=c["spec"], device=dev,
                        prefetch_to_device=tr if prefetch else None)
    torch.cuda.synchronize()
    telemetry.set_enabled(True)
    telemetry.reset()
    registry.reset_launches()
    losses, shapes, steps = [], [], []
    t0 = last = time.perf_counter()
    for tok, typ, vl, pos, w, mlm_y, nsp_y, mask in loader:
        # each row attends to its own tokens (the rows that fill a
        # tail batch have valid length 0; the mask drops their loss)
        shapes.append(tuple(tok.shape) + tuple(pos.shape[1:]))
        losses.append(tr.step((tok, typ, vl, pos), (mlm_y, w, nsp_y, mask)))
        now = time.perf_counter()
        steps.append(now - last)
        last = now
    tr.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loader.close()
    snap = telemetry.snapshot()
    wait = snap["dataloader.wait_seconds"]
    out = dict(losses=[float(v) for v in losses], shapes=shapes,
               samples=len(data), wall_s=wall,
               samples_per_s=len(data) / wall,
               step_p50_ms=statistics.median(steps) * 1e3,
               wait_p50_ms=wait["p50"] * 1e3, wait_share=wait["total"] / wall,
               padded_batches=snap.get("dataloader.padded_batches",
                                       {"value": 0})["value"],
               launches={k: v for k, v in registry.launches().items() if v})
    del tr, net, loader
    torch.cuda.empty_cache()
    return out


def phase_bucketed(dev, card):
    """Phase 62: BERT-base bf16 pretraining from a bucketed loader, one
    epoch (20 batches) prefetched to the trainer and the same batches
    inline, after a warm pass over one batch of each bucket: the same
    losses bit for bit, every batch a bucket shape, the prefetched loop
    waiting less."""
    c = BUCKETED
    t_phase = time.perf_counter()
    data = bucketed_dataset()
    # one batch of each bucket first, so neither timed run pays the
    # process's first steps at a shape (cuBLAS's choices, the allocator)
    n = len(data)
    bucketed_run(dev, data[:32] + data[n // 2:n // 2 + 32] + data[-32:],
                 False)
    runs = {mode: bucketed_run(dev, data, mode == "prefetch")
            for mode in ("prefetch", "inline")}
    pf, il = runs["prefetch"], runs["inline"]
    check(len(pf["losses"]) == c["steps"] == len(il["losses"]),
          f"phase 62: {len(pf['losses'])} / {len(il['losses'])} steps")
    check(pf["losses"] == il["losses"], "phase 62: prefetched and inline "
          f"losses differ: {pf['losses'][:3]} / {il['losses'][:3]}")
    check(all(math.isfinite(v) for v in pf["losses"]), "phase 62: a loss "
          "is not finite")
    buckets = {(c["batch"], t, 32) for t in (32, 64, 128)}
    check(set(pf["shapes"]) <= buckets and pf["shapes"] == il["shapes"],
          f"phase 62: batch shapes {sorted(set(pf['shapes']))}")
    check(pf["wait_p50_ms"] < il["wait_p50_ms"], f"phase 62: prefetched "
          f"wait p50 {pf['wait_p50_ms']:.4f} ms, inline "
          f"{il['wait_p50_ms']:.4f} ms")
    for name in ("flash_attention.bf16", "flash_attention_bwd_dkv.bf16"):
        check(pf["launches"].get(name, 0) == 12 * c["steps"], f"phase 62: "
              f"{name} launched {pf['launches'].get(name, 0)} times")
    secs = time.perf_counter() - t_phase
    out = dict(runs=runs, shapes=sorted(set(pf["shapes"])), phase_s=secs,
               card=card)
    print(f"phase 62 BERT-base bf16 from a bucketed loader (B="
          f"{c['batch']}, rows {c['lengths'][0]}-{c['lengths'][1]} tokens, "
          f"buckets {out['shapes']}): prefetched {pf['samples_per_s']:.1f} "
          f"samples/s, step p50 {pf['step_p50_ms']:.3f} ms, wait p50 "
          f"{pf['wait_p50_ms']:.4f} ms, wait share {pf['wait_share']:.4f}; "
          f"inline {il['samples_per_s']:.1f} samples/s, step p50 "
          f"{il['step_p50_ms']:.3f} ms, wait p50 {il['wait_p50_ms']:.4f} ms,"
          f" wait share {il['wait_share']:.4f}; losses equal bit for bit "
          f"over {c['steps']} steps; launches {pf['launches']}; {secs:.1f} s"
          f" [{card}]")
    check(secs <= BUCKETED_SECS, f"phase 62 took {secs:.1f} s")
    return out


# ------------------------------------------- phase 63: data parallelism
# bench.py --multichip's two configurations as _mc_measure builds them on
# a TPU: ResNet-50 v1 (NHWC, 224^2, 64 a device, bf16, sgd momentum 0.9,
# lr 0.05) and BERT-base pretraining (bf16, 8 a device, seq 128, 20
# predictions, lr 1e-4, wd 0.01).  bench's adamw is not arena-fusible
# (the JAX trainer's _ArenaOptAdapter.supports), and zero1 with the
# arena and overlap=True take only sgd / momentum / adam, so BERT trains
# with adam at bench's lr and wd here.  The ResNet is the fused
# BatchNorm + relu variant, whose BatchNorms run the bn_act kernels.
DP = dict(resnet=dict(per=64, image=224, classes=1000),
          bert=dict(per=8, seq=128, npred=20, vocab=30522))
DP_WARM, DP_TIMED, DP_PAIR_STEPS = 2, 5, 3
DP_SECS = 120.0               # the phase's budget (both parts)
DP_RANK_SECS = 90.0           # part (b)'s ranks are killed past this
# Part (b)'s bars, each an earlier phase's stated rule.  Everything is
# held at step 1, the one step whose inputs (the weights, the global
# batch) the two-rank and the one-rank runs share exactly: the step-1
# loss (a forward from the same weights) and the state after step 1.
# Later steps start from states that already differ by that step's
# rounding, which a random-label ResNet at lr 0.05 amplifies (its loss
# rises 7.35 -> 8.8-9.2 in three steps), so their losses are printed and
# must be finite, and are not held.
# - f32, phase 16's rule for a ResNet step (card vs CPU): ResNet-50 in
#   f32 (TF32 off) on two ranks against one rank.  The step-1 loss within
#   1e-4 relative and each running statistic within 1e-5 + 1e-5 x |its
#   value|: both are the forward's, from the same weights and the same
#   global batch, so sums in another order move them by f32 rounding,
#   while a batch norm on one rank's rows moves each statistic by its
#   sampling error over half the rows.  A control world
#   (ops.nn.batch_stats_group(None): local statistics) must fail this
#   bar.  The parameters are not held in f32: a conv feeding a batch norm
#   gets a gradient that cancels (it is orthogonal to the weight), and on
#   the CPU at 64x64, B = 8, one rank on the same rows in another order
#   moves such tensors' displacement by 21-22% of its max
#   (tools/torch_dp_f32_rounding.py), phase 45's finding in SSD.  Their
#   worst distance is printed; the bf16 rule below holds them, and the
#   CPU tests hold them to the JAX dp meshes at 1e-5.
# - bf16, phase 30's rule: both configurations in bf16 on two ranks
#   against one rank.  The step-1 loss within max(HALF_LOSS_RTOL, 3 x the
#   one-rank bf16 run's relative distance from its f32 run); each
#   parameter's and running statistic's displacement from its initial
#   value within max(2^-4 x max|the one-rank displacement|, 3 x max|one
#   rank in bf16 - one rank in f32|).  A bf16 control with local
#   statistics is run and reported, not held: on the card this bar does
#   not see it (PERF.md section 6), and the f32 pair does.
DP_F32_LOSS_RTOL = 1e-4
DP_F32_STAT_TOL = 1e-5        # absolute and relative
DP_LOSS_RTOL = HALF_LOSS_RTOL


def dp_net(kind, dev, dropout=0.1):
    """The net of bench's ``kind`` configuration on ``dev`` (xavier, seed
    0) and its loss."""
    from mxnet_tpu_torch import test_utils as tu

    if kind == "resnet":
        net, loss = tu.dp_model("resnet50_v1", None, device=dev,
                                layout="NHWC", fused_bn_relu=True,
                                classes=DP["resnet"]["classes"])
        return xavier_init(net, 0), resnet_ce
    net, loss = tu.dp_model("bert", None, device=dev, **dp_bert_kw(dropout))
    return xavier_init(net, 0), loss


def dp_bert_kw(dropout):
    return dict(vocab_size=DP["bert"]["vocab"], max_length=512,
                num_layers=12, units=768, hidden_size=3072, num_heads=12,
                dropout=dropout)


def dp_trainer_kw(kind, dt=torch.bfloat16, **extra):
    if kind == "resnet":
        kw = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9)
    else:
        kw = dict(optimizer="adam", learning_rate=1e-4, weight_decay=0.01)
    return dict(kw, compute_dtype=dt, **extra)


def dp_spec(kind, b, steps, seed=63):
    c = DP[kind]
    if kind == "resnet":
        return dict(kind="resnet", b=b, image=c["image"],
                    classes=c["classes"], seed=seed, steps=steps)
    return dict(kind="bert", b=b, seq=c["seq"], npred=c["npred"],
                vocab=c["vocab"], seed=seed, steps=steps)


def dp_on(batch, dev):
    if isinstance(batch, (tuple, list)):
        return tuple(dp_on(e, dev) for e in batch)
    return torch.from_numpy(batch).to(dev)


def phase_dp_one_rank(dev, card, workdir):
    """Phase 63 (a): one rank over NCCL (``dist.init`` with a world of
    1, ``make_mesh({"dp": -1})``): ResNet-50 and BERT-base under
    ``partition="zero1"`` with the arena, BERT also under
    ``overlap=True``; 2 warm and 5 timed steps each."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer, dist
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    dist.init(f"file://{workdir}/store1", num_processes=1, process_id=0,
              backend="nccl")
    check(dist.backend() == "nccl" and dist.num_workers() == 1,
          f"phase 63: group {dist.backend()} of {dist.num_workers()}")
    check(resolve_device(None) == dev, "phase 63: the rank's device is "
          f"{resolve_device(None)}, not {dev}")
    mesh = make_mesh({"dp": -1})
    check(mesh.shape == {"dp": 1}, f"phase 63: mesh {mesh.shape}")
    runs = {}
    want = {"resnet": {"opt_arena": 1, "bn_act_stats.bf16": 33,
                       "bn_act_apply.bf16": 33},
            "bert": {"opt_arena": 1, "flash_attention.bf16": 12,
                     "flash_attention_bwd_dkv.bf16": 12},
            "bert_overlap": {"opt_arena": 0, "flash_attention.bf16": 12,
                             "flash_attention_bwd_dkv.bf16": 12}}
    for name in ("resnet", "bert", "bert_overlap"):
        kind = name.split("_")[0]
        net, loss = dp_net(kind, dev)
        extra = dict(partition="zero1")
        if name == "bert_overlap":
            extra["overlap"] = True
        else:
            extra["fused_opt"] = "arena"
        tr = ShardedTrainer(net, loss, mesh=mesh, **dp_trainer_kw(
            kind, **extra))
        per = DP[kind]["per"]
        x, y = dp_on(tu.dp_batches(dp_spec(kind, per, 1))[0], dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = [tr.step(x, y) for _ in range(DP_WARM)]
        tr.drain()
        torch.cuda.synchronize()
        registry.reset_launches()
        t0 = time.perf_counter()
        losses += [tr.step(x, y) for _ in range(DP_TIMED)]
        tr.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = registry.launches()
        losses = [float(v) for v in losses]
        check(all(math.isfinite(v) for v in losses),
              f"phase 63 {name}: losses {losses}")
        per_step = {k: launches[k] / DP_TIMED for k in launches
                    if launches[k]}
        for k, n in want[name].items():
            check(launches.get(k, 0) == n * DP_TIMED, f"phase 63 {name}: "
                  f"{k} {launches.get(k, 0)} launches in {DP_TIMED} steps, "
                  f"want {n} a step")
        runs[name] = dict(
            samples_per_s_per_device=per * DP_TIMED / wall,
            step_ms=wall / DP_TIMED * 1e3, per_device_batch=per,
            launches_per_step=per_step, peak_bytes=int(
                torch.cuda.max_memory_allocated(dev)),
            opt_state_bytes=tr.opt_state_bytes_per_device,
            adapter=type(tr._adapter).__name__, losses=losses)
        rate = runs[name]["samples_per_s_per_device"]
        print(f"  phase 63 (a) {name}: {rate:.2f} samples/s a device, "
              f"step {runs[name]['step_ms']:.2f} "
              f"ms, launches a step {per_step}, peak "
              f"{runs[name]['peak_bytes'] / 2 ** 30:.2f} GiB [{card}]")
        del tr, net
        torch.cuda.empty_cache()
    return runs


def dp_state(net):
    """The net's parameters and buffers by ``param/`` / ``aux/`` name, as
    numpy (``test_utils._dump_state``'s keys)."""
    out = {f"param/{k}": v.detach().cpu().numpy().copy()
           for k, v in net.named_parameters()}
    out.update({f"aux/{k}": v.detach().cpu().numpy().copy()
                for k, v in net.named_buffers()})
    return out


def dp_reference(dev, kind):
    """Part (b)'s one-rank runs of the global batch (2 x half the
    per-device batch): bf16 for ``DP_PAIR_STEPS`` steps and f32 for one.
    Each ``(losses, state after step 1)``, and the initial state."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel import ShardedTrainer

    out = {}
    for run, dt, steps in (("bf16", torch.bfloat16, DP_PAIR_STEPS),
                           ("f32", None, 1)):
        net, loss = dp_net(kind, dev, dropout=0.0)
        init = dp_state(net)
        tr = ShardedTrainer(net, loss, **dp_trainer_kw(
            kind, dt=dt, partition="zero1", fused_opt="arena"))
        losses, first = [], None
        for b in tu.dp_batches(dp_spec(kind, DP[kind]["per"], steps)):
            losses.append(tr.step(*dp_on(b, dev), block=True))
            if first is None:            # the state after step 1
                first = dp_state(net)
        out[run] = (losses, first)
        del tr, net
        torch.cuda.empty_cache()
    return out, init


def dp_ratio_f32(key, got, want, init):
    """Phase 16's rule for a running statistic (module comment above
    ``DP_F32_LOSS_RTOL``): its largest error over its bar after step 1;
    None for a parameter, which the f32 pair does not hold."""
    if key.startswith("param/"):
        return None
    err = np.abs(got - want)
    return float((err / (DP_F32_STAT_TOL * (1.0 + np.abs(want)))).max())


def dp_ratio_bf16(f32):
    """Phase 30's rule against the one-rank f32 state ``f32``."""
    def ratio(key, got, want, init):
        err = float(np.abs(got - want).max())
        bar = max(HALF_GRAD_TOL * float(np.abs(want - init).max()),
                  HALF_NOISE_BARS * float(np.abs(want - f32[key]).max()))
        return err / bar if bar > 0 else (0.0 if err == 0 else math.inf)
    return ratio


def dp_judge(loss, state, ref_loss, ref, init, loss_bar, ratio):
    """A two-rank run's step-1 loss and state after step 1 against the
    one-rank run's: ``(failures, worst held (tensor, error / bar), loss
    rel, held tensors over their bar, held tensors, worst parameter
    (tensor, error / max|displacement|))``."""
    rel = abs(loss - ref_loss) / abs(ref_loss)
    fails = [] if rel <= loss_bar else [
        f"step-1 loss {loss} against {ref_loss} (rel {rel:.3e} > "
        f"{loss_bar:.3e})"]
    worst, over, held, wparam = ("", 0.0), 0, 0, ("", 0.0)
    for key, want in ref.items():
        if key.startswith("param/"):
            top = float(np.abs(want - init[key]).max())
            e = float(np.abs(state[key] - want).max())
            e = e / top if top > 0 else (0.0 if e == 0 else math.inf)
            if e > wparam[1]:
                wparam = (key, e)
        r = ratio(key, state[key], want, init[key])
        if r is None:
            continue
        held += 1
        if r > 1.0:
            over += 1
            if len(fails) < 6:
                fails.append(f"{key} {r:.3g} x its bar")
        if r > worst[1]:
            worst = (key, r)
    return fails, worst, rel, over, held, wparam


def phase_dp_two_ranks(dev, card, workdir):
    """Phase 63 (b): two ranks on the one card over gloo (NCCL refuses
    two ranks on one device), each on half of the per-device batch, under
    zero1 with the arena, against one rank of the same global batch
    built here, at the bars of the module comment above
    ``DP_F32_LOSS_RTOL``: both configurations in bf16 for
    ``DP_PAIR_STEPS`` steps, ResNet-50 in f32 for one, and one step of
    each of two controls with local batch-norm statistics."""
    from mxnet_tpu_torch import test_utils as tu

    refs = {kind: dp_reference(dev, kind) for kind in ("resnet", "bert")}
    # (case, kind, dtype, steps, local statistics)
    runs = (("resnet", "resnet", "bfloat16", DP_PAIR_STEPS, False),
            ("bert", "bert", "bfloat16", DP_PAIR_STEPS, False),
            ("resnet_f32", "resnet", None, 1, False),
            ("resnet_f32_local", "resnet", None, 1, True),
            ("resnet_bf16_local", "resnet", "bfloat16", 1, True))
    cases = []
    for name, kind, dt, steps, local in runs:
        model = "resnet50_v1" if kind == "resnet" else "bert"
        kw = dict(layout="NHWC", fused_bn_relu=True,
                  classes=DP["resnet"]["classes"]) if kind == "resnet" \
            else dp_bert_kw(0.0)
        cases.append(dict(
            name=name, kind="train", model=model, model_kw=kw,
            device="cuda", init_seed=0, local_bn_stats=local,
            batch_spec=dp_spec(kind, DP[kind]["per"], steps),
            trainer=dict(dp_trainer_kw(kind, partition="zero1",
                                       fused_opt="arena"),
                         compute_dtype=dt),
            dump=f"{name}.npz", dump_at=1))
    t0 = time.perf_counter()
    ranks = tu.spawn_world(2, {"cases": cases, "dir": workdir,
                               "allow_tf32": False},
                           f"{workdir}/w2", timeout=DP_RANK_SECS,
                           backend="gloo")
    out = {"world_seconds": time.perf_counter() - t0}
    for name, kind, dt, steps, local in runs:
        res = [r[name] for r in ranks]
        for r, got in enumerate(res):
            check("error" not in got, f"phase 63 (b) {name} rank {r}: "
                  f"{got.get('error')}")
            check(len(got["losses"]) == steps and all(
                math.isfinite(v) for v in got["losses"]),
                f"phase 63 (b) {name} rank {r}: losses {got['losses']}")
        check(res[0]["digest"] == res[1]["digest"],
              f"phase 63 (b) {name}: the ranks' parameters differ")
        runs_ref, init = refs[kind]
        (l16, s16), (l32, s32) = runs_ref["bf16"], runs_ref["f32"]
        with np.load(res[0]["dump"]) as z:
            got = {k: z[k] for k in z.files}
        if dt is None:
            loss_bar, ratio, ref_l, ref_s, rule = \
                DP_F32_LOSS_RTOL, dp_ratio_f32, l32, s32, "f32"
        else:
            noise = abs(l16[0] - l32[0]) / abs(l16[0])
            loss_bar = max(DP_LOSS_RTOL, HALF_NOISE_BARS * noise)
            ratio, ref_l, ref_s, rule = dp_ratio_bf16(s32), l16, s16, "bf16"
        fails, worst, rel, over, held, wparam = dp_judge(
            res[0]["losses"][0], got, ref_l[0], ref_s, init, loss_bar, ratio)
        if not local:
            check(not fails, f"phase 63 (b) {name} at the {rule} bar: "
                  + "; ".join(fails))
        elif dt is None:
            check(bool(fails), f"phase 63 (b) {name}: the control with "
                  "local batch-norm statistics passed the f32 bar (worst "
                  f"{worst[1]:.3g} x its bar, loss rel {rel:.3e})")
        sfx = "" if dt is None else ".bf16"
        for r, got_r in enumerate(res):
            ln = got_r["launches"]
            check(ln.get("opt_arena", 0) == steps,
                  f"phase 63 (b) {name} rank {r}: {ln.get('opt_arena', 0)}"
                  f" arena launches in {steps} steps")
            check(got_r["state_numel"][0] * 2 == got_r["arena_padded"],
                  f"phase 63 (b) {name} rank {r}: the arena state "
                  f"{got_r['state_numel']} is not half of "
                  f"{got_r['arena_padded']}")
            if kind == "resnet":
                want = {f"bn_act_sums{sfx}": 0 if local else 33,
                        f"bn_act_fold{sfx}": 0 if local else 33,
                        f"bn_act_stats{sfx}": 33 if local else 0,
                        f"bn_act_apply{sfx}": 33}
                for k, v in want.items():
                    check(ln.get(k, 0) == v * steps,
                          f"phase 63 (b) {name} rank {r}: {k} "
                          f"{ln.get(k, 0)}, want {v} a step")
        out[name] = dict(
            rule=rule, local_bn_stats=local,
            losses_two_ranks=res[0]["losses"],
            losses_one_rank=ref_l, step1_loss_rel=rel,
            step1_loss_bar=loss_bar, worst_to_bar=worst,
            tensors_over_bar=over, tensors_held=held,
            worst_param_to_displacement=wparam,
            failures=fails[:6], launches_by_rank=[g["launches"]
                                                  for g in res],
            arena_shard=res[0]["state_numel"][0],
            arena_padded=res[0]["arena_padded"],
            seconds_by_rank=[g["seconds"] for g in res])
        verdict = ("passes" if not fails else "fails") + f" the {rule} bar"
        print(f"  phase 63 (b) {name}: two ranks x {DP[kind]['per'] // 2} "
              f"against one rank x {DP[kind]['per']} "
              f"({'local' if local else 'synced'} batch-norm statistics): "
              f"{verdict}; step-1 loss {res[0]['losses'][0]:.6f} / "
              f"{ref_l[0]:.6f} (rel {rel:.3e}, bar {loss_bar:.3e}); worst "
              f"tensor {worst[1]:.4g} of its bar ({worst[0]}), {over} of "
              f"{held} over; worst parameter {wparam[1]:.4g} of its max "
              f"displacement ({wparam[0]}); losses {res[0]['losses']} / "
              f"{ref_l}"
              f"{'' if dt is None else f' (f32 {l32})'}; arena "
              f"{out[name]['arena_shard']} of {out[name]['arena_padded']} "
              f"a rank [{card}]")
    return out


def dp_kernel_rows(dev):
    """The dp mode's kernels (bn_act_sums, bn_act_fold) in bf16 against
    their plain versions at the ResNet-50 shapes of part (b)'s ranks, and
    their times beside the one-launch statistics at the stem."""
    from mxnet_tpu_torch.kernels import bn_act as kbn

    worst = {f"{k}{sfx}": 0.0 for k in ("bn_act_sums", "bn_act_fold")
             for sfx in (".bf16", "")}
    per = DP["resnet"]["per"] // 2
    shapes = [(per * 112 * 112, 64), (per * 56 * 56, 64),
              (per * 28 * 28, 128), (per * 14 * 14, 256),
              (per * 7 * 7, 512), (per * 7 * 7, 2048)]
    # bf16 runs the main path; f32 runs part (b)'s f32 pair
    for (rows, c), (dt, sfx) in itertools.product(
            shapes, ((torch.bfloat16, ".bf16"), (torch.float32, ""))):
        g = torch.Generator().manual_seed(rows + c)
        x = (torch.randn(rows, c, generator=g) * 2 + 0.5).to(dev, dt)
        gm = (torch.rand(c, generator=g) + 0.5).to(dev, dt)
        bt = torch.randn(c, generator=g).to(dev, dt)
        sums = kbn.bn_sums(x)
        ref = kbn.bn_sums_plain(x)
        err = float(((sums - ref).abs() / ref.abs().clamp_min(1.0)).max())
        check(err <= 1e-12, f"bn_act_sums{sfx} at {rows}x{c}: {err:.3e}")
        worst[f"bn_act_sums{sfx}"] = max(worst[f"bn_act_sums{sfx}"], err)
        packed = torch.cat([sums.reshape(-1), sums.new_full((1,), rows)])
        got = kbn.bn_fold(packed, gm, bt, BN_EPS, dt)
        want = kbn.bn_fold_plain(packed, gm, bt, BN_EPS, dt)
        e = max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(got, want))
        one = kbn.bn_stats(x, gm, bt, BN_EPS)
        check(all(torch.equal(a, b) for a, b in zip(got, one)),
              f"bn_act dp mode{sfx} on one rank != the one launch at "
              f"{rows}x{c}")
        check(e == 0.0, f"bn_act_fold{sfx} at {rows}x{c}: {e:.3e} from "
              "the plain fold")
        worst[f"bn_act_fold{sfx}"] = max(worst[f"bn_act_fold{sfx}"], e)
    rows, c = shapes[0]
    nbuf = max(1, math.ceil(200e6 / (rows * c * 2)))
    bufs = [(torch.randn(rows, c, generator=torch.Generator().manual_seed(i))
             ).to(dev, torch.bfloat16) for i in range(nbuf)]
    gm = torch.ones(c, device=dev, dtype=torch.bfloat16)
    bt = torch.zeros(c, device=dev, dtype=torch.bfloat16)
    packed = torch.cat([kbn.bn_sums(bufs[0]).reshape(-1),
                        torch.full((1,), float(rows), device=dev,
                                   dtype=torch.float64)])
    sums_ms = device_ms_per_call(lambda i: kbn.bn_sums(bufs[i]), nbuf)
    sums_plain = cuda_time_ms(lambda i: kbn.bn_sums_plain(bufs[i]), nbuf)
    fold_ms = device_ms_per_call(
        lambda i: kbn.bn_fold(packed, gm, bt, BN_EPS, torch.bfloat16), 1)
    fold_plain = cuda_time_ms(lambda i: kbn.bn_fold_plain(
        packed, gm, bt, BN_EPS, torch.bfloat16), 1)
    one_ms = device_ms_per_call(lambda i: kbn.bn_stats(bufs[i], gm, bt,
                                                       BN_EPS), nbuf)
    # bounds: the sums read x (2 bytes an element) and write 2 C doubles,
    # 3 operations an element (an add, an FMA) at the f32 CUDA-core peak
    # as the stats row counts them; the fold reads 2 C + 1 doubles and
    # gamma and beta and writes mean, var (f32) and scale, shift (bf16),
    # about 10 operations a channel
    sb = rows * c * 2 + 2 * c * 8
    sums_bound = max(sb / 3.35e12, 3 * rows * c / 67e12) * 1e3
    fb = (2 * c + 1) * 8 + 2 * c * 2 + 2 * c * 4 + 2 * c * 2
    fold_bound = max(fb / 3.35e12, 10 * c / 67e12) * 1e3
    print(f"  dp bn_act kernels vs plain at part (b)'s six shapes: sums "
          f"{worst['bn_act_sums.bf16']:.3e} (relative to max(|sum|, 1)), "
          f"fold {worst['bn_act_fold.bf16']:.3e} (f32: sums "
          f"{worst['bn_act_sums']:.3e}, fold {worst['bn_act_fold']:.3e}); "
          f"the dp mode on one rank "
          f"gives the one launch's bits.  Stem {rows}x{c} bf16: sums "
          f"{sums_ms:.4f} ms (plain {sums_plain:.4f}, bound {sums_bound:.4f}"
          f"), fold {fold_ms:.4f} ms (plain {fold_plain:.4f}, bound "
          f"{fold_bound:.5f}), the one-launch stats {one_ms:.4f} ms")
    return {"bn_act_sums.bf16": dict(
        max_abs_err=worst["bn_act_sums.bf16"], ms=sums_ms,
        plain_ms=sums_plain, bound_ms=sums_bound, bound_by="bytes"
        if sb / 3.35e12 >= 3 * rows * c / 67e12 else "operations",
        shape=dict(rows=rows, C=c), one_launch_stats_ms=one_ms,
        f32_max_abs_err=worst["bn_act_sums"]),
        "bn_act_fold.bf16": dict(
            max_abs_err=worst["bn_act_fold.bf16"], ms=fold_ms,
            f32_max_abs_err=worst["bn_act_fold"],
            plain_ms=fold_plain, bound_ms=fold_bound,
            bound_by="bytes" if fb / 3.35e12 >= 10 * c / 67e12
            else "operations", shape=dict(C=c))}


def phase_dp(dev, card):
    """Phase 63: (a) and (b), the dp kernels' checks and times, inside
    ``DP_SECS``."""
    import tempfile

    from mxnet_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mx_dp_") as workdir:
        try:
            one = phase_dp_one_rank(dev, card, workdir)
            two = phase_dp_two_ranks(dev, card, workdir)
        finally:
            dist.shutdown()
    rows = dp_kernel_rows(dev)
    secs = time.perf_counter() - t0
    print(f"phase 63 data parallelism: (a) one rank over NCCL, (b) two "
          f"ranks over gloo on one card; {secs:.1f} s [{card}]")
    check(secs <= DP_SECS, f"phase 63 took {secs:.1f} s")
    return {"one_rank_nccl": one, "two_ranks_gloo": two,
            "kernel_rows": rows, "seconds": secs}


# -- phase 64: the other mesh axes ---------------------------------------------
# Two gloo ranks on the one card (NCCL refuses two ranks on one device),
# one world for the whole phase.  Every bar is an earlier phase's rule,
# fixed before the run:
# - (a) BERT-base as phase 63 builds it (bench's --multichip BERT: 12
#   layers, 768 units, 12 heads, seq 128, 20 predictions, adam lr 1e-4,
#   wd 0.01), 8 rows a data rank, under partition="zero1": {"dp": 1,
#   "mp": 2} with mp_spec_fn() and {"dp": 2} with fsdp_spec_fn(), bf16
#   compute with f32 masters, against one rank (replicated) on the same
#   global batch at phase 30's bf16 rule, step 1 held: the loss (phase
#   63's loss bar) and every gradient the update reads, each within
#   max(2^-4 x max|one rank's bf16 gradient|, 3 x max|one rank in bf16 -
#   one rank in f32|).  The state after step 1 against phase 63's
#   displacement reading is printed, not held: adam's first step moves
#   each element by lr x sign(g), and two ranks' bf16 half-sums of a
#   gradient element that cancels to near 0 may round across 0, which
#   moves that element 2 lr against one rank (32 x that bar; PERF.md
#   section 6; plain dp does the same:
#   tools/torch_dp_bf16_adam_flip.py).  The mp world also in f32 (TF32
#   off) for one step, its step-1 loss at phase 16's 1e-4.  Each rank's accounting (optimizer-state
#   bytes, parameter-gather bytes) must equal the JAX trainer's formula
#   (mxnet_tpu/parallel/trainer.py:1520-1570) computed here on the host.
# - (b) LeNet as bench_lenet builds it (batch 1024, sgd momentum 0.9, lr
#   0.05) on {"pp": 2} under zero1, grad_accum 4, 5 windows of 4 copies
#   of one batch, against one rank's 5 replicated steps on that batch
#   (tools/spmd_smoke.py's pp_case): each window's loss at phase 16's
#   1e-4, the bubble gauge 0.2, one update a window.  ResNet-50 on bench's
#   MXNET_PP=2 mesh must raise the mutation-free error.
# - (c) ring attention on {"sp": 2}, f32, B 1, H 12, T 8192, d 64, causal
#   and not, against attention_reference on one rank (TF32 off): the
#   output at the JAX test's 2e-5 absolute, each gradient within 2e-5 +
#   2e-5 x |the reference's| elementwise (tests/test_pipeline_moe.py's
#   form of the bar).  (Two bars before this one failed on f32 rounding,
#   not on the port: 1e-4 x max|gradient| lay below the f32 reference's
#   own distance from float64 for dq, whose max is 2e-3 while its
#   rounding follows the terms' size; 2e-5 absolute below the rounding of
#   the causal dv, whose first keys sum about 6 over 8192 queries: PERF.md
#   section 6, tools/torch_ring_grad_rounding.py.)
# - (d) experts on {"ep": 2}, f32, d 768, h 3072, E 8, k 2, 2048 tokens
#   a rank, capacity factor 8 (no drops), against moe_reference shard by
#   shard: the output at the JAX test's 2e-4 absolute, the gradients
#   finite and within 2e-4 + 2e-4 x |the reference's| elementwise, as
#   the CPU tests hold them.
MA_SECS = 150.0               # the phase's budget
MA_RANK_SECS = 120.0          # the world's ranks are killed past this
MA_BERT_STEPS = 2
MA_LENET = dict(batch=1024, windows=5, accum=4)
MA_RING = dict(b=1, h=12, t=8192, d=64, seed=64)
MA_MOE = dict(tokens=2 * 2048, d=768, h=3072, e=8, seed=64)
MA_MOE_K, MA_MOE_CF = 2, 8.0
MA_RING_TOL, MA_MOE_TOL = 2e-5, 2e-4
MA_FLASH = {"bf16": ("flash_attention.bf16", "flash_attention_bwd_dkv.bf16"),
            "f32": ("flash_attention", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")}


def ma_formula(shapes, specs, axes, partition, leaves, dp_axis="dp",
               min_size=2048):
    """The JAX trainer's ``opt_state_bytes_per_device`` and
    ``param_gather_bytes`` of f32 parameters of whole ``shapes`` with
    sanitized ``specs`` on a mesh of ``axes``, each parameter with
    ``leaves`` state leaves of its shape: a leaf is stored as the spec's
    shard, and under zero1 a leaf of at least ``min_size`` elements not
    already split over the data axis also splits the free dim with the
    least padding over it (padded), whose gather receives (dp-1)/dp of
    the padded shard's bytes (``mxnet_tpu/parallel/trainer.py:159-206,
    1520-1570``)."""
    dp = axes.get(dp_axis, 1)
    opt = gather = 0
    for shape, spec in zip(shapes, specs):
        ents = list(spec) + [None] * (len(shape) - len(spec))
        names = [() if e is None else (e if isinstance(e, tuple) else (e,))
                 for e in ents]
        shard = [d // math.prod(axes[a] for a in nm)
                 for d, nm in zip(shape, names)]
        used = {a for nm in names for a in nm}
        free = [j for j, nm in enumerate(names) if not nm]
        if partition == "zero1" and dp > 1 and shape and free and \
                math.prod(shape) >= min_size and dp_axis not in used:
            j = min(free, key=lambda k: (-(-shape[k] // dp) * dp) / shape[k])
            padded = -(-shape[j] // dp) * dp
            stored = list(shard)
            stored[j] = padded // dp
            opt += leaves * math.prod(stored) * 4
            gather += math.prod(shard) // shape[j] * padded * 4 * \
                (dp - 1) // dp
        else:
            opt += leaves * math.prod(shard) * 4
    return opt, gather


def ma_specs(net, spec_fn, axes):
    """``(names, shapes, sanitized specs)`` of ``net``'s trained
    parameters, sorted by name: a spec entry the dim cannot divide is
    dropped, as the JAX sanitizer drops it."""
    named = sorted((n, tuple(p.shape)) for n, p in net.named_parameters()
                   if p.requires_grad)
    specs = []
    for n, shape in named:
        ents = []
        for d, e in zip(shape, tuple(spec_fn(n, shape))):
            size = math.prod(axes[a] for a in (e if isinstance(e, tuple)
                                               else (e,))) if e else 1
            ents.append(e if e is not None and d % size == 0 else None)
        specs.append(tuple(ents))
    return [n for n, _ in named], [s for _, s in named], specs


def ma_reference(dev, b):
    """One rank, replicated, on the global batch of ``b`` rows: bf16 for
    ``MA_BERT_STEPS`` steps and f32 for one; each ``(losses, state after
    step 1)``, and the initial state."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel import ShardedTrainer

    out = {}
    for run, dt, steps in (("bf16", torch.bfloat16, MA_BERT_STEPS),
                           ("f32", None, 1)):
        net, loss = dp_net("bert", dev, dropout=0.0)
        init = dp_state(net)
        # per-parameter adam, as the sharded worlds run: the flat arena
        # folds wd * p into the gradient arena, which is then no longer
        # the step's gradient
        tr = ShardedTrainer(net, loss, **dp_trainer_kw(
            "bert", dt=dt, fused_opt="off"))
        losses, first = [], None
        for batch in tu.dp_batches(dp_spec("bert", b, steps)):
            losses.append(tr.step(*dp_on(batch, dev), block=True))
            if first is None:
                first = dp_state(net)
                first.update({f"grad/{n}": g.detach().cpu().numpy().copy()
                              for n, g in zip(tr.train_names, tr._gviews)})
        out[run] = (losses, first)
        del tr, net
        torch.cuda.empty_cache()
    return out, init


def ma_grad_judge(state, ref16, ref32):
    """Phase 30's rule on the step-1 gradients (``grad/`` keys): each
    within max(2^-4 x max|the one-rank bf16 gradient|, 3 x max|one rank
    in bf16 - one rank in f32|); ``(failures, worst (tensor, error /
    bar), held)``."""
    fails, worst, held = [], ("", 0.0), 0
    for key, want in ref16.items():
        if not key.startswith("grad/"):
            continue
        err = float(np.abs(state[key] - want).max())
        bar = max(HALF_GRAD_TOL * float(np.abs(want).max()),
                  HALF_NOISE_BARS * float(np.abs(want - ref32[key]).max()))
        r = err / bar if bar > 0 else (0.0 if err == 0 else math.inf)
        held += 1
        if r > 1.0 and len(fails) < 6:
            fails.append(f"{key} {r:.3g} x its bar")
        if r > worst[1]:
            worst = (key, r)
    return fails, worst, held


def ma_cases(workdir):
    """The world's cases: (a)'s three BERT runs, (b)'s LeNet and the
    ResNet-50 refusal, (c) and (d)."""
    from mxnet_tpu_torch import test_utils as tu

    cases = []
    for name, axes, spec, b, dt, steps in (
            ("bert_mp", {"dp": 1, "mp": 2}, ("mp", {}), 8, "bfloat16",
             MA_BERT_STEPS),
            ("bert_mp_f32", {"dp": 1, "mp": 2}, ("mp", {}), 8, None, 1),
            ("bert_fsdp", {"dp": 2}, ("fsdp", {}), 16, "bfloat16",
             MA_BERT_STEPS)):
        cases.append(dict(
            name=name, kind="spmd", model="bert", model_kw=dp_bert_kw(0.0),
            device="cuda", init_seed=0, mesh=axes, spec=spec,
            batch_spec=dp_spec("bert", b, steps),
            trainer=dp_trainer_kw("bert", dt=dt, partition="zero1",
                                  fused_opt="off"),
            dump=f"{name}.npz", dump_at=1, no_params=True))
    rs = np.random.RandomState(0)
    lx = rs.rand(MA_LENET["batch"], 1, 28, 28).astype(np.float32)
    ly = rs.randint(0, 10, size=(MA_LENET["batch"],)).astype(np.int32)
    np.savez(f"{workdir}/lenet_batch.npz", x=lx, y=ly)
    cases.append(dict(
        name="lenet_pp", kind="spmd", model="lenet", device="cuda",
        init_seed=0, mesh={"pp": 2}, batches="lenet", no_params=True,
        repeat=MA_LENET["accum"],
        trainer=dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
                     partition="zero1", grad_accum=MA_LENET["accum"])))
    cases.append(dict(
        name="resnet_pp", kind="spmd", model="resnet50_v1",
        model_kw=dict(layout="NHWC", fused_bn_relu=True,
                      classes=DP["resnet"]["classes"]),
        device="cuda", init_seed=0, mesh={"dp": -1, "pp": 2},
        batch_spec=dp_spec("resnet", 2, 1),
        trainer=dp_trainer_kw("resnet", grad_accum=2), repeat=2,
        expect_error="step"))
    cases.append(dict(name="ring", kind="ring", device="cuda",
                      spec=MA_RING))
    cases.append(dict(name="moe", kind="moe", device="cuda",
                      mesh={"ep": 2}, spec=MA_MOE, k=MA_MOE_K,
                      cf=MA_MOE_CF))
    return cases, {"lenet": [(lx, ly)] * MA_LENET["windows"]}


def ma_bert(res, refs, dev, card):
    """(a): each BERT run's step 1 against one rank, its accounting
    against the JAX formula, its launches, gathers and memory."""
    from mxnet_tpu_torch.parallel import fsdp_spec_fn, mp_spec_fn

    net, _ = dp_net("bert", dev, dropout=0.0)
    out = {}
    for name, axes, spec_fn, b in (
            ("bert_mp", {"dp": 1, "mp": 2}, mp_spec_fn(), 8),
            ("bert_mp_f32", {"dp": 1, "mp": 2}, mp_spec_fn(), 8),
            ("bert_fsdp", {"dp": 2}, fsdp_spec_fn(), 16)):
        got = [r[name] for r in res]
        for r, g in enumerate(got):
            check("error" not in g, f"phase 64 (a) {name} rank {r}: "
                  f"{g.get('error')}")
            check(all(math.isfinite(v) for v in g["losses"]),
                  f"phase 64 (a) {name} rank {r}: losses {g['losses']}")
        names, shapes, specs = ma_specs(net, spec_fn, axes)
        sharded = [n for n, s in zip(names, specs) if any(s)]
        f32 = name.endswith("f32")
        if "mp" in axes:
            named = [n for n in names if n.endswith(
                (".qkv.weight", ".proj.weight", ".ffn1.weight",
                 ".ffn2.weight"))]
            check(len(named) == 48 and set(named) <= set(sharded),
                  f"phase 64 (a) {name}: the 12 layers' qkv / proj / ffn1 "
                  f"/ ffn2 weights are not all sharded ({len(named)})")
        check(len(sharded) >= 8, f"phase 64 (a) {name}: {len(sharded)} "
              "sharded parameters")
        want_opt, want_gather = ma_formula(shapes, specs, axes, "zero1", 2)
        for r, g in enumerate(got):
            check(g["opt_state_bytes"] == want_opt and
                  g["param_gather_bytes"] == want_gather,
                  f"phase 64 (a) {name} rank {r}: accounting "
                  f"{g['opt_state_bytes']} / {g['param_gather_bytes']}, "
                  f"the JAX formula {want_opt} / {want_gather}")
            for k in MA_FLASH["f32" if f32 else "bf16"]:
                n = g["launches"].get(k, 0)
                check(n == 12 * len(g["losses"]), f"phase 64 (a) {name} "
                      f"rank {r}: {k} {n} launches in {len(g['losses'])} "
                      "steps, want 12 a step")
            for k, v in g["numel"].items():
                share = math.prod(axes[a] for e in g["specs"][k] if e
                                  for a in (e if isinstance(e, tuple)
                                            else (e,)))
                check(v * share == math.prod(g["full"][k]),
                      f"phase 64 (a) {name} rank {r}: {k} stores {v} of "
                      f"{g['full'][k]}")
        runs_ref, init = refs[b]
        (l16, s16), (l32, s32) = runs_ref["bf16"], runs_ref["f32"]
        with np.load(got[0]["dump"]) as z:
            state = {k: z[k] for k in z.files}
        if f32:
            loss_bar, ratio, ref_l, ref_s, rule = \
                DP_F32_LOSS_RTOL, dp_ratio_f32, l32, s32, "f32"
        else:
            noise = abs(l16[0] - l32[0]) / abs(l16[0])
            loss_bar = max(DP_LOSS_RTOL, HALF_NOISE_BARS * noise)
            ratio, ref_l, ref_s, rule = dp_ratio_bf16(s32), l16, s16, "bf16"
        fails, worst, rel, over, held, wparam = dp_judge(
            got[0]["losses"][0], state, ref_l[0],
            {k: v for k, v in ref_s.items() if not k.startswith("grad/")},
            init, loss_bar, ratio)
        gfails, gworst, gheld = ([], ("", 0.0), 0) if f32 else \
            ma_grad_judge(state, s16, s32)
        if f32:
            held_fails = fails
        else:
            # held: the loss and the step-1 gradients (phase 30's rule);
            # the displacements (phase 63's reading) are reported
            held_fails = [f for f in fails if f.startswith("step-1")] + \
                gfails
        check(not held_fails, f"phase 64 (a) {name} at the {rule} bar: "
              + "; ".join(held_fails))
        steps = len(got[0]["losses"])
        per_step = [{k: v / steps for k, v in g["counts"].items()
                     if k.endswith("_calls")} for g in got]
        out[name] = dict(
            rule=rule, mesh=axes, sharded_params=len(sharded),
            losses_two_ranks=got[0]["losses"], losses_one_rank=ref_l,
            step1_loss_rel=rel, step1_loss_bar=loss_bar,
            worst_to_bar=worst, tensors_over_bar=over, tensors_held=held,
            worst_param_to_displacement=wparam,
            grad_worst_to_bar=gworst, grads_held=gheld,
            displacement_failures=[f for f in fails
                                   if not f.startswith("step-1")],
            opt_state_bytes_per_device=[g["opt_state_bytes"] for g in got],
            param_gather_bytes=[g["param_gather_bytes"] for g in got],
            collective_bytes_per_step=[g["collective_bytes"] for g in got],
            jax_formula=dict(opt_state_bytes=want_opt,
                             param_gather_bytes=want_gather),
            peak_bytes_by_rank=[g["peak_bytes"] for g in got],
            launches_by_rank=[g["launches"] for g in got],
            collective_calls_per_step_by_rank=per_step,
            seconds_by_rank=[g["seconds"] for g in got])
        print(f"  phase 64 (a) {name} {axes}: {len(sharded)} sharded "
              f"parameters; step-1 loss {got[0]['losses'][0]:.6f} / "
              f"{ref_l[0]:.6f} (rel {rel:.3e}, {rule} bar {loss_bar:.3e}); "
              + ("" if f32 else f"step-1 gradients: worst {gworst[1]:.4g} "
                 f"of its bar ({gworst[0]}) of {gheld} held; ")
              + f"state after step 1 (reported): worst tensor "
              f"{worst[1]:.4g} of its bar ({worst[0]}), {over}"
              f" of {held} over; worst parameter {wparam[1]:.4g} of its "
              f"displacement ({wparam[0]}); optimizer state "
              f"{got[0]['opt_state_bytes']} B and parameter gather "
              f"{got[0]['param_gather_bytes']} B a rank (the JAX formula "
              f"{want_opt} / {want_gather}); peak "
              f"{[round((g['peak_bytes'] or 0) / 2 ** 30, 3) for g in got]}"
              f" GiB; "
              f"launches a step {[{k: v / steps for k, v in g['launches'].items()} for g in got]}; "
              f"collective calls a step {per_step[0]}; losses "
              f"{got[0]['losses']} / {ref_l}; step seconds "
              f"{[round(g['seconds'] / steps, 3) for g in got]} [{card}]")
    del net
    torch.cuda.empty_cache()
    return out


def ma_lenet(res, dev, lenet_batches, card):
    """(b): the pipelined LeNet's windows against one rank's steps, and
    the ResNet-50 refusal."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.parallel import ShardedTrainer

    got = [r["lenet_pp"] for r in res]
    for r, g in enumerate(got):
        check("error" not in g, f"phase 64 (b) rank {r}: {g.get('error')}")
    net = xavier_init(get_model("lenet", device=dev), 0)
    loss = tu.dp_model("mlp", None)[1]
    tr = ShardedTrainer(net, loss, optimizer="sgd", learning_rate=0.05,
                        momentum=0.9)
    x, y = (torch.from_numpy(a).to(dev) for a in lenet_batches[0])
    ref = [tr.step(x, y, block=True) for _ in lenet_batches]
    k = MA_LENET["accum"]
    worst = 0.0
    for r, g in enumerate(got):
        win = g["losses"][k - 1::k]
        check(len(win) == len(ref) and g["t"] == len(ref),
              f"phase 64 (b) rank {r}: {g['t']} updates, {len(win)} windows")
        check(all(v == 0.0 for i, v in enumerate(g["losses"])
                  if (i + 1) % k), f"phase 64 (b) rank {r}: a buffered "
              "call's loss is not 0")
        rels = [abs(a - b) / abs(b) for a, b in zip(win, ref)]
        worst = max(worst, max(rels))
        check(max(rels) <= DP_F32_LOSS_RTOL, f"phase 64 (b) rank {r}: "
              f"window losses {win} against {ref}")
        check(abs(g["bubble"] - 0.2) < 1e-12,
              f"phase 64 (b) rank {r}: bubble {g['bubble']}")
        check(g["launches"].get("opt_arena", 0) == len(ref),
              f"phase 64 (b) rank {r}: {g['launches'].get('opt_arena', 0)}"
              f" arena launches in {len(ref)} windows")
    msgs = [r["resnet_pp"].get("error_msg", r["resnet_pp"].get("error"))
            for r in res]
    check(all(m and "mutation-free" in m for m in msgs),
          f"phase 64 (b) ResNet-50 on MXNET_PP=2's mesh: {msgs}")
    print(f"  phase 64 (b) LeNet on {{'pp': 2}}, grad_accum {k}: window "
          f"losses {got[0]['losses'][k - 1::k]} against one rank's "
          f"{ref} (worst rel {worst:.3e}); {got[0]['t']} updates, bubble "
          f"{got[0]['bubble']}, arena launches "
          f"{[g['launches'].get('opt_arena', 0) for g in got]}, ppermute "
          f"calls a window {got[0]['counts'].get('ppermute_calls', 0) / len(ref)}"
          f"; step seconds {[round(g['seconds'] / len(g['losses']), 4) for g in got]}; "
          f"ResNet-50 under pp=2 refused: {msgs[0][:70]}... [{card}]")
    del tr, net
    return dict(window_losses=got[0]["losses"][k - 1::k],
                one_rank_losses=ref, worst_rel=worst, updates=got[0]["t"],
                bubble=got[0]["bubble"],
                launches_by_rank=[g["launches"] for g in got],
                counts=got[0]["counts"],
                seconds_by_rank=[g["seconds"] for g in got],
                resnet50_refusal=msgs[0])


def ma_grad_check(label, got, want, tol, rtol=0.0):
    """``(max abs error, worst error / its bar)`` of a gradient against
    the reference's, each element within ``tol + rtol x |reference|``."""
    err = np.abs(got - want)
    ratio = float((err / (tol + rtol * np.abs(want))).max())
    check(np.isfinite(got).all() and ratio <= 1.0,
          f"phase 64 {label}: gradient error {float(err.max()):.3e}, "
          f"{ratio:.3g} x its bar")
    return float(err.max()), ratio


def ma_ring(res, dev, card):
    """(c): the two ranks' ring attention against attention_reference on
    the whole sequence, here on the card."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel.ring import attention_reference

    arr = tu.ring_arrays(**MA_RING)
    out = {}
    for causal in (False, True):
        tag = "causal" if causal else "full"
        got = [r["ring"][tag] for r in res]
        q, k, v = (torch.tensor(arr[n], device=dev).requires_grad_()
                   for n in "qkv")
        t = q.shape[2]
        mask = (torch.arange(t, device=dev)[:, None]
                >= torch.arange(t, device=dev)[None]) if causal else None
        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        sync()
        t0 = time.perf_counter()
        o = attention_reference(q, k, v, mask=mask)
        (o * torch.tensor(arr["w"], device=dev)).sum().backward()
        sync()
        ref_s = time.perf_counter() - t0
        err = float(np.abs(np.concatenate([g["out"] for g in got], 2)
                           - o.detach().cpu().numpy()).max())
        check(err <= MA_RING_TOL, f"phase 64 (c) {tag}: output error "
              f"{err:.3e} > {MA_RING_TOL}")
        grads = {}
        for name, ref in (("dq", q), ("dk", k), ("dv", v)):
            grads[name] = ma_grad_check(
                f"(c) {tag} {name}", np.concatenate([g[name] for g in got],
                                                    2),
                ref.grad.cpu().numpy(), MA_RING_TOL, MA_RING_TOL)
        out[tag] = dict(max_abs_err=err, grad_err_bar=grads,
                        seconds_by_rank=[g["seconds"] for g in got],
                        reference_seconds=ref_s)
        print(f"  phase 64 (c) ring attention {tag} on {{'sp': 2}}, "
              f"T {t}: output {err:.3e} (bar {MA_RING_TOL}); gradients "
              + ", ".join(f"{n} {e:.3e} ({r:.3g} of its bar)"
                          for n, (e, r) in grads.items())
              + f"; forward + backward {[round(g['seconds'], 3) for g in got]}"
              f" s a rank, one rank {ref_s:.3f} s [{card}]")
        del q, k, v, o
    return out


def ma_moe(res, dev, card):
    """(d): the two ranks' experts against moe_reference shard by shard,
    every expert local, here on the card."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel.moe import moe_reference

    arr = tu.moe_arrays(**MA_MOE)
    got = [r["moe"] for r in res]
    for r, g in enumerate(got):
        check("error" not in g, f"phase 64 (d) rank {r}: {g.get('error')}")
    gate, up, down = (torch.tensor(arr[n], device=dev).requires_grad_()
                      for n in ("gate", "up", "down"))
    xs = torch.tensor(arr["x"], device=dev).requires_grad_()
    w = torch.tensor(arr["w"], device=dev)
    n = xs.shape[0] // 2
    total, outs, auxes = 0, [], []
    for s in range(2):
        o, aux = moe_reference(xs[s * n:(s + 1) * n], gate, up, down,
                               k=MA_MOE_K, capacity_factor=MA_MOE_CF)
        total = total + (o * w[s * n:(s + 1) * n]).sum() + aux
        outs.append(o.detach().cpu().numpy())
        auxes.append(float(aux.detach()))
    total.backward()
    err = max(float(np.abs(g["out"] - outs[g["index"]]).max()) for g in got)
    check(err <= MA_MOE_TOL, f"phase 64 (d): output error {err:.3e} > "
          f"{MA_MOE_TOL}")
    el = MA_MOE["e"] // 2
    bar = dict(tol=MA_MOE_TOL, rtol=MA_MOE_TOL)
    grads = {"dx": ma_grad_check("(d) dx", np.concatenate(
        [g["dx"] for g in sorted(got, key=lambda g: g["index"])]),
        xs.grad.cpu().numpy(), **bar),
        "dgate": ma_grad_check("(d) dgate", sum(g["dgate"] for g in got),
                               gate.grad.cpu().numpy(), **bar)}
    for key, ref in (("dup", up), ("ddown", down)):
        grads[key] = ma_grad_check(f"(d) {key}", np.concatenate(
            [g[key] for g in sorted(got, key=lambda g: g["ep_index"])]),
            ref.grad.cpu().numpy(), **bar)
    aux_mean = sum(auxes) / 2
    check(all(abs(g["aux"] - aux_mean) <= MA_MOE_TOL * max(1.0, aux_mean)
              for g in got), f"phase 64 (d): aux {[g['aux'] for g in got]}"
          f" against {aux_mean}")
    print(f"  phase 64 (d) experts on {{'ep': 2}}, E {MA_MOE['e']}, k "
          f"{MA_MOE_K}, {n} tokens a rank: output {err:.3e} (bar "
          f"{MA_MOE_TOL}); gradients "
          + ", ".join(f"{k} {e:.3e} ({r:.3g} of its bar)"
                      for k, (e, r) in grads.items())
          + f"; aux {[round(g['aux'], 6) for g in got]} (reference mean "
          f"{aux_mean:.6f}) [{card}]")
    return dict(max_abs_err=err, grad_err_bar=grads,
                aux=[g["aux"] for g in got], aux_reference=aux_mean)


def phase_mesh_axes(dev, card):
    """Phase 64: one world of two gloo ranks on the card runs (a)-(d)
    (module comment above ``MA_SECS``); the one-rank references run
    here, before the world is spawned and after it ends."""
    import tempfile

    from mxnet_tpu_torch import test_utils as tu

    t0 = time.perf_counter()
    refs = {b: ma_reference(dev, b) for b in (8, 16)}
    with tempfile.TemporaryDirectory(prefix="mx_ma_") as workdir:
        cases, batches = ma_cases(workdir)
        tw = time.perf_counter()
        res = tu.spawn_world(2, {"cases": cases, "dir": workdir,
                                 "batches": batches, "allow_tf32": False},
                             f"{workdir}/w2", timeout=MA_RANK_SECS,
                             backend="gloo")
        world_s = time.perf_counter() - tw
        bert = ma_bert(res, refs, dev, card)
        lenet = ma_lenet(res, dev, batches["lenet"], card)
    del refs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ring = ma_ring(res, dev, card)
    moe = ma_moe(res, dev, card)
    secs = time.perf_counter() - t0
    print(f"phase 64 the other mesh axes: tensor and fully sharded "
          f"parallelism, the pipeline, ring attention and experts on two "
          f"gloo ranks on one card; world {world_s:.1f} s, phase "
          f"{secs:.1f} s [{card}]")
    check(secs <= MA_SECS, f"phase 64 took {secs:.1f} s")
    return {"bert": bert, "lenet_pp": lenet, "ring_sp": ring,
            "moe_ep": moe, "world_seconds": world_s, "seconds": secs}


# -- phase 65: Gluon's layers and deferred shapes (A6c), Inception v3 --------
# bench.py's inceptionv3_b32 (bench.py:694): B=32 on 299^2, 1000 classes;
# the tail's AvgPool2D(8) fixes the image size (bench.py:713-714)
INCEPTION = dict(batch=32, image=299, classes=1000, steps=5, check_batch=2)
INC_SECS = 90.0               # the phase's budget (all three parts)
# part (c): a user's net of A6c's layers, channel-first (GroupNorm,
# InstanceNorm, ReflectionPad2D and PixelShuffle2D are), on 32 x 32 images
DEFERRED_NET = dict(batch=16, image=32, classes=10, steps=3)


def inception_deferred(dev, seed=0, dropout=None):
    """``get_model("inceptionv3", layout="NHWC")`` on ``dev`` with every
    width deferred, initialized as ``bench.py`` does (``mx.random.seed``
    then Xavier), and one call on a (2, 299, 299, 3) batch, which infers
    the widths and draws the values (``bench.py:723``).  ``dropout``
    sets the rate of its one dropout layer."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.gluon.parameter import is_deferred

    c = INCEPTION
    net = xavier_init(get_model("inceptionv3", layout="NHWC",
                                classes=c["classes"], device=dev), seed)
    late = sum(is_deferred(p) for p in net.parameters())
    check(late == len(list(net.parameters())) - 1,
          f"Inception v3: {late} deferred parameters before the first call")
    if dropout is not None:
        net.features[19]._rate = dropout
    with torch.no_grad():
        net(torch.zeros(2, c["image"], c["image"], 3, device=dev))
    check(not any(is_deferred(t) for t in net.state_dict().values()),
          "a width of Inception v3 is still deferred after its first call")
    return net


def phase_inception_scoring(dev, card):
    """Phase 65 (a), as ``bench.py`` ``_infer_child("inceptionv3_b32")``
    scores: f32, then ``cast(bf16)`` with a bf16 input, each eager and
    captured (``score_run``: 3 warm and ``INFER_STEPS`` timed batches);
    then bf16 B=2 scores on the card against the CPU (phase 38's bar)."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.kernels import registry

    bf16, c = torch.bfloat16, INCEPTION
    net = inception_deferred(dev)
    x32 = torch.from_numpy(np.random.RandomState(0).rand(
        c["batch"], c["image"], c["image"], 3).astype(np.float32)).to(dev)
    rows = {}
    registry.reset_launches()
    for label in ("f32", "bf16"):
        if label == "bf16":
            net.cast(bf16)
        x = x32 if label == "f32" else x32.to(bf16)
        for mode in ("eager", "captured"):
            net.hybridize(mode == "captured")
            rows[f"{label}_{mode}"] = r = score_run(net, x)
            print(f"  Inception v3 {label} {mode} B={c['batch']}: "
                  f"{r['img_per_s']:.1f} img/s, {r['ms_per_batch']:.3f} ms "
                  f"a batch, peak {r['peak_gib']:.2f} GiB")
        with torch.inference_mode():
            captured = net(x).float()
            net.hybridize(False)
            eager = net(x).float()
        dist = hyb_dist([captured], [eager])
        check(dist <= HYB_BAR, f"Inception v3 {label}: captured vs eager "
              f"{dist:.3e} x max|eager|")
        rows[f"{label}_captured_vs_eager"] = dist
    launched = {k: v for k, v in registry.launches().items() if v}
    check(not launched, f"scoring launched the port's kernels: {launched}")
    check(all(p.dtype == bf16 for p in net.parameters()) and
          all(b_.dtype == bf16 for b_ in net.buffers()),
          "the cast left a parameter or running statistic in f32")
    del x32, x
    # bf16 B=2 on the card against the CPU (phase 38's bar)
    xs = np.random.RandomState(1).rand(c["check_batch"], c["image"],
                                       c["image"], 3).astype(np.float32)
    cpu32 = convert.load_into(
        get_inception_cpu(), {k: v.float().cpu().numpy()
                              for k, v in net.state_dict().items()})
    with torch.inference_mode():
        got = net(torch.from_numpy(xs).to(dev).to(bf16)).float().cpu()
        ref32 = cpu32(torch.from_numpy(xs))
        ref16 = cpu32.cast(bf16)(torch.from_numpy(xs).to(bf16)).float()
    own = (ref16 - ref32).abs().max().item()
    delta = (got - ref16).abs().max().item()
    bar = max(2.0 ** -4 * ref16.abs().max().item(), 3 * own)
    check(bool(torch.isfinite(got).all()) and delta <= bar,
          f"Inception v3 bf16 scores card vs CPU {delta:.3e} > {bar:.3e}")
    print(f"  B=2 299x299 card vs CPU bf16 scores: {delta:.3e} (bar "
          f"{bar:.3e}: the larger of 2^-4 x max|cpu| and 3 x the CPU's own "
          f"bf16-f32 distance {own:.3e})")
    rows["card_vs_cpu"] = dict(delta=delta, bar=bar, cpu_bf16_vs_f32=own)
    del net, cpu32
    torch.cuda.empty_cache()
    return rows


def get_inception_cpu(dropout=None):
    """Inception v3 on the CPU with its widths deferred (to be loaded by
    ``convert.load_into``)."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    net = get_model("inceptionv3", layout="NHWC",
                    classes=INCEPTION["classes"], device="cpu")
    if dropout is not None:
        net.features[19]._rate = dropout
    return net


def inception_step1(dev):
    """Step 1 of phase 65 (b)'s trainer at B=2 in bf16 on the card and on
    the CPU, and in f32 on the CPU (phase 30's rule), on the card net's
    values, with the dropout layer's rate at 0."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.parallel import ShardedTrainer

    c = INCEPTION
    card_net = inception_deferred(dev, seed=1, dropout=0.0)
    values = {k: v.detach().cpu().clone().numpy()
              for k, v in card_net.state_dict().items()}
    out = []
    for where, dt in ((dev, torch.bfloat16), ("cpu", torch.bfloat16),
                      ("cpu", None)):
        net = card_net if where == dev else convert.load_into(
            get_inception_cpu(dropout=0.0), values)
        x, y = resnet_batch(c["check_batch"], c["image"], c["classes"],
                            seed=1, dev=where)
        tr = ShardedTrainer(net, resnet_ce, optimizer="sgd",
                            learning_rate=0.05, momentum=0.9,
                            compute_dtype=dt)
        loss = tr.step(x, y, block=True)
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in zip(tr.train_names, tr.params)}
        stats = {n: b.detach().cpu().clone() for n, b in net.named_buffers()}
        out.append((loss, grads, stats))
        del tr, net
    del card_net
    (gl, gg, gs), (cl, cg, cs), (_, fg, fs) = out
    rel = abs(gl - cl) / abs(cl)
    check(rel <= HALF_LOSS_RTOL, f"Inception v3 bf16 step-1 loss card {gl} "
          f"vs CPU {cl}: rel {rel:.3e} over {HALF_LOSS_RTOL}")
    worst = {}
    for kind, got, want, f32 in (("grad", gg, cg, fg), ("stat", gs, cs, fs)):
        top_rel, top_noise, top_bar = ("", 0.0), ("", 0.0), ("", 0.0)
        for name, w in want.items():
            top = w.abs().max().item()
            err = (got[name] - w).abs().max().item()
            noise = (w - f32[name]).abs().max().item()
            bar = max(HALF_GRAD_TOL * top, HALF_NOISE_BARS * noise)
            check(err <= bar, f"Inception v3 bf16 {kind} {name}: card vs CPU "
                  f"{err:.3e} > max({HALF_GRAD_TOL} x {top:.3e}, "
                  f"{HALF_NOISE_BARS} x the CPU's bf16 vs f32 {noise:.3e})")
            if top > 0 and err / top > top_rel[1]:
                top_rel = (name, err / top)
            if noise > 0 and err / noise > top_noise[1]:
                top_noise = (name, err / noise)
            if err / bar > top_bar[1]:
                top_bar = (name, err / bar)
        worst[kind] = dict(rel=top_rel, to_noise=top_noise, to_bar=top_bar)
    print(f"  step 1 at B=2 card vs CPU in bf16: loss {gl:.6f} vs {cl:.6f} "
          f"(rel {rel:.3e}, bar {HALF_LOSS_RTOL}); worst gradient "
          f"{worst['grad']['rel'][1]:.3e} x max|g| "
          f"({worst['grad']['rel'][0]}), worst running statistic "
          f"{worst['stat']['rel'][1]:.3e} x max ({worst['stat']['rel'][0]});"
          f" against the CPU's bf16-to-f32 distance at most "
          f"{worst['grad']['to_noise'][1]:.3f}x and "
          f"{worst['stat']['to_noise'][1]:.3f}x; bar max({HALF_GRAD_TOL} x "
          f"max, {HALF_NOISE_BARS} x that distance), reached at most "
          f"{worst['grad']['to_bar'][1]:.3f} ({worst['grad']['to_bar'][0]})"
          f" and {worst['stat']['to_bar'][1]:.3f} "
          f"({worst['stat']['to_bar'][0]})")
    return dict(loss_rel_err=rel, grad_rel_err=worst["grad"]["rel"][1],
                worst_grad=worst["grad"]["rel"][0],
                grad_to_noise=worst["grad"]["to_noise"][1],
                stat_rel_err=worst["stat"]["rel"][1],
                worst_stat=worst["stat"]["rel"][0],
                stat_to_noise=worst["stat"]["to_noise"][1],
                grad_to_bar=worst["grad"]["to_bar"][1],
                stat_to_bar=worst["stat"]["to_bar"][1])


def inception_arena_row(dev, shapes):
    """The arena kernel in its momentum mode over an arena of Inception
    v3's parameters (``build_layout`` of their shapes), as phase 49 times
    it: device time, the plain version's by events,
    ``torch._fused_sgd_``'s device time and the bytes bound (g and m
    read, m and delta written, 4 bytes each)."""
    from mxnet_tpu_torch.kernels import opt_arena as oa

    lay = oa.build_layout(shapes)
    g, st = arena_inputs(lay, oa.VARIANT_STATES["momentum"], seed=65,
                         dev=dev)
    ref = [s_.clone() for s_ in st]
    kw = dict(momentum=0.9)
    d, _ = oa.arena_update("momentum", g, st, 0.05, 3, **kw)
    d_ref, _ = oa.arena_update_reference("momentum", g, ref, 0.05, 3, **kw)
    err = (d - d_ref).abs().max().item()
    check(err <= 1e-6 * d_ref.abs().max().item(),
          f"arena momentum at Inception v3's arena: {err:.3e}")
    ms = device_ms_per_call(lambda i: oa.arena_update(
        "momentum", g, st, 0.05, 3, **kw), 1, calls=10)
    plain = cuda_time_ms(lambda i: oa.arena_update_reference(
        "momentum", g, st, 0.05, 3, **kw), 1, iters=5, reps=3)
    lib = None
    if hasattr(torch, "_fused_sgd_"):
        p, buf = torch.zeros_like(g), [torch.zeros_like(g)]
        lib = device_ms_per_call(lambda i: torch._fused_sgd_(
            [p], [g], buf, weight_decay=0.0, momentum=0.9, lr=0.05,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), 1, calls=10)
    nbytes = 4 * lay.padded * 4
    bnd = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  arena momentum over Inception v3's {lay.total} parameters "
          f"({lay.padded} padded): kernel {ms:.4f} ms device time, bound "
          f"{bnd:.4f} ms ({nbytes} B / 3.35e12 B/s; {bnd / ms:.2f} of it), "
          f"plain {plain:.4f} ms (events), torch._fused_sgd_ "
          f"{'n/a' if lib is None else f'{lib:.4f} ms'} device time")
    return dict(elements=lay.padded, parameters=lay.total, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by="bytes", max_abs_err=err)


def phase_inception_train(dev, card):
    """Phase 65 (b): ``ShardedTrainer`` refuses the deferred net, then
    trains it after one call: 5 bf16 steps at B=32 on 299^2 (sgd,
    momentum 0.9), the launch counts set to 0 just before them; step 1
    against the CPU; the arena at Inception v3's size."""
    from mxnet_tpu_torch.base import DeferredInitializationError
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.kernels import registry
    from mxnet_tpu_torch.parallel import ShardedTrainer

    c = INCEPTION
    kw = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
              compute_dtype=torch.bfloat16)
    late = xavier_init(get_model("inceptionv3", layout="NHWC",
                                 classes=c["classes"], device=dev), 0)
    try:
        ShardedTrainer(late, resnet_ce, **kw)
        refused = ""
    except DeferredInitializationError as e:
        refused = str(e)
    check("features.0.0.weight" in refused and "run the block once" in
          refused, f"ShardedTrainer took a deferred net: {refused!r}")
    del late
    net = inception_deferred(dev)
    tr = ShardedTrainer(net, resnet_ce, **kw)
    check(tr.uses_arena, "the trainer did not pick the arena adapter")
    shapes = [tuple(p.shape) for p in tr.params]
    x, y = resnet_batch(c["batch"], c["image"], c["classes"], seed=0,
                        dev=dev)
    stat = net.features[0][1].running_mean
    stat0 = stat.clone()
    steps = c["steps"]
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launches()
    losses = []
    for i in range(steps):
        starts[i].record()
        losses.append(tr.step(x, y))
        ends[i].record()
    tr.drain()
    torch.cuda.synchronize()
    launches = registry.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [s_.elapsed_time(e) for s_, e in zip(starts, ends)]
    vals = [float(v) for v in losses]
    check(launches.get("opt_arena", 0) == steps,
          f"opt_arena launched {launches.get('opt_arena', 0)} times in "
          f"{steps} steps")
    check(all(v == 0 for k, v in launches.items() if k != "opt_arena"),
          f"other kernels launched: {launches}")
    check(all(math.isfinite(v) for v in vals), f"non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"loss did not fall: {vals}")
    check(all(p.dtype == torch.float32 for p in net.parameters()),
          "a master parameter left f32")
    check(not torch.equal(stat, stat0), "the running statistics never moved")
    sps = c["batch"] * (steps - 1) * 1e3 / sum(step_ms[1:])
    del tr, net, x, y
    torch.cuda.empty_cache()
    out = dict(samples_per_s=sps, step_ms=step_ms,
               step_p50_ms=statistics.median(step_ms[1:]),
               peak_mem_bytes=peak, steps=steps, batch=c["batch"],
               losses=vals, launches={k: v for k, v in launches.items()
                                      if v})
    print(f"  Inception v3 bf16 training B={c['batch']} 299x299: loss by "
          f"step {' '.join(f'{v:.4f}' for v in vals)}; {sps:.2f} samples/s "
          f"over steps 2-{steps} (CUDA events; step 1 {step_ms[0]:.1f} ms), "
          f"peak {peak / 2**30:.2f} GiB; launches {out['launches']} "
          f"[{card}]")
    out["card_vs_cpu"] = inception_step1(dev)
    out["arena"] = inception_arena_row(dev, shapes)
    return out


def deferred_gluon_net(dev):
    """Phase 65 (c)'s net: every width but PReLU's (which never infers)
    left to the first call; ``AvgPool2D(ceil_mode=True)`` gives its
    branch the 16 x 16 map the other branch has (the valid convention
    would give 15, and the concatenation would refuse it)."""
    from mxnet_tpu_torch.gluon import nn

    kw = dict(device=dev)
    stem = nn.HybridSequential().add(
        nn.ReflectionPad2D(1), nn.Conv2D(64, 3, in_channels=0, **kw),
        nn.GroupNorm(4, **kw), nn.PReLU(**kw))
    branches = nn.HybridConcatenate(axis=1).add(
        nn.Conv2D(64, 1, strides=2, **kw),
        nn.HybridSequential().add(nn.AvgPool2D(3, 2, ceil_mode=True),
                                  nn.Conv2D(128, 1, **kw)))
    head = nn.HybridSequential().add(
        nn.InstanceNorm(**kw), nn.Conv2D(256, 3, padding=1, **kw),
        nn.PixelShuffle2D(2), nn.Conv2D(128, 3, strides=2, padding=1, **kw),
        nn.Activation("relu"),
        nn.Conv2DTranspose(64, 4, strides=2, padding=1, **kw),
        nn.AvgPool2D(4), nn.Dense(256, activation="relu", in_units=0, **kw),
        nn.Dense(DEFERRED_NET["classes"], **kw))
    return nn.Sequential().add(stem, branches, head)


def phase_deferred_gluon(dev, card):
    """Phase 65 (c): the net above, ``gluon.Trainer`` built before its
    first call, 3 eager steps (record, loss, backward, step), then
    ``hybridize()``: each hybrid child captured, scores within
    ``HYB_BAR`` of the eager ones."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.parameter import is_deferred
    from mxnet_tpu_torch.kernels import registry

    c = DEFERRED_NET
    net = xavier_init(deferred_gluon_net(dev), 65)
    params = net.collect_params()
    late = sorted(n for n, p in params.items() if is_deferred(p))
    check(len(late) == 12, f"deferred before the first call: {late}")
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                            "momentum": 0.9})
    rs = np.random.RandomState(65)
    x = torch.from_numpy(rs.rand(c["batch"], 3, c["image"], c["image"])
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rs.randint(0, c["classes"], size=(c["batch"],))
                         .astype(np.int64)).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    losses, before = [], None
    registry.reset_launches()
    t0 = time.perf_counter()
    for i in range(c["steps"]):
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        if i == 0:
            before = {n: p.detach().clone() for n, p in params.items()}
        trainer.step(c["batch"])
        losses.append(float(loss.detach().mean()))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launched = {k: v for k, v in registry.launches().items() if v}
    check(not any(is_deferred(t) for t in net.state_dict().values()),
          "a width is still deferred after the first step")
    check(net.collect_params().keys() == params.keys() and all(
        net.collect_params()[n] is p for n, p in params.items()),
        "materializing replaced a parameter object")
    moved = [n for n, p in params.items() if not torch.equal(p, before[n])]
    check(len(moved) == len(params), f"parameters the trainer never moved: "
          f"{sorted(set(params) - set(moved))}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    widths = {n: tuple(params[n].shape) for n in late}
    with torch.no_grad():
        eager = net(x)
        net.hybridize()
        net(x)                                  # the eager first call
        net(x)                                  # warm run + capture
        captured = net(x)
    dist = hyb_dist([captured], [eager])
    check(dist <= HYB_BAR, f"deferred net: captured vs eager {dist:.3e}")
    traced = [len(b._cached_op._traced) for b in net
              if b._cached_op is not None]
    check(traced == [1, 1, 1], f"captured signatures by child: {traced}")
    print(f"  a Gluon user's net of A6c's layers (widths 64-256, B="
          f"{c['batch']} {c['image']}x{c['image']}): {len(late)} deferred "
          f"tensors inferred at the first step ({widths}); loss "
          f"{' '.join(f'{v:.4f}' for v in losses)} through gluon.Trainer in "
          f"{train_s:.2f} s; captured vs eager {dist:.3e} x max; kernels "
          f"launched {launched or 'none'} [{card}]")
    return dict(deferred=len(late), widths={n: list(w) for n, w in
                                            widths.items()},
                losses=losses, train_s=train_s, captured_vs_eager=dist,
                launches=launched)


def phase_inception(dev, card):
    """Phase 65: (a) scoring, (b) training, (c) the deferred Gluon net."""
    t0 = time.perf_counter()
    scoring = phase_inception_scoring(dev, card)
    train = phase_inception_train(dev, card)
    gluon_net = phase_deferred_gluon(dev, card)
    secs = time.perf_counter() - t0
    print(f"phase 65 Gluon's layers and deferred shapes: Inception v3 "
          f"scoring bf16 {scoring['bf16_eager']['img_per_s']:.1f} img/s eager"
          f" and {scoring['bf16_captured']['img_per_s']:.1f} captured at "
          f"B=32 (f32 {scoring['f32_eager']['img_per_s']:.1f} and "
          f"{scoring['f32_captured']['img_per_s']:.1f}), training bf16 "
          f"{train['samples_per_s']:.2f} samples/s, opt_arena "
          f"{train['launches'].get('opt_arena', 0)} launches in "
          f"{train['steps']} steps; phase {secs:.1f} s [{card}]")
    check(secs <= INC_SECS, f"phase 65 took {secs:.1f} s")
    return dict(scoring=scoring, train=train, deferred_gluon=gluon_net,
                seconds=secs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mxnet_tpu_torch.kernels import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    card = card_line()
    worst = phase_kernels(dev)
    phase_decode_splits(dev, worst)
    times = phase_times(dev)
    print("phase 3 times: done")
    lm, f32 = phase_serve_f32(dev, card)
    i8 = phase_serve_int8(lm, card)
    del lm
    flash_worst = phase_flash_kernel(dev)
    flash_times = phase_flash_times(dev)
    bert = phase_bert(dev, card)
    bwd_worst = phase_bwd_kernels(dev)
    bwd_times = phase_bwd_times(dev)
    arena = phase_arena(dev)
    train = phase_train(dev, card)
    train_cpu = phase_train_cpu(dev)
    bn_worst = phase_bn_kernels(dev)
    bn_times = phase_bn_times(dev)
    resnet = phase_resnet(dev, card)
    resnet_cpu = phase_resnet_cpu(dev)
    ext_worst = phase_ext_kernels(dev)
    ext_times = phase_ext_times(dev)
    lenet = phase_lenet(dev, card)
    ext_drive = phase_ext_drive(dev, card)
    resnet_eager = phase_resnet_eager(dev, card, resnet)
    half_worst = phase_half_kernels(dev)
    half_times = phase_half_times(dev)
    train_bf16 = phase_train_bf16(dev, card, train)
    train_fp16 = phase_train_fp16(dev, card, train)
    train_cpu_bf16 = phase_train_cpu_bf16(dev)
    bn16_worst = phase_bn16_kernels(dev)
    bn16_times = phase_bn16_times(dev)
    resnet_bf16 = phase_resnet_bf16(dev, card, resnet)
    resnet_fp16 = phase_resnet_fp16(dev, card, resnet)
    resnet_cpu_bf16 = phase_resnet_cpu_bf16(dev)
    multi_tensor = phase_multi_tensor(dev, card)
    sched_accum = phase_schedule_accum(dev, card)
    resume = phase_resume(dev, card)
    registry_opts = phase_registry(dev, card)
    dec16_worst = phase_decode16_kernels(dev)
    dec16_times = phase_decode16_times(dev)
    serve_bf16 = phase_serve_bf16(dev, card, f32)
    bert_bf16 = phase_bert_bf16(dev, card, bert)
    resnet_infer = phase_resnet_infer(dev, card)
    lenet_drive_runs = phase_lenet_drive(dev, card)
    rnn_ops = phase_rnn_ops(dev)
    lstm_train = phase_lstm_lm(dev, card)
    lstm_serve = phase_lstm_serve(dev, card)
    boxes = phase_boxes(dev)
    ssd_train, ssd_net, ssd_x, _ = phase_ssd(dev, card)
    ssd_cpu = phase_ssd_cpu(dev)
    ssd_dets = phase_detections(dev, ssd_net, ssd_x)
    del ssd_net, ssd_x
    torch.cuda.empty_cache()
    ssd_drive = phase_ssd_drive(dev, card)
    losses = phase_losses(dev)
    arena_sgd = phase_arena_sgd(dev, ssd_train["parameters"])
    hyb_block = phase_hybrid_block(dev, card)
    hyb_decode = phase_hybrid_decode(dev, card)
    hyb_lstm = phase_hybrid_lstm(dev, card)
    hyb_batch = phase_hybrid_batch(dev, card)
    hyb_lenet = phase_hybrid_lenet(dev, card)
    bn_workspace = phase_bn_workspace(dev, card)
    pool = phase_pool_serve(dev, card)
    pool_lstm = phase_pool_lstm(dev, card)
    obs_phase = phase_obs(dev, card)
    bert_prof = phase_bert_profile(dev, card)
    t_net = time.perf_counter()
    fleet_out, fleet_lm = phase_fleet(dev, card)
    edge_out = phase_edge(dev, card, fleet_lm)
    del fleet_lm
    bucketed = phase_bucketed(dev, card)
    net_s = time.perf_counter() - t_net
    check(net_s <= FLEET_SECS + EDGE_SECS + BUCKETED_SECS,
          f"phases 60-62 took {net_s:.1f} s")
    dp = phase_dp(dev, card)
    dp_pair = dp["two_ranks_gloo"]
    axes = phase_mesh_axes(dev, card)
    ma_bert_runs = axes["bert"]
    inception = phase_inception(dev, card)
    inc_train = inception["train"]

    def ma_launches(name, runs):
        """Phase 64's launches of kernel ``name``, by run and rank."""
        return {run: [ln.get(name, 0) for ln in
                      ma_bert_runs[run]["launches_by_rank"]]
                for run in runs}
    launches = {"flash_attention_decode": f32["launches"],
                "flash_attention_decode_int8": i8["launches"]}
    kernels = []
    for name, variant in (("flash_attention_decode", "f32"),
                          ("flash_attention_decode_int8", "int8")):
        src, replaces = registry.KERNELS[name]
        dec = times[name]["decode"]
        kernels.append(dict(
            name=name, variant=variant, route="cuda",
            source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
            launches=launches[name], max_abs_err=worst[name],
            max_err=worst[name], ms=dec["ms"], kernel_ms=dec["ms"],
            device_ms=dec["device_ms"], device_spun_ms=dec["device_spun_ms"],
            plain_ms=dec["plain_ms"],
            bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
            bound_note="f32 on CUDA cores, which the split-K path runs: "
                       "max(bytes / 3.35e12, flops / 67e12)",
            bound_f32_ms=dec["bound_f32_ms"],
            bound_tf32x3_ms=dec["bound_tf32x3_ms"],
            library_ms=dec["library_ms"],
            library_device_ms=dec["library_device_ms"],
            library="scaled_dot_product_attention with the boolean decode "
                    "mask" if variant == "f32" else None,
            launches_phase56={m: pool[variant][m]["launches"]
                              for m in POOL_MODES},
            launches_phase58=obs_phase["launches"].get(name, 0),
            launches_phase60=[ln.get(name, 0)
                              for ln in fleet_out["launches_served"]],
            launches_phase60_warmup=[r["launches_warmup"].get(name, 0)
                                     for r in fleet_out["replicas"]],
            launches_phase61=edge_out["launches"].get(name, 0),
            hit_shapes=pool["hit_shapes"][name],
            splits=dec["splits"], split_len=dec["split_len"],
            launches_per_call=dec["launches_per_call"],
            shape=dec["shape"], prefill=times[name]["prefill"],
            prefill_1024=times[name]["prefill_1024"],
            decode_c100=times[name]["decode_c100"],
            decode_d36=times[name]["decode_d36"]))
    src, replaces = registry.KERNELS["flash_attention"]
    main_shape = flash_times["serve_b16"]
    train_launches = train["launches"]
    kernels.append(dict(
        name="flash_attention", variant="f32", route="cuda",
        source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
        launches=bert["launches"] + train_launches["flash_attention"],
        launches_serving=bert["launches"],
        launches_training=train_launches["flash_attention"],
        launches_phase58=obs_phase["bert"]["flash_attention_launches"],
        launches_phase60=[ln.get("flash_attention", 0)
                          for ln in fleet_out["launches_served"]],
        launches_phase60_warmup=[r["launches_warmup"].get(
            "flash_attention", 0) for r in fleet_out["replicas"]],
        launches_phase64=ma_launches("flash_attention", ("bert_mp_f32",)),
        max_abs_err=flash_worst,
        ms=main_shape["ms"], device_ms=main_shape["device_ms"],
        plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        bound_note="3xTF32 on tensor cores: max(bytes / 3.35e12, "
                   "3 flops / 495e12)",
        bound_f32_ms=main_shape["bound_f32_ms"],
        bound_f32_by=main_shape["bound_f32_by"],
        library_ms=main_shape["library_ms"],
        library_device_ms=main_shape["library_device_ms"],
        library="scaled_dot_product_attention with the boolean key-padding "
                "mask", shape=main_shape["shape"],
        serve_b8=flash_times["serve_b8"],
        serve_b8_d36=flash_times["serve_b8_d36"]))
    for name, key in (("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv")):
        src, replaces = registry.KERNELS[name]
        row = bwd_times["train"][key]
        kernels.append(dict(
            name=name, variant="f32", route="cuda",
            source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
            launches=train_launches[name], max_abs_err=bwd_worst[key],
            launches_phase64=ma_launches(name, ("bert_mp_f32",)),
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            bound_note="3xTF32 on tensor cores: max(bytes / 3.35e12, "
                       "3 flops / 495e12)",
            bound_f32_ms=row["bound_f32_ms"],
            bound_f32_by=row["bound_f32_by"],
            library_ms=row["library_ms"], shape=row["shape"],
            whole_bwd_ms=row["whole_bwd_ms"],
            whole_bwd_device_ms=row["whole_bwd_device_ms"],
            library_events_ms=row["library_events_ms"],
            library="SDPA backward, dq dk dv together (device time, "
                    "torch.profiler)",
            plain="dq dk dv together", long=bwd_times["long"][key]))
    src, replaces = registry.KERNELS["opt_arena"]
    kernels.append(dict(
        name="opt_arena", variant="adam, sgd, momentum", route="cuda",
        source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
        launches=train_launches["opt_arena"]
        + lstm_train["launches"]["opt_arena"]
        + ssd_train["launches"]["opt_arena"]
        + inc_train["launches"]["opt_arena"],
        launches_by_variant={
            "adam": train_launches["opt_arena"],
            "sgd": lstm_train["launches"]["opt_arena"],
            "momentum": ssd_train["launches"]["opt_arena"]
            + inc_train["launches"]["opt_arena"]},
        launches_phase65=inc_train["launches"]["opt_arena"],
        inceptionv3_momentum=inc_train["arena"],
        launches_schedule_accum=sched_accum["launches_opt_arena"],
        launches_phase62=bucketed["runs"]["prefetch"]["launches"].get(
            "opt_arena", 0),
        launches_phase63={
            "one_rank_nccl_zero1": {k: v["launches_per_step"].get(
                "opt_arena", 0) * DP_TIMED for k, v in
                dp["one_rank_nccl"].items()},
            "two_ranks_zero1_by_rank": {k: [ln.get("opt_arena", 0) for ln in
                                            dp_pair[k]["launches_by_rank"]]
                                        for k in ("resnet", "bert")},
            "shard_of_padded": {k: [dp_pair[k]["arena_shard"],
                                    dp_pair[k]["arena_padded"]]
                                for k in ("resnet", "bert")}},
        launches_phase64={"lenet_pp_zero1_by_rank": [
            ln.get("opt_arena", 0) for ln in
            axes["lenet_pp"]["launches_by_rank"]]},
        max_abs_err=arena["max_abs_err"], ms=arena["ms"],
        plain_ms=arena["plain_ms"], bound_ms=arena["bound_ms"],
        bound_by=arena["bound_by"], library_ms=arena["library_ms"],
        shape=arena["shape"], library="torch._fused_adam_",
        sgd_modes=arena_sgd,
        sgd_modes_library="torch._fused_sgd_ (device time; it also reads "
                          "and writes the parameters)"))
    for name, key, lib in (
            ("bn_act_stats", "stats", "torch.var_mean"),
            ("bn_act_apply", "apply", "F.batch_norm(training=True) + relu_, "
                                      "both passes, two calls")):
        src, replaces = registry.KERNELS[name]
        row = bn_times["stem"][key]
        kernels.append(dict(
            name=name, variant="f32", route="cuda",
            source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
            launches=resnet["launches"][name], max_abs_err=bn_worst[name],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], library=lib,
            stage4=bn_times["stage4"][key],
            launches_eager=resnet_eager["launches"][name]))
    for name in EXT_KERNELS:
        src, replaces = registry.KERNELS[name]
        row = ext_times[name]
        kernels.append(dict(
            name=name, variant="f32", route="cuda",
            source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
            launches=ext_drive["launches"][name],
            max_abs_err=ext_worst[name], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library=row["library"], shape=row["shape"],
            main_path_shape="ExtLeNet, B=64: 64x1x28x28 (axpb), 64x500 "
                            "(squared ReLU)"))
    for sfx, run in (("bf16", train_bf16), ("f16", train_fp16)):
        # each kernel's row at the shape of its main path: the forward
        # and the fused dk/dv launch at the training shape (T = 128), dq
        # at T = 512 (the serving shape's times; the 512-token phase's
        # launches), with the two-launch dk/dv there beside it
        for name, key, shape in (("flash_attention", "fwd", "train"),
                                 ("flash_attention_bwd_dq", "dq", "serve"),
                                 ("flash_attention_bwd_dkv", "fused",
                                  "train")):
            full = f"{name}.{sfx}"
            src, replaces = registry.KERNELS[full]
            row = half_times[sfx][shape][key]
            n128 = run["launches"].get(full, 0)
            n512 = run["seq512"]["launches"].get(full, 0)
            kernels.append(dict(
                name=full, variant=sfx, route="cuda",
                source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
                launches=n128 + n512, launches_seq128=n128,
                launches_seq512=n512,
                launches_phase59=bert_prof["launches"].get(full, 0),
                **({"launches_phase64": ma_launches(
                    full, ("bert_mp", "bert_fsdp"))} if sfx == "bf16"
                   else {}),
                launches_phase62=bucketed["runs"]["prefetch"][
                    "launches"].get(full, 0),
                max_abs_err=half_worst[sfx]["dkv" if key == "fused"
                                            else key], ms=row["ms"],
                time_by="device time (profiler)", plain_ms=row["plain_ms"],
                plain="events" + ("" if key == "fwd" else
                                  ", dq dk dv together"),
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                bound_note="max(bytes / 3.35e12, 16-bit MMA flops / "
                           "989e12): S, dP exact, each f32 x 16-bit "
                           "product as two 16-bit MMAs",
                library_ms=row["library_ms"],
                library=f"scaled_dot_product_attention ({sfx}, boolean "
                        "key-padding mask), " + ("forward" if key == "fwd"
                                                  else "backward, dq dk dv "
                                                  "together") + ", device "
                        "time", shape=row["shape"],
                mode=("fused: dq, dk and dv in one launch" if key == "fused"
                      else None),
                **({"two_launch_dkv": half_times[sfx]["serve"]["dkv"],
                    "serve_whole_bwd_ms":
                        half_times[sfx]["serve"]["whole_bwd_ms"]}
                   if key == "fused" else {}),
                **({"serve": half_times[sfx]["serve"]["fwd"]}
                   if key == "fwd" else {})))
    for sfx, run in (("bf16", resnet_bf16["fused"]), ("f16", resnet_fp16)):
        # the stem's row (the largest shape); every shape under by_shape
        for kernel, key, lib in (
                ("bn_act_stats", "stats", f"torch.var_mean ({sfx} x)"),
                ("bn_act_apply", "apply",
                 f"F.batch_norm(training=True) + relu_ ({sfx} x, f32 "
                 "weights), both passes, two calls")):
            full = f"{kernel}.{sfx}"
            src, replaces = registry.KERNELS[full]
            row = bn16_times[sfx][0][key]
            kernels.append(dict(
                name=full, variant=sfx, route="cuda",
                source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
                launches=run["launches"].get(full, 0),
                max_abs_err=bn16_worst[full], ms=row["ms"],
                time_by="device time (profiler)", plain_ms=row["plain_ms"],
                plain="events", bound_ms=row["bound_ms"],
                bound_by=row["bound_by"],
                bound_note="max(bytes / 3.35e12, 3 flops an element / "
                           "67e12): x and y 2 bytes an element",
                library_ms=row["library_ms"], library=lib,
                shape=row["shape"],
                by_shape=[r[key] for r in bn16_times[sfx]]))
    for name, row in dp["kernel_rows"].items():
        # the dp mode of bn_act.cu: launched on part (b)'s two ranks
        src, replaces = registry.KERNELS[name]
        by_rank = [ln.get(name, 0) for ln in
                   dp_pair["resnet"]["launches_by_rank"]]
        kernels.append(dict(
            name=name, variant="bf16, data parallel", route="cuda",
            source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
            launches=sum(by_rank), launches_by_rank=by_rank,
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            time_by="device time (profiler)", plain_ms=row["plain_ms"],
            plain="events", bound_ms=row["bound_ms"],
            bound_by=row["bound_by"],
            bound_note="sums: max(bytes / 3.35e12, 3 flops an element / "
                       "67e12), x 2 bytes an element, 2 C doubles out; "
                       "fold: (2 C + 1) doubles, gamma, beta in, mean, "
                       "var, scale, shift out, 10 flops a channel",
            library_ms=None, library="no single PyTorch call sums in "
            "float64 and folds", shape=row["shape"],
            f32_variant_max_abs_err=row["f32_max_abs_err"],
            **({"one_launch_stats_ms": row["one_launch_stats_ms"]}
               if "one_launch_stats_ms" in row else {})))
    for name, row in dec16_times.items():
        src, replaces = registry.KERNELS[name]
        dec = row["decode"]
        kernels.append(dict(
            name=name, variant=name.split(".")[1], route="cuda",
            source=f"mxnet_tpu_torch/csrc/{src}", replaces=replaces,
            launches=serve_bf16["launches"][name],
            max_abs_err=max(dec16_worst[name], dec["max_abs_err"]),
            ms=dec["ms"], time_by="device time (profiler)",
            plain_ms=dec["plain_ms"], plain="events",
            bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
            bound_note="max(bytes / 3.35e12, 2 d flops an attended pair "
                       "a product / 989e12 on the chunk path and on the "
                       "tensor-core split-K path (every 16-bit cache, int8 "
                       "under 16-bit queries; each MMA of a split term "
                       "counted), / 67e12 on the other pairs' split-K "
                       "path); each value its type's bytes",
            launches_per_call=dec["launches_per_call"],
            library_ms=dec["library_ms"],
            library=("scaled_dot_product_attention in the same type with "
                     "the boolean decode mask, device time"
                     if dec["library_ms"] is not None else None),
            shape=dec["shape"], splits=dec["splits"],
            split_len=dec["split_len"], prefill=row.get("prefill"),
            **({"launches_phase56": {m: pool["bf16"][m]["launches"]
                                     for m in POOL_MODES},
                "hit_shapes": pool["hit_shapes"][name]}
               if name in pool["hit_shapes"] else {})))
    print(f"end to end: f32 {f32['tokens_per_s']:.1f} tokens/s, int8 "
          f"{i8['tokens_per_s']:.1f} tokens/s, BERT-base "
          f"{bert['requests_per_s']:.1f} requests/s, BERT-base training "
          f"{train['samples_per_s']:.2f} samples/s, ResNet-50 training "
          f"{resnet['img_per_s']:.2f} img/s, LeNet-5 eager "
          f"{lenet['img_per_s']:.1f} img/s, extension block "
          f"{ext_drive['img_per_s']:.1f} img/s, BERT-base bf16 training "
          f"{train_bf16['samples_per_s']:.2f} samples/s, f16 "
          f"{train_fp16['samples_per_s']:.2f} samples/s, ResNet-50 bf16 "
          f"training {resnet_bf16['plain']['img_per_s']:.2f} img/s "
          f"(BatchNorm) and {resnet_bf16['fused']['img_per_s']:.2f} img/s "
          f"(fused), f16 {resnet_fp16['img_per_s']:.2f} img/s, GPT-2-small "
          f"bf16 {serve_bf16['tokens_per_s']:.1f} tokens/s, BERT-base bf16 "
          f"{bert_bf16['requests_per_s']:.1f} requests/s, ResNet-50 bf16 "
          f"scoring {resnet_infer['bf16_b32']['img_per_s']:.1f} img/s at "
          f"B=32 and {resnet_infer['bf16_b128']['img_per_s']:.1f} at B=128 "
          f"(f32 {resnet_infer['f32_b32']['img_per_s']:.1f} and "
          f"{resnet_infer['f32_b128']['img_per_s']:.1f}), the LeNet drive "
          f"{lenet_drive_runs['workers0']['img_per_s']:.1f} img/s "
          f"(num_workers=0) and "
          f"{lenet_drive_runs['workers2_pinned']['img_per_s']:.1f} "
          f"(num_workers=2, pinned), the LSTM LM "
          f"{lstm_train['lstm_lm_tokens_per_sec_per_chip']:.1f} tokens/s "
          f"training and {lstm_serve['tokens_per_s']:.1f} tokens/s served, "
          f"SSD-ResNet50 "
          f"{ssd_train['ssd_resnet50_train_imgs_per_sec_per_chip']:.2f} "
          f"img/s training in bf16 at 512x512, GPT-2 small through the "
          f"prefill pool {pool['f32']['pool']['tokens_per_s']:.1f} and with "
          f"the prefix cache {pool['f32']['prefix']['tokens_per_s']:.1f} "
          f"tokens/s (unified {pool['f32']['unified']['tokens_per_s']:.1f});"
          f" GPT-2 small scraped with trace and obs on "
          f"{obs_phase['tokens_per_s']:.1f} tokens/s; BERT-base bf16 from "
          f"mx.np {bert_prof['tflops_per_s']:.3f} TFLOP/s (utilization "
          f"{bert_prof['utilization']:.6f}) under mx.profiler; a fleet of 2 "
          f"replicas {fleet_out['load']['requests_per_s']:.2f} routed "
          f"requests/s ({fleet_out['load']['stream_tokens_per_s']:.1f} "
          f"streamed tokens/s, kill to ready "
          f"{fleet_out['kill']['kill_to_ready_s']:.2f} s); BERT-base bf16 "
          f"from a bucketed loader "
          f"{bucketed['runs']['prefetch']['samples_per_s']:.1f} samples/s "
          f"prefetched, {bucketed['runs']['inline']['samples_per_s']:.1f} "
          f"inline; phases 60-62 {net_s:.1f} s; data parallel (phase 63) "
          f"ResNet-50 "
          f"{dp['one_rank_nccl']['resnet']['samples_per_s_per_device']:.2f}"
          f" and BERT-base "
          f"{dp['one_rank_nccl']['bert']['samples_per_s_per_device']:.2f} "
          f"samples/s a device under zero1 on one NCCL rank, "
          f"{dp['seconds']:.1f} s; the other mesh axes (phase 64) "
          f"{axes['seconds']:.1f} s; Inception v3 (phase 65) bf16 "
          f"scoring {inception['scoring']['bf16_captured']['img_per_s']:.1f}"
          f" img/s captured at B=32, training "
          f"{inc_train['samples_per_s']:.2f} samples/s, "
          f"{inception['seconds']:.1f} s; whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels,
                      "serve": {"f32": f32, "int8": i8, "bert": bert,
                                "bf16": serve_bf16, "bert_bf16": bert_bf16,
                                "resnet50_scoring": resnet_infer,
                                "lstm_lm": lstm_serve,
                                "inceptionv3_scoring":
                                    inception["scoring"]},
                      "train": {"bert_base": train, "card_vs_cpu": train_cpu,
                                "resnet50": resnet,
                                "resnet_card_vs_cpu": resnet_cpu,
                                "lenet": lenet, "extension_block": ext_drive,
                                "resnet50_eager": resnet_eager,
                                "bert_base_bf16": train_bf16,
                                "bert_base_fp16": train_fp16,
                                "card_vs_cpu_bf16": train_cpu_bf16,
                                "resnet50_bf16": resnet_bf16,
                                "resnet50_fp16": resnet_fp16,
                                "resnet_card_vs_cpu_bf16":
                                    resnet_cpu_bf16,
                                "multi_tensor": multi_tensor,
                                "schedule_grad_accum": sched_accum,
                                "resume": resume,
                                "registry_optimizers": registry_opts,
                                "lenet_drive": lenet_drive_runs,
                                "lstm_lm": lstm_train,
                                "ssd_resnet50": ssd_train,
                                "ssd_card_vs_cpu": ssd_cpu,
                                "ssd_drive": ssd_drive,
                                "inceptionv3": inc_train,
                                "deferred_gluon":
                                    inception["deferred_gluon"]},
                      "hybridize": {"block": hyb_block,
                                    "decode": hyb_decode,
                                    "lstm_lm": hyb_lstm,
                                    "batch": hyb_batch,
                                    "lenet_drive": hyb_lenet},
                      "observability": obs_phase,
                      "cost_profile": bert_prof,
                      "data_parallel": dp,
                      "mesh_axes": axes,
                      "network": {"fleet": fleet_out, "edge": edge_out,
                                  "bucketed_loader": bucketed,
                                  "phases_60_62_s": net_s},
                      "prefill_pool": {"gpt2_small": pool,
                                       "lstm_lm": pool_lstm,
                                       "bn_workspace": bn_workspace},
                      "detections": ssd_dets, "box_ops_card_vs_cpu": boxes,
                      "losses_card_vs_cpu": losses,
                      "rnn_ops_card_vs_cpu": rnn_ops,
                      "bn_act_device": bn_times["device"],
                      "bn_act16_device": bn16_times,
                      "device_time_by": DEVICE_TIME_BY,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
