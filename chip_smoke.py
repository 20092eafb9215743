#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds each kernel bit for bit against its plain PyTorch version on the
   card: bf16 and float16, signed 8x128 token blocks, 2x2 and 4x4 blocks,
   bf16 8x24 and 8x256 blocks, rows of 24 bytes, a map whose data starts
   off 16 bytes, the kv_cache shape, an all-dead map and NaN/Inf inputs;
3. trains (``CNNTrainer.train``): ResNet-18 at full width on Tiny-ImageNet
   shapes (3x64x64, 200 classes), random weights from seed 0, batch 64,
   block 8, SGD with step decay from 0.05 and gradient clipping at 10,
   float32 with TF32 off, 5 steps in each of four runs:
   R  the ``reference`` backend at the constant T_obj 1.5 (the yardstick);
   B  the ``pallas`` backend at T_obj 1.5: the masking kernel forward, the
      hard-gate backward. Step 1's loss and every gradient, and the
      variables after 5 steps, must equal R's bit for bit; the masking
      kernel must launch 17 sites x 5 steps times;
   C  the ``stream`` backend at T_obj 1.5: the three stream kernels 17 x 5
      times each, the variables equal to R's, every site's stream bytes
      inside the Eq. 2/3 band;
   A  the paper's Eq. 1: threshold nets at T_obj 0.2 with their L2
      regulariser. The run asks for ``pallas`` and every site must resolve
      to ``reference(tnet)``, as the capability rules send a site with a
      net; the loss must stay finite and ``zebra_reg`` fall from step 1 to
      step 5;
4. drives the inference slice with B's trained variables:
   ``CNNTrainer.evaluate`` over 4 batches of 128 images on ``stream``
   (T_obj 1.5). Every stream kernel must have launched 17 sites x 4
   batches times; every site's stream bytes must lie in the Eq. 2/3 band;
   the logits must equal, bit for bit, a ``reference``-backend run;
5. checks each kernel against its plain version on the 17 site maps its
   path gives it (the stream kernels: the evaluate forward at batch 128;
   the masking kernel: B's train forward at batch 64) and times both with
   CUDA events, beside the kernel's byte bound at the card's memory rate
   and, for the comparator and the masking kernel, beside ``torch.amax``
   of the same map over its blocks (a tuned library read of the same
   bytes, as a yardstick: it does not compute either kernel's function),
   and for the masking kernel, pack and the expander beside ``copy_`` of
   the map into a map of its shape (a read and a write of the same order
   of bytes, also only a yardstick);
6. trains and evaluates the paper's other two CNNs, VGG-16 (13 sites) and
   MobileNetV1 (27 sites), at full width on the same shapes, block 8
   shrinking with the maps, T_obj 1.0 and 0.5: R (``reference``) and B
   (``pallas``) 3 steps each at batch 64, B's step-1 loss and gradients
   and its variables after 3 steps equal to R's bit for bit (R's step 1
   twice, against itself) and the masking kernel sites x 3 times; then
   ``evaluate`` of B's variables on ``stream`` over 2 batches of 128, each
   stream kernel sites x 2 times, every site in the Eq. 2/3 band, the
   logits equal to a ``reference`` run's bit for bit; the three stream
   kernels held and timed on one evaluate batch's site maps, the masking
   kernel on the site maps of one B training step (batch 64);
7. serves gemma3-4b at full width and depth (34 layers, random weights
   from seed 0) through ``repro_torch.launch.serve.main`` on the ``fused``
   backend: batch 2, prompt 2048 (the banded local and the chunked global
   attention both run), 32 greedy tokens, T_obj 1.05. The launch counts at
   the phase boundaries must be: prefill 34 payload GEMMs, 34 comparator
   and 34 pack launches, 68 masking launches (the kv_cache sites); the
   handoff one ``zebra_pack`` per compressible cache leaf; decode no GEMM.
   The ffn_hidden zero fraction must lie in 0.5-0.8, every KV leaf must
   round-trip losslessly inside the Eq. 2/3 band, and every ffn_hidden
   map is replayed through the ``reference`` site and ``zebra_spmm``
   (bitmap, n_live, bytes bitwise; ``zebra_spmm_cs == zebra_spmm``
   bitwise; y allclose to the reference's). A ``reference``-backend run
   gives the greedy tokens beside the fused ones (agreement recorded, not
   asserted); the fused warm prefill is printed beside the one recorded with
   the GEMMs' earlier fmaf body. The LM kernels are held against their
   plain versions on edge cases (all dead, all live, one live block per
   column, NaN/Inf, 8x128 and 8x64 whole-width blocks, each in float32 and
   bfloat16, a 4x128 and an 8x24 block in bfloat16, and the skip rule for
   NaN/Inf in w in both) and timed on the path's maps beside their bound,
   their plain version and, for the GEMMs, ``torch.matmul`` of the
   keep-gated dense map; the comparator, the masking kernel and pack are
   held bit for bit against their plain versions and timed per prefill
   too, on the 34 ffn_hidden and the 68 kv_cache maps, and the expander
   per decode on the compressed KV leaves that decode expands (each leaf
   must come back losslessly);
8. serves starcoder2-15b (the GELU MLP with its biases, Q/K/V biases,
   layernorm) the same way at full width and depth (40 layers), T_obj
   1.55: prefill 40 payload GEMMs, 40 comparator and 40 pack launches, 80
   masking launches, the same replays and the same reference run (on the
   same weights: a second 31 GB model would not fit beside the first);
   the payload GEMM, the comparator and pack timed per prefill; then
   command-r-35b (layernorm + SwiGLU), qwen2.5-14b (Q/K/V biases) and
   chameleon-34b (the untied head) at full width cut to 2 layers, batch 1,
   prompt 512, 4 tokens on ``fused``: 2 GEMM launches per prefill, the
   same checks, tokens recorded beside a ``reference`` run;
9. drives the validated stream (``compress.integrity``, ``ft``): ResNet-18
   evaluate on ``stream`` with B's variables at ``structural`` and
   ``checksum`` (4 x 128 images: the comparator, pack and the expander 17 x
   4 times each, the masking kernel never; one batch's logits and every
   site's bytes equal the ``off`` run's bit for bit); the 18 rows of
   ``BENCH_faults.json`` this slice covers, rebuilt from the same numpy
   maps (``validate.*``: 426016 stream bytes at zero_frac 0.5938;
   ``detect.{stream,fused,serve}.*``: one fault injected, detected once,
   recovered, the engine's recovery taking the masking kernel once); then
   gemma3-4b as in 7 with ``--validate checksum`` and two faults armed (a
   bitmap bit of the first ``kv_cache`` stream, a live value of the first
   handoff leaf): prefill 34 GEMMs, 102 comparator and 102 pack launches,
   67 expander launches and 1 masking launch (the recovered site), the
   handoff one ``zebra_pack`` a leaf with one leaf recovered dense, decode
   expanding the other 19, detected == injected == 2, every ``kv_cache``
   map equal by value to the masking pass's, and 64 of 64 tokens equal to
   the ``off`` run's. Every clean run must detect nothing. It prints the
   host-clock ms of an evaluate forward and of a warm prefill at each
   level (in turns, twice each), and the device busy share of each;
10. trains gemma3-4b at full width (d 2560, d_ff 10240, 8/4 heads of 320,
    vocab 262144, tied head) cut to 12 layers (10 local + 2 global; the
    optimizer state of 34 does not fit one card) through
    ``repro_torch.launch.train``: float32 parameters, bf16 compute, batch
    2 x 2048 in two microbatches of 1 x 2048 (the banded local and the
    chunked global attention, the chunked CE in 2 chunks, forward and
    backward), AdamW warmup_cosine(3e-4, 1, 3), bf16 gradient compression,
    clip 1.0, weights from a ``torch.Generator`` seeded 0 on the card, T_obj
    1.05, 3 steps in each run:
    R  ``reference`` at the constant T_obj (the yardstick); step 1's loss
       and gradients computed twice must agree bit for bit, and the
       ``ffn_hidden`` zero fraction must lie in 0.5-0.8;
    B  ``pallas``: step 1's loss and every gradient, and every parameter
       after 3 steps, equal to R's bit for bit; the masking kernel 12 sites
       x 2 microbatches x 3 steps = 72 times;
    C  ``stream``: the comparator, pack and the expander 72 times each,
       step 1's loss and the parameters after 3 steps equal to R's, each
       step's ``measured_bytes`` the sum over its 24 sites, every site in
       the Eq. 2/3 band;
    A  the paper's Eq. 1 through ``launch.train.main`` (threshold nets,
       ``--backend pallas``, batch 2 in one microbatch): every site must
       resolve to ``reference(tnet)``, loss and ``zebra_reg`` finite.
    Each run prints its host-clock ms per step, the device busy share of a
    profiled step and ``torch.cuda.max_memory_allocated``; the masking
    kernel, the comparator, pack and the expander are held bit for bit
    against their plain versions on the 24 ``ffn_hidden`` maps of C's
    first step and timed per training step;
11. trains gemma3-4b at full width and depth (34 layers: the deepest that
    trains on one card, found by ``src/repro_torch/launch/lm_timing.py
    depth``) with ``remat="block"`` through ``launch.train.train_lm``: R
    and C 2 steps each at batch 2 x 2048 in two microbatches, C's
    parameters equal to R's bit for bit and each stream kernel launched
    34 sites x 2 microbatches x 2 steps x 2 (the forward and the
    backward's recompute); R again at K 1; step 1's gradients, summed in
    ``.grad`` as they arrive, equal to the two-copy form bit for bit; and
    at 12 layers remat ``block`` equal to ``none``. Each run prints its
    host-clock ms per step and ``max_memory_allocated``, and R's runs the
    device busy share. Then the same width cut to 2 layers trains 4
    steps on ``stream`` under ``--ckpt`` with a checkpoint every 2 steps
    and a crash (``ft.crashing_step``, after moving every parameter) at
    the 3rd call: the supervisor restores step 2 and the loader, and the
    parameters, both AdamW moments, the step and the loader step at step 4
    must equal an uninterrupted run's bit for bit. A corrupted newest shard
    must fall back to step 2 (``detect.ckpt.bitflip``), the two
    ``ffn_hidden`` maps of one microbatch must come back from
    ``save_acts``/``restore_acts`` bit for bit through the pack and the
    expander on the card, and a flipped index bit must raise
    ``CorruptStream`` naming the map (``detect.ckpt.acts_bitflip``). It
    prints the time a save blocks the loop, the write time and MB/s,
    restore plus verify, and the free disk space; the directory is removed.
    After it a full garbage collection must free no device memory (no
    reference cycle holds a tensor);
12. drives the MoE FFNs, whose Zebra site runs on the expert dispatch
    buffer ((E·cap, d_ff) capacity slots, empty slots zero rows):
    (a) granite-moe-1b-a400m (32 experts top-8, d_ff 512) at full width and
    depth through ``launch.serve.main`` on ``stream``, batch 2, prompt 2048,
    32 greedy tokens, T_obj 0.0064: prefill 72 launches of each stream
    kernel (24 ``ffn_hidden`` maps (40960, 512), 48 ``kv_cache`` maps), the
    handoff one ``zebra_pack`` a compressed leaf, decode 24 x 31 of each
    (the (32, 512) dispatch map of every layer every token) plus the
    expander per leaf; the filled slots' zero fraction in 0.5-0.8 (printed
    over every slot too); the stream bytes of the prefill's maps and
    decode step 1's equal to Eq. 2/3 of the comparator's plain bitmap, and
    every site's inside the Eq. 2/3 band; the last logits and 64 of 64
    greedy tokens equal to a ``reference`` run on the same weights bit for
    bit; warm times of both in turns; the same run at ``--validate checksum`` (every site
    validated, tokens unchanged, nothing detected); the three stream
    kernels held bit for bit against their plain versions on the 24
    prefill maps and one decode step's 24 maps, and timed;
    (b) llama4-scout-17b-a16e (16 experts top-1, d_ff 8192) at full width
    cut to 18 layers on ``fused`` (an MoE site hands the engine no weight:
    the masking pass), T_obj 0.00038: prefill 3 x 18 masking launches and
    no comparator, pack or GEMM, decode 18 a token, no stream bytes; logits
    and tokens equal to ``reference``'s bit for bit; the masking kernel held
    and timed on the 18 prefill maps (5120, 8192) and one decode step's; weight bytes
    and ``max_memory_allocated``;
    (c) granite trained at full width and depth with ``remat="block"``
    through ``launch.train.train_lm``: batch 2 x 2048 in 2 microbatches,
    float32 parameters, bf16 compute, AdamW, bf16 gradients, clip 1.0,
    T_obj 0.0064, 2 steps each of R (``reference``), B (``pallas``) and C
    (``stream``) through the harness of 10: B's and C's parameters equal
    R's bit for bit, the loss ce + 0.01 router_aux, the masking kernel (B)
    and each stream kernel (C) 24 x 2 x 2 x 2 times (forward and
    recompute), C's sites all ``stream``, each step's ``measured_bytes``
    the sum over its sites, every site in the Eq. 2/3 band; ms per step,
    the device busy share, ``max_memory_allocated``; kernels 1-4 held and timed on C's
    96 maps of step 1;
13. drives whisper-medium and the scanned local attention:
    (a) whisper-medium at full width and depth (24 encoder + 24 decoder
    layers) served on ``fused`` through ``serve.serve_one_shot``: batch 4,
    1500 frames ~ N(0, 1) from a generator seeded 1 on the card, prompt
    416, 32 tokens, T_obj 1.55: prefill 24 payload GEMMs, 24 comparator and
    24 pack launches, 48 masking launches; the encoder's 24 sites
    ``reference(degenerate-rows)`` (1500 is no multiple of 8) and no
    launch; decode only the expander of the handoff leaves; every decoder
    ``ffn_hidden`` map replayed through the ``reference`` site and
    ``zebra_spmm`` as in 7; tokens beside a ``reference`` run recorded; the
    encoder's share of the prefill's device time; the payload GEMM, the
    comparator and pack timed per prefill;
    (b) whisper trained R and C (batch 4 x 448 in 2 microbatches, fresh
    seeded frames each step, remat block, 2 steps): C's parameters equal
    R's bit for bit, each stream kernel 24 x 2 x 2 x 2 times, the decoder's
    sites ``stream`` and the encoder's ``reference(degenerate-rows)``, the
    bytes and the band as in (c);
    (c) gemma3-4b at full width cut to 12 layers trained 2 steps (phase
    10's traffic, ``reference``, no remat) with ``local_impl="scanned"``
    beside ``"banded"``: the losses and step 1's ``ffn_hidden`` bitmaps
    equal bit for bit, ``max_memory_allocated`` and ms per step of both;
14. drives the two recurrent architectures at full width:
    (a) mamba2-2.7b (16 of its 64 Mamba-2 SSD layers, phase 19's depth,
    d_inner 5120, 80 heads of 64, state 128) through ``launch.serve.main`` on
    ``stream``, batch 2, prompt 2048, 32 greedy tokens, T_obj 5.0: its one
    Zebra site is ``layer_out`` (16 maps (2, 2048, 2560) bf16 a prefill);
    prefill 16 launches of each stream kernel and no GEMM or masking
    launch, the handoff one ``zebra_pack`` a compressed cache leaf (the
    float32 SSD state ``H`` (16, 2, 80, 128, 64) as (2560, 8192), and the
    conv buffers), decode only the
    expander of those leaves (decode has no Zebra site); the first layer's
    zero fraction in 0.3-0.8; every site's bytes equal to Eq. 2/3 of the
    comparator's plain bitmap and inside the band; every leaf lossless, and
    ``H``'s bytes measured, predicted and dense; the last logits and 64 of 64
    greedy tokens equal to a ``reference`` run on the same weights bit for
    bit; warm times of both in turns and the device busy share; the three
    stream kernels held bit for bit and timed on the 16 prefill maps, and
    the codec's pack and the expander on the handoff's leaves;
    (b) recurrentgemma-2b at full depth (26 layers: 18 RG-LRU and 8 local attention
    layers, window 2048, d_ff 7680) served as gemma3-4b in 7 on ``fused``,
    T_obj 1.5: prefill 26 payload GEMMs, 26 comparator and 26 pack launches,
    16 masking launches (the 8 local layers' K and V); every ffn_hidden map
    replayed through the ``reference`` site and ``zebra_spmm``, every
    kv_cache map through the masking kernel; tokens beside a ``reference``
    run recorded; the payload GEMM, the comparator, the masking kernel and
    pack timed per prefill;
    (c) both trained R and C through the harness of 10 (batch 2 x 2048 in 2
    microbatches, remat block, 2 steps, float32 parameters, bf16 compute;
    cut for phase 20's time to 16 of mamba2's 64 layers and 12 of
    recurrentgemma's 26, four whole patterns):
    C's parameters equal R's bit for bit, each stream kernel sites x 2 x 2 x 2
    times (mamba2: 16 ``layer_out`` sites, recurrentgemma: 12 ``ffn_hidden``),
    each step's ``measured_bytes`` the sum over its forward sites, every
    recorded site in the band; ms per step, the busy share,
    ``max_memory_allocated``; the stream kernels timed on C's maps of step 1;
15. serves continuously (``serve.ServeEngine``: the slotted decode at
    per-lane positions, the scheduler, the paged compressed-KV pool, the
    supervised engine):
    (a) gemma3-4b at full width cut to 6 layers (one pattern) on ``fused``
    through ``python -m repro_torch.launch.serve --requests 8 --slots 4
    --prompt-len 320 --gen 16 --t-obj 1.05 --validate structural
    --preempt-after 16 --page-tokens 64 --layers 6`` (prompts 80-320 tokens, 4-16
    generated, all at tick 0; the hot set (4, 1024); its GEMMs' sums in
    float32, ``utils.float32_sums``: the run is phase 21's one-process
    yardstick):
    every request done, the report's per-page Eq. 2/3 reconcile, the
    dispatch shapes inside their ladders, evictions; the codec's pack
    launched once a compressed page out and the expander once a page in,
    each prefill's 6 ffn_hidden sites (comparator, pack, the payload GEMM)
    and 12 validated kv_cache sites (comparator, pack, expander: a
    validated site without a weight runs the checked stream, not the
    masking pass); one lane paged out and
    back in bit for bit, its pages' host time, kernels 5 and 3 held and
    timed on its pages;
    (b) the trace again without preemption: each request's tokens (and
    logits) bit for bit while both runs decoded it at the same ``Bb``
    sequence, the near-tie rule after (at the first differing token the
    yardstick's logit gap between the two candidates is no larger than the
    max |Δlogit| of the two rows); the first 3 requests one-shot
    (``serve_one_shot``) against the engine under the near-tie rule; every
    divergence printed; kernels 1, 2 and 7 (ffn_hidden) and 1, 2 and 3
    (kv_cache) held and timed on a largest-bucket prefill's maps;
    (c) the supervised engine at 6 layers (one pattern period) under the
    storm of ``benchmarks/serve_chaos_bench.py`` (a crash at tick 12, 6
    corrupt pages, the bench's breaker) against its clean run: 7 faults
    injected and each detected once, 1 crash recovery, the page breaker
    tripped and closed again, goodput 1.0, the tokens bit for bit;
16. runs the compressed collectives (``repro_torch.distributed``) over 8
    ranks spawned on this host, a (data 2, model 4) mesh as the reference's
    collectives bench; one card gives ``gloo`` with the wire tensors copied
    through host memory (NCCL refuses two ranks on one device), the pack
    and the rebuild on the card:
    (a) ``BENCH_collectives.json``'s 12 byte rows from the bench's seeds
    (7 on the model axis, 11 on the data axis; (256, 1024) float32
    shards): every rank's axis totals of ``ici_bytes`` and
    ``ici_dense_bytes`` equal to the record, each compressed result equal
    by value to the dense ``all_gather``, ``all_reduce`` and
    ``reduce_scatter_tensor``, kernel 5 launched once and kernel 3 ``n - 1``
    times an all-gather (once a psum or reduce-scatter), the payload bytes
    a rank takes from the ring equal to its link's moved bytes less the
    packed indices (only live prefixes travel);
    (b) the three ``detect.ring.*`` rows of ``BENCH_faults.json``: a
    dropped hop on the all-gather at ``structural`` and ``checksum`` and on
    the psum at ``checksum``, each injected 1, detected 1 and recovered by
    the dense retry on every rank, its bytes on the link;
    (c) gemma3-4b at full width: a (2, 2048, 2560) bf16 prefill activation
    sequence-sharded at 512 tokens a rank through the dense FFN under
    ``comm_context`` on ``stream``, ``layer_out`` masked at T_obj 0.475 and
    exchanged (zero fraction 0.5-0.8 on every exchanged map), and
    ``gather_kv_shards`` on (2, 512, 4, 320) K and V at T_obj 3.5: every
    gathered map equal bit for bit to a dense gather of the masked shards,
    ``moved`` equal to Eq. 2/3 and the meter's link records reconciled;
    (d) granite-moe-1b-a400m at full width and depth under
    ``sharding_profile="dp"`` on ``stream`` (T_obj 0.0064), 8 x 2048 prompt
    tokens one row a rank: each rank's logits and site bytes equal to a
    single-process forward of its row bit for bit, the summed bytes equal
    to the sum over the ranks;
    (e) host-clock times of each compressed collective beside its dense
    counterpart (on the host wire: they say nothing of NVLink), and
    kernels 5 and 3 on the ring's maps (CUDA events, L2 flushed), rows
    ``... (collectives ring, bench shard)`` and ``... (collectives ring,
    gemma3-4b layer_out)``;
17. serves tensor-parallel (``launch.serve --model-parallel 4``: the CLI
    spawns 4 ranks on this host, (data 1, model 4), ``gloo`` with host
    copies on one card; each rank builds the model from seed 0 and cuts
    its shards) on ``fused``, batch 2, prompt 2048, 32 greedy tokens:
    (a) gemma3-4b at full width cut to 6 layers (5 local, the global), T_obj
    1.05, held against a single-process run at 6 layers: the 4 ranks'
    logits and tokens bit for bit alike; the 6 ``ffn_hidden`` sites on
    block edges (d_ff 2560 a rank, kernels 1, 2 and 7 on each rank's shard)
    and the 12 ``kv_cache`` sites gathered (one KV head of 320 a rank cuts the 128-wide blocks: kernel 4
    on the whole (4096, 1280) map), every stream site and handoff leaf in
    the Eq. 2/3 band, the zero fraction per site kind within 1e-3 of one
    process's (the blocks that differ counted), the prefill logits within
    1.5 (PERF.md), the tokens equal but for near ties; each rank's
    launches per phase (prefill 6 / 6 / 6 GEMMs / 12 masking, the
    handoff one ``zebra_pack`` a leaf and one expander, decode one
    expander a leaf); times, each rank's ``max_memory_allocated`` and the
    tensor-parallel collectives per prefill and per token;
    (b) starcoder2-15b at full width cut to 8 layers, T_obj 1.55, held the
    same way against its own single-process run at 8 layers (every map on
    block edges: d_ff 6144 and one KV head of 128 a rank; its biases cross
    the row-parallel sums);
    (c) kernels 1, 2, 4 and 7 held against their plain versions on a
    rank's maps of (a) (rank 0's d_ff columns of phase 7's maps of the 12
    layers with its rows of w_down, the whole kv_cache maps) and timed;
    phase 11 also takes one int8-compressed train step at 34 layers under
    remat, and fewer layers until one fits, with the state's bytes by
    component;
18. trains sharded (``launch.train.train_rank`` in 4 ranks spawned on this
    host, (data 2, model 2), ``gloo`` with host copies on one card):
    gemma3-4b at full width and 6 layers (one whole local/global pattern),
    batch 4 x 1024 in 2 microbatches, ``stream`` at T_obj 1.05, the
    config's remat, float32 state and bf16 compute, 2 bf16 steps, and
    phase 18b's 3 int8 steps at 2 layers (a local and the global layer)
    from fresh seed-0 weights (its uninterrupted run,
    which took the place of one int8 step at 6 layers), each held against
    the same training in one process on the card (run first, then freed): the
    ranks' metrics alike, the losses within 1e-2, ``grad_norm`` within 2
    %, the zero fraction within 1e-3 (the blocks that differ counted),
    every ``stream`` site in the Eq. 2/3 band, every parameter after step
    2 within 2.5 x lr (the share beyond lr/10 printed), the leaf shards
    ranks share bit for bit alike, kernels 1-3 launched on every rank as
    often as in one process; step times, each rank's peak memory and state
    bytes by component, the collectives a step; then kernels 1-3 held
    against their plain versions on rank 0's ``ffn_hidden`` shards
    (1024, 5120) of one step and timed;
18b. checkpoints the sharded state in phase 18's world after its runs
    (``launch.train.train_rank --ckpt``, ``checkpoint.sharded``): gemma3-4b
    at full width cut to 2 layers (the pattern's last local layer and its
    global one), phase 18's batch, site and remat, int8,
    3 steps uninterrupted, then 3 steps under ``--ckpt-every 2`` with
    ``ft.crashing_step`` raising on every rank at call 3 after moving every
    tensor of the state: the supervisor restores step 2 (rank 0 wrote whole leaves)
    and every rank's shards of the parameters, both AdamW moments and the
    int8 residual, the step, the loader's step and the losses equal the
    uninterrupted run's bit for bit, kernels 1-3 launched in both runs;
    then the step-3 file restored into a model built at (data 1, model 4)
    (each whole leaf's CRC32 the manifest's on every rank), the restored
    shards gathered back whole to rank 0 with the manifest's CRC32s; prints
    the free disk, the save time that blocks the loop (the gather), the
    write-and-CRC time and rate, the bytes a checkpoint, each rank's
    restore times and host peak;
19. serves the other layer kinds tensor-parallel (``launch.serve
    --model-parallel`` inside one world of 4 ranks spawned on this host,
    ``gloo`` with host copies on one card, which serves the five in turn),
    batch x prompt 256, 8 greedy tokens, each at full width against its own
    single-process run at the same depth: granite-moe-1b-a400m (24
    layers) on ``stream`` at (data 2, model 2), its MoE expert-parallel
    with the dispatch routed over the global batch; llama4-scout-17b-a16e
    (4 of 48 layers) on ``fused``, mamba2-2.7b (16 of 64) on ``stream``,
    recurrentgemma-2b (6 of 26: its 10 query heads replicate beside the
    split RG-LRU) and whisper-medium (6 + 6 of 24 + 24) on ``fused``, each
    at (data 1, model 4). Checks: the model ranks' logits and tokens bit
    for bit alike; each site kind by its rule and axis; every site that
    reports stream bytes and every handoff leaf in the Eq. 2/3 band; the
    zero fraction per site kind within 1e-3 of one process's (the blocks
    that differ counted); the prefill logits within 1.5; the tokens equal
    but for near ties; every rank's launches by phase equal to one
    process's; then kernels 1-3 on rank 0's granite dispatch rows, 4 on
    its llama4 rows, and 1, 2 and 7 on its recurrentgemma and whisper
    ``ffn_hidden`` shards (with its rows of ``w_down``) held against their
    plain versions and timed;
20. trains the other layer kinds sharded inside phase 19's world, after
    each architecture is served (``launch.train.train_rank``, the split
    phase 19 serves it at): one whole layer pattern each at full width, 2
    bf16 steps (step 1 at lr 0), constant T_obj, remat block, each against
    the same training in one process run first in the parent:
    granite-moe-1b-a400m (1 layer, ``stream``, (data 2, model 2), batch 2
    x 1024; its dispatch routed over the global batch, the expert-split
    map by rows), llama4-scout-17b-a16e (1 layer, ``pallas``: ``fused`` does
    not train; one layer's experts are ~2.0 B parameters, ~50 GB of
    float32 state in one process, which fits beside nothing else),
    mamba2-2.7b (1 layer, ``stream``, ``layer_out``, 1 x 1024),
    recurrentgemma-2b (3 layers, ``pallas``) and whisper-medium (1 + 1
    layers, ``pallas``, 1504 seeded frames
    ~ N(0, 1), a multiple of block_seq, so its encoder's site launches, 1 x
    448). Checks, phase 18's: the ranks' metrics alike, the losses within
    1e-2, ``grad_norm`` within 2 %, the zero fraction within 1e-3, the
    first moment after step 1 per leaf within 0.3 (relative L2 over the
    ranks' shards), the shared leaf shards bit for bit, every rank's
    launches equal to one process's; then kernels 1-3 (granite, mamba2)
    and 4 (llama4, recurrentgemma, whisper) held against their plain versions on
    rank 0's step-1 maps and timed, rows ``... (<arch> tensor-parallel
    training, a rank)``;
21. serves continuously under tensor parallelism (``launch.serve
    --requests --model-parallel 4`` inside phase 19's world of 4 ranks,
    after phase 20, (data 1, model 4), ``gloo`` with host copies on one card;
    each rank runs ``ServeEngine`` on its shards, holds its K/V heads of
    the hot set and pages them to its own pool):
    (a) gemma3-4b with phase 15 (a)'s arguments (6 layers, ``fused``,
    T_obj 1.05, ``--validate structural``, 8 requests, prompts 80-320,
    4-16 generated, 4 slots, pages of 64, a lane evicted after 16 steps; a
    rank's one KV head of 320 cuts the 128-wide blocks: its pages gathered
    and packed whole), held against phase 15 (a)'s run;
    (b) granite-moe-1b-a400m at full width cut to 2 layers on ``stream``,
    T_obj 0.0064, the same trace shape and pages of 256 (its cache floor
    is the page, and a prefill bucket must fit inside it), its two KV
    heads of 64 a rank packed as they are and its experts split over the
    ranks, held against its own run in this process. Checks, each run:
    every rank's requests, tokens, counters (ticks, evictions, pages,
    shed, deadline misses, pages recovered), meter records and launches
    alike; the tokens against one process's under the near-tie rule; the
    counters equal to one process's; every page in the Eq. 2/3 band; the
    zero fraction within 1e-3 of one process's; every kernel launched on
    each rank as often as in one process (kernel 5 once a compressed page
    out); tokens/s, p50/p95 ms a token, host µs a page out and in, the
    tensor-parallel collectives a tick and each rank's peak memory
    printed. Then kernels 1, 2 and 7 on rank 0's ffn_hidden maps of one
    largest-bucket prefill of (a) (its d_ff columns with its rows of
    ``w_down``) and kernels 5 and 3 on the pages a rank packs in (a)
    (every rank's heads of lane 0, whole) held against their plain
    versions and timed, rows ``... (gemma3-4b tensor-parallel continuous
    prefill <bucket>, a rank)`` and ``... (gemma3-4b tensor-parallel
    continuous, per page, a rank)``;
22. prints one JSON line listing the kernels (the seven CUDA kernels, the
    three stream kernels per VGG-16 and per MobileNetV1 evaluate batch,
    named ``... (vgg16 evaluate)`` and ``... (mobilenet evaluate)``, the
    masking kernel per training step of each, ``... (vgg16 training)`` and
    ``... (mobilenet training)``, then
    the LM rows, named ``... (gemma3-4b prefill)``, ``... (gemma3-4b
    decode)`` and ``... (starcoder2-15b prefill)``, the four stream
    kernels per LM training step, ``... (gemma3-4b training)``, and the
    rows of phases 12-13, ``... (<arch> prefill)``, ``... (<arch> decode
    step)`` and ``... (granite-moe-1b-a400m training)``, the codec's pack
    and the expander on phase 11's ``save_acts`` maps, ``... (gemma3-4b
    save_acts)`` and ``... (gemma3-4b restore_acts)``, and phase 14's,
    ``... (mamba2-2.7b prefill)``, ``... (mamba2-2.7b handoff)``, ``...
    (recurrentgemma-2b prefill)`` and ``... (<arch> training)``, and phase
    15's, ``... (gemma3-4b continuous prefill <bucket>[, kv_cache])`` and ``zebra_pack
    (gemma3-4b continuous, per lane)``/``zebra_unpack_kernel (...)``, phase 16's
    ``... (collectives ring, ...)``, phase 17's ``... (gemma3-4b
    tensor-parallel prefill, a rank)``, phase 18's ``... (gemma3-4b
    tensor-parallel training, a rank)``, phase 19's ``... (<arch>
    tensor-parallel prefill, a rank)``, phase 20's ``... (<arch>
    tensor-parallel training, a rank)`` and phase 21's; the GEMM
    rows also carry ms per launch, TFLOP/s of live work and the device
    body that ran, the stream rows their ``amax_ms`` or ``copy_ms``
    yardstick), the card line again, and ``{"ok": true, "device": ...}``
    as the last line.

Any failed phase exits non-zero, and so does a host without CUDA or a
directory without the port beside this script. Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, NVIDIA data sheet
BATCHES, BATCH, T_OBJ, BLOCK = 4, 128, 1.5, 8
TRAIN_STEPS, TRAIN_BATCH, T_OBJ_TNET = 5, 64, 0.2
KERNELS = {
    # CUDA kernel: the Pallas kernel it replaces (_bitmap_kernel,
    # _gather_pack_kernel, _unpack_kernel, _zebra_mask_kernel)
    "zebra_bitmap_kernel": "src/repro/kernels/mask_pack.py:69",
    "zebra_pack_kernel": "src/repro/kernels/mask_pack.py:78",
    "zebra_unpack_kernel": "src/repro/kernels/pack.py:46",
    "zebra_mask_kernel": "src/repro/kernels/zebra_mask.py:24",
}
# the LM phase's kernels: pack.zebra_pack (the codec's entry, which runs
# zebra_pack_kernel under an external bitmap; _pack_kernel), and the GEMMs
# (_dense_gemm_kernel, _spmm_cs_kernel)
LM_KERNELS = {
    "zebra_pack": "src/repro/kernels/pack.py:41",
    "zebra_spmm_kernel": "src/repro/kernels/zebra_spmm.py:104",
    "zebra_spmm_cs_kernel": "src/repro/kernels/spmm_cs.py:51",
}
STREAM_KERNELS = ("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_unpack_kernel")
# kernels timed beside torch.amax of their map (the reducing ones), and
# beside copy_ of their map into a map of its shape (the writing ones); both
# are yardsticks of the same order of bytes, not library versions
AMAX_YARDSTICK = ("zebra_bitmap_kernel", "zebra_mask_kernel")
COPY_YARDSTICK = ("zebra_mask_kernel", "zebra_pack_kernel", "zebra_unpack_kernel")
# the LM rows of the stream kernels in the kernels line: (kernel, the served
# inputs it runs on: the prefill's ffn_hidden or kv_cache maps, or the
# compressed KV leaves that decode expands)
LM_STREAM_ROWS = {"zebra_bitmap_kernel (gemma3-4b prefill)": ("zebra_bitmap_kernel", "ffn"),
                  "zebra_mask_kernel (gemma3-4b prefill)": ("zebra_mask_kernel", "kv"),
                  "zebra_pack_kernel (gemma3-4b prefill)": ("zebra_pack_kernel", "ffn"),
                  "zebra_unpack_kernel (gemma3-4b decode)": ("zebra_unpack_kernel", "leaves")}
SOURCE = "src/repro_torch/kernels/csrc/zebra_stream.cu"
GEMM_SOURCE = "src/repro_torch/kernels/csrc/zebra_gemm.cu"
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
ENQUEUE_SLACK_CYCLES = 200_000  # device spin before each timed call, ~0.1 ms


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel against plain version
# ---------------------------------------------------------------------------

def same_bits(a, b) -> bool:
    """Bit for bit, also for a tuple of tensors."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(u, v) for u, v in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch
    if isinstance(a, tuple):
        return max(max_abs_err(u, v) for u, v in zip(a, b))
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0, posinf=0.0).max()) if d.numel() else 0.0


def stream_pieces(x, t_obj, bs, bc):
    """The plain upstream of each kernel: bitmap, slot map, n_live, payload."""
    import torch
    from repro_torch.kernels import mask_pack
    from repro_torch.kernels.schedule import slot_map
    bitmap = mask_pack.bitmap_plain(x, t_obj, bs, bc)
    keep, slot = slot_map(bitmap)
    n_live = keep.sum(dtype=torch.int32)
    payload = mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)
    return bitmap, keep, slot, n_live, payload


def kernel_calls(x, t_obj, bs, bc, names=tuple(KERNELS)):
    """{kernel: (kernel call, plain call)} on one map for the named
    kernels, each fed the plain version's upstream, so each kernel is
    checked on its own; and the map's live block count."""
    from repro_torch.kernels import mask_pack, pack, zebra_mask
    bitmap, keep, slot, n_live, payload = stream_pieces(x, t_obj, bs, bc)
    nm, nk = bitmap.shape
    calls = {
        "zebra_bitmap_kernel": (lambda: mask_pack.bitmap_cuda(x, t_obj, bs, bc),
                                lambda: mask_pack.bitmap_plain(x, t_obj, bs, bc)),
        "zebra_pack_kernel": (lambda: mask_pack.pack_cuda(x, bitmap, slot, n_live, bs, bc),
                              lambda: mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)),
        "zebra_unpack_kernel": (lambda: pack.unpack_cuda(payload, bitmap, slot, bs, bc),
                                lambda: pack.expand_payload(payload, keep, slot, nm, nk,
                                                            bs, bc)),
        "zebra_mask_kernel": (lambda: zebra_mask.mask_cuda(x, t_obj, bs, bc),
                              lambda: zebra_mask.mask_plain(x, t_obj, bs, bc)),
    }
    return {k: calls[k] for k in names}, int(n_live)


def compare_kernels(x, t_obj, bs, bc, label: str, names=tuple(KERNELS)) -> dict[str, float]:
    """Each kernel bit for bit against its plain version; returns the max
    abs error per kernel (0.0 when the bits agree)."""
    import torch
    calls, _ = kernel_calls(x, t_obj, bs, bc, names)
    errs = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(same_bits(got, want), f"{name} differs from its plain version on {label} "
                                    f"(max abs err {max_abs_err(got, want)})")
        errs[name] = max_abs_err(got, want)
    return errs


def synthetic_map(M, K, bs, bc, dtype, signed, seed, device):
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    x = (x.reshape(M // bs, bs, K // bc, bc)
         * torch.rand(M // bs, 1, K // bc, 1, generator=g) * 3.0).reshape(M, K)
    if not signed:
        x = x.clamp_min(0.0)
    return x.to(dtype).to(device)


def edge_cases(device) -> None:
    import torch
    cases = {
        # label: (M, K, bs, bc, dtype, signed, t_obj); the comparator and the
        # masking kernel load 16-byte vectors where bc*item, K*item and the
        # data pointer allow, else 8, 4 or 2 bytes
        "bf16 8x8": (65536, 64, 8, 8, torch.bfloat16, False, T_OBJ),
        "float16 8x8": (65536, 64, 8, 8, torch.float16, False, T_OBJ),
        "float16 8x128": (4096, 2048, 8, 128, torch.float16, True, 0.5),
        "bf16 8x24 blocks (3 vectors a block row)": (4096, 480, 8, 24, torch.bfloat16,
                                                     True, 0.5),
        "bf16 8x256 blocks (32 vectors)": (4096, 2048, 8, 256, torch.bfloat16, True, 0.5),
        "f32 8x256 blocks (64 vectors)": (2048, 2048, 8, 256, torch.float32, True, 0.5),
        "rows of 24 bytes (2x2, K 6)": (65536, 6, 2, 2, torch.float32, False, 1.0),
        "bs 16": (4096, 1024, 16, 128, torch.bfloat16, True, 0.5),
        "kv_cache shape": (4096, 1280, 8, 128, torch.bfloat16, True, 1.05),
        "8x128 token blocks f32": (4096, 2048, 8, 128, torch.float32, True, 0.5),
        "8x128 token blocks bf16": (4096, 2048, 8, 128, torch.bfloat16, True, 0.5),
        "2x2 blocks (b=2)": (65536, 8, 2, 2, torch.float32, False, 1.0),
        "4x4 blocks": (65536, 16, 4, 4, torch.float32, False, 1.0),
        "all-dead": (65536, 64, 8, 8, torch.float32, False, 1e9),
    }
    for i, (label, (M, K, bs, bc, dtype, signed, t)) in enumerate(cases.items()):
        compare_kernels(synthetic_map(M, K, bs, bc, dtype, signed, i, device), t, bs, bc,
                        label)
        print(f"  kernels == plain (bitwise): {label} ({M}x{K}, block {bs}x{bc}, {dtype})")
    # a contiguous map whose data starts 8 bytes off a 16-byte boundary
    x = synthetic_map(65536, 64, 8, 8, torch.bfloat16, True, 98, device)
    x = torch.cat([x.new_zeros(4), x.reshape(-1)])[4:].view(x.shape)
    check(x.data_ptr() % 16 == 8, "the offset map starts on 16 bytes")
    compare_kernels(x, T_OBJ, 8, 8, "offset map")
    print("  kernels == plain (bitwise): bf16 map starting 8 B off 16 B (65536x64, block 8x8)")
    x = synthetic_map(65536, 64, 8, 8, torch.float32, False, 99, device)
    x[1, 2] = float("nan")          # a block holding NaN is dead
    x[9, 17] = float("inf")         # a block holding Inf is live
    x[17, 40] = float("-inf")
    bitmap = stream_pieces(x, T_OBJ, 8, 8)[0]
    check(int(bitmap[0, 0]) == 0 and int(bitmap[1, 2]) == 1 and int(bitmap[2, 5]) == 1,
          "NaN/Inf blocks not resolved as the reference resolves them")
    compare_kernels(x, T_OBJ, 8, 8, "NaN/Inf")
    print("  kernels == plain (bitwise): NaN/Inf (65536x64, block 8x8)")
    # the masking kernel multiplies: dead negative values give -0.0, a dead
    # NaN block stays NaN
    from repro_torch.kernels.zebra_mask import mask_cuda
    y = mask_cuda(synthetic_map(4096, 2048, 8, 128, torch.float32, True, 5, device),
                  0.5, 8, 128)[0]
    check(bool((y.view(torch.int32) == -2 ** 31).any()), "no -0.0 in dead signed blocks")
    check(bool(torch.isnan(mask_cuda(x, T_OBJ, 8, 8)[0][1, 2])), "dead NaN block lost its NaN")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, flush, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around each call, with
    the 50 MB L2 cache flushed before each (the site's map was written by
    the layer before it, and most maps exceed L2). The device then spins
    for ~0.1 ms, so the host has enqueued the call before the start event
    runs: a slow host (a Python wrapper takes ~30 µs) cannot put idle time
    between the events."""
    import torch
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(ENQUEUE_SLACK_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------

def launch_counts() -> dict[str, int]:
    from repro_torch.kernels import launch_counters
    return {k: w.launches for k, w in launch_counters().items()}


def check_launches(launches, want: dict[str, int], label: str) -> None:
    """Each kernel launched exactly as often as ``want`` says (0 if absent)."""
    print(f"  launches ({label}): {launches}")
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{label}: {name} launched {n} times, "
                                      f"want {want.get(name, 0)}")


def check_band(records, label: str) -> float:
    """Every site's stream bytes inside the Eq. 2/3 index-padding band;
    ``records`` holds (map shape, block, element size, SiteAux)."""
    from repro_torch.core import MapSpec, stored_bits
    worst = 0.0
    for i, (shape, b, item, aux) in enumerate(records):
        B, C, H, W = shape
        spec = MapSpec(c=B * C, h=H, w=W, bits=8 * item, block=b)
        predicted = stored_bits(spec, float(aux.zero_frac)) / 8.0
        delta = int(aux.measured_bytes) - predicted
        worst = max(worst, abs(delta))
        check(0.0 <= delta < 1.0, f"{label} site {i}: measured {int(aux.measured_bytes)} "
                                   f"B vs Eq. 2/3 {predicted} B: outside the band")
    return worst


class SiteRecorder:
    """Wraps the engine entry the model's sites call and records each
    site's map shape, block, element size and SiteAux (and, when
    ``keep_maps``, a copy of its input map). Adds no kernel launch."""

    def __init__(self, keep_maps: bool = False):
        self.keep_maps = keep_maps
        self.records, self.maps = [], []

    def __enter__(self):
        import repro_torch.models.cnn.common as common
        self._common, self._inner = common, common.zebra_site

        def site(x, cfg, **kw):
            if self.keep_maps:
                self.maps.append((x.detach().contiguous().clone(), cfg.block_hw))
            y, aux = self._inner(x, cfg, **kw)
            self.records.append((tuple(x.shape), cfg.block_hw, x.element_size(), aux))
            return y, aux
        common.zebra_site = site
        return self

    def __exit__(self, *exc):
        self._common.zebra_site = self._inner


def run_slice(device, variables=None, batches=BATCHES, batch=BATCH, width_mult=1.0):
    """Drive ResNet-18 inference through CNNTrainer.evaluate on `stream`
    (``variables``: the trained ones, else fresh random weights); return
    the stream kernels' launches and the site maps of one forward."""
    import torch
    from repro_torch.core import ZebraConfig
    from repro_torch.data import SYN_TINYIMAGENET, image_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.train import CNNTrainConfig, CNNTrainer

    zcfg = ZebraConfig(mode="infer", backend="stream", block_hw=BLOCK, t_obj=T_OBJ,
                       use_tnet=False)
    cfg = CNNTrainConfig(model="resnet18", width_mult=width_mult,
                         dataset=SYN_TINYIMAGENET, zebra=zcfg, seed=0)
    trainer = CNNTrainer(cfg, device=device)
    variables = variables or trainer.init_state()["variables"]
    n_sites = len(trainer.model.map_specs(cfg.dataset.hw, zcfg))

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.evaluate(variables, batches=batches, batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    print(f"slice: {batches} x {batch} images in {wall:.3f} s "
          f"({batches * batch / wall:.1f} images/s end to end, host data included)")
    check_launches(launches, {k: n_sites * batches for k in STREAM_KERNELS}, "evaluate")
    dense = sum(s.elems * 4 for s in trainer.model.map_specs(cfg.dataset.hw, zcfg))
    print(f"  acc {out['acc']} top5 {out['top5']} zero_frac {out['zero_frac']} "
          f"reduced_bandwidth_pct {out['reduced_bandwidth_pct']}")
    print(f"  stream bytes per image {out['measured_bytes'] / batch} vs dense float32 "
          f"{dense} (per batch: {out['measured_bytes_per_batch']})")
    check(0.0 < out["zero_frac"] < 1.0, f"zero_frac {out['zero_frac']} out of (0, 1)")

    # one more batch, recording every site's input map
    images, _ = image_batch(cfg.dataset, batch, 10_000)
    images = torch.from_numpy(images).to(device)
    with SiteRecorder(keep_maps=True) as rec:
        logits, _ = trainer.forward(variables, images)
    maps = rec.maps
    check(len(maps) == n_sites, f"{len(maps)} site maps recorded, want {n_sites}")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (batch, 200),
          f"logits not finite of shape ({batch}, 200)")
    worst = check_band(rec.records, "evaluate")
    print(f"  every site inside the Eq. 2/3 band (worst |delta| {worst} B)")

    ref_logits, _ = trainer.forward(variables, images, zcfg.replace(backend="reference"))
    check(same_bits(logits, ref_logits), "stream logits differ from reference logits")
    print("  logits: stream == reference (bitwise)")

    fwd = {}
    for backend in ("stream", "reference"):
        z = zcfg.replace(backend=backend)
        trainer.forward(variables, images, z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.forward(variables, images, z)
        torch.cuda.synchronize()
        fwd[backend] = (time.perf_counter() - t0) / 5 * 1e3
    print(f"  forward of one batch of {batch}: stream {fwd['stream']:.3f} ms, "
          f"reference {fwd['reference']:.3f} ms (host clock, synchronised)")
    for backend in ("stream", "reference"):
        profile_forward(trainer, variables, images, zcfg.replace(backend=backend))
    return launches, maps


def profile_forward(trainer, variables, images, zcfg, n: int = 3) -> None:
    profile_calls(lambda: trainer.forward(variables, images, zcfg), n,
                  f"{zcfg.backend} forwards", "forward")


def profile_calls(fn, n: int, what: str, unit: str) -> float | None:
    """Device kernel time by kernel over n calls of fn (torch.profiler),
    and the device's busy share of the profiled window's wall time.
    Returns the busy ms per call (None when the profiler saw no device).
    Only the device is traced: the host's op events of a training step
    (~10^5 kernels) took the profiler tens of seconds to gather."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print(f"  profile ({what}): no device time recorded (not measured)")
        return None
    print(f"  profile of {n} {what}: device busy {busy_ms / n:.3f} ms per {unit}, "
          f"{100 * busy_ms / wall_ms:.1f} % of the profiled wall time "
          f"({wall_ms / n:.3f} ms per {unit} under the profiler)")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the top eight, and the port's own kernels wherever they rank
    for e in ranked[:8] + [e for e in ranked[8:] if "zebra_" in e.key]:
        print(f"    {e.self_device_time_total / n / 1e3:8.3f} ms  {e.count // n:4d} calls  "
              f"{e.key[:100]}")
    return busy_ms / n


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def run_training(device, steps=TRAIN_STEPS, batch=TRAIN_BATCH, width_mult=1.0):
    """The four training runs R, B, C, A (module docstring). Returns B's
    trained variables, the launch counts read after B's run, and the site
    maps of one B train forward."""
    import torch
    from repro_torch.core import ZebraConfig
    from repro_torch.data import SYN_TINYIMAGENET, StreamingLoader, image_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import CNNTrainConfig, CNNTrainer

    # the batches go to the card first, so the step times hold no data generation
    batches = [tuple(torch.from_numpy(a).to(device)
                     for a in image_batch(SYN_TINYIMAGENET, batch, i)) for i in range(steps)]

    def trainer(**zkw):
        cfg = CNNTrainConfig(model="resnet18", width_mult=width_mult,
                             dataset=SYN_TINYIMAGENET, batch=batch, steps=steps,
                             zebra=ZebraConfig(block_hw=BLOCK, **zkw), grad_clip=10.0,
                             seed=0)
        return CNNTrainer(cfg, sgd(step_decay(0.05, total_steps=steps)), device=device)

    def loader():
        return StreamingLoader(lambda b, step: batches[step], batch)

    def train(tr, label, want):
        """``CNNTrainer.train`` for ``steps`` steps, the launch counts set
        to 0 just before and read just after. Returns ``(state, history,
        launch counts)``."""
        stamps = []
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = tr.train(steps, log_every=1, loader=loader(),
                               callback=lambda m: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches(counts, want, label)
        ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
        rest = sum(ms[1:]) / len(ms[1:])
        print(f"  {label}: step 1 {ms[0]:.3f} ms, steps 2-{steps} {rest:.3f} ms per step "
              f"({batch / rest * 1e3:.1f} images/s; host clock, synchronised)")
        print(f"    loss {[m['loss'] for m in hist]}")
        print(f"    zebra_reg {[m['zebra_reg'] for m in hist]}")
        print(f"    zero_frac {[m['zero_frac'] for m in hist]} "
              f"measured_bytes {[m['measured_bytes'] for m in hist]}")
        check(all(math.isfinite(m["loss"]) for m in hist), f"{label}: loss not finite")
        busy = profile_calls(lambda: tr._step(state, *batches[0]), 2, f"{label} steps",
                             "step")
        if busy is not None:
            print(f"  {label}: device busy {100 * busy / rest:.1f} % of an unprofiled step "
                  f"({busy:.3f} of {rest:.3f} ms)")
        return state, hist, counts

    kw = dict(t_obj=T_OBJ, use_tnet=False)
    R = trainer(backend="reference", **kw)
    B = trainer(backend="pallas", **kw)
    C = trainer(backend="stream", **kw)
    n_sites = len(R.model.map_specs(SYN_TINYIMAGENET.hw, R.cfg.zebra))
    per_run = n_sites * steps
    print(f"training: ResNet-18 width {width_mult}, batch {batch}, {steps} steps per run")

    # B's first step against R's, bit for bit, before either trains
    _, loss_r, grads_r, _, _ = R.loss_and_grads(R.init_state(), *batches[0])
    _, loss_b, grads_b, _, _ = B.loss_and_grads(B.init_state(), *batches[0])
    check(same_bits(loss_b, loss_r), f"step-1 loss: pallas {float(loss_b)} vs reference "
                                     f"{float(loss_r)}")
    for k in grads_r:
        check(same_bits(grads_b[k], grads_r[k]),
              f"step-1 gradient {k}: pallas differs from reference "
              f"(max abs err {max_abs_err(grads_b[k], grads_r[k])})")
    print(f"  step 1: pallas loss and all {len(grads_r)} gradients == reference (bitwise)")
    del grads_r, grads_b

    state_r, *_ = train(R, "R reference T_obj 1.5", {})
    state_b, _, counts_b = train(B, "B pallas T_obj 1.5", {"zebra_mask_kernel": per_run})
    with SiteRecorder() as rec:
        state_c, *_ = train(C, "C stream T_obj 1.5", {k: per_run for k in STREAM_KERNELS})
    check(len(rec.records) >= per_run, f"{len(rec.records)} site records in C")
    worst = check_band(rec.records, "C stream train")
    print(f"  C: every site of every step inside the Eq. 2/3 band (worst |delta| {worst} B)")
    for label, st in (("B pallas", state_b), ("C stream", state_c)):
        for k, v in state_r["variables"].items():
            check(same_bits(st["variables"][k], v),
                  f"{label} after {steps} steps: {k} differs from the reference run")
        print(f"  {label}: all {len(state_r['variables'])} variables after {steps} steps "
              f"== reference run (bitwise)")
    del state_r, state_c, R, C

    A = trainer(backend="pallas", t_obj=T_OBJ_TNET, use_tnet=True)
    with SiteRecorder() as rec:
        _, hist_a, _ = train(A, "A tnet Eq. 1 T_obj 0.2", {})
    labels = {aux.backend for *_, aux in rec.records}
    check(labels == {"reference(tnet)"}, f"A: site backends {labels}")
    check(hist_a[-1]["zebra_reg"] < hist_a[0]["zebra_reg"],
          f"A: zebra_reg did not fall ({hist_a[0]['zebra_reg']} -> {hist_a[-1]['zebra_reg']})")
    print(f"  A: every site ran reference(tnet); zebra_reg {hist_a[0]['zebra_reg']} -> "
          f"{hist_a[-1]['zebra_reg']}")
    del A

    with SiteRecorder(keep_maps=True) as rec:
        B.loss_and_grads(state_b, *batches[0])
    check(len(rec.maps) == n_sites, f"{len(rec.maps)} B site maps, want {n_sites}")
    return state_b["variables"], counts_b, rec.maps


def time_kernels(groups, device, t_obj=T_OBJ, suffix: str = "", extra=None) -> list[dict]:
    """``groups``: (kernel names, site maps, launches on the main path).
    Each kernel is held against its plain version on its maps and timed;
    each row is named ``kernel + suffix`` and carries ``extra[kernel]``."""
    import torch
    from repro_torch.kernels.stream_timing import bound_bytes
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                **({"copy_ms": 0.0} if k in COPY_YARDSTICK else {})} for k in KERNELS}
    launches, by_shape = {}, {}
    for names, maps, group_launches in groups:
        launches.update({k: group_launches[k] for k in names})
        for x4, b in maps:
            B, C, H, W = x4.shape
            x = x4.reshape(B * C * H, W)
            errs = compare_kernels(x, t_obj, b, b, f"site map {tuple(x4.shape)}", names)
            calls, n_live = kernel_calls(x, t_obj, b, b, names)
            blocks = x.view(x.shape[0] // b, b, x.shape[1] // b, b)
            amax = time_ms(lambda: torch.amax(blocks, dim=(1, 3)), flush)
            y = torch.empty_like(x)
            copy = time_ms(lambda: y.copy_(x), flush)
            for name, (kern, plain) in calls.items():
                ms, pms = time_ms(kern, flush), time_ms(plain, flush)
                bound = bound_bytes(name, *x.shape, b, b, x.element_size(), n_live) \
                    / HBM_BYTES_PER_S * 1e3
                r = rows[name]
                r["ms"] += ms
                r["plain_ms"] += pms
                r["bound_ms"] += bound
                r["max_abs_err"] = max(r["max_abs_err"], errs[name])
                if "copy_ms" in r:
                    r["copy_ms"] += copy
                by_shape.setdefault((name, tuple(x.shape)), []).append(
                    (ms, pms, bound, amax, copy))
    print(f"kernel times per site shape{suffix} (mean over sites; CUDA events, L2 flushed; "
          "amax: torch.amax of the map over its blocks, a yardstick read of the same bytes; "
          "copy: copy_ of the map, a yardstick read and write of them):")
    for (name, shape), vals in sorted(by_shape.items()):
        n = len(vals)
        ms, pms, bound, amax, copy = (sum(v[i] for v in vals) / n for i in range(5))
        yard = f"  amax {amax:.4f} ms" if name in AMAX_YARDSTICK else ""
        yard += f"  copy {copy:.4f} ms" if name in COPY_YARDSTICK else ""
        print(f"  {name:22s} M,K={shape}: {ms:.4f} ms  plain {pms:.4f} ms  "
              f"bound {bound:.4f} ms{yard}  ({n} sites)")
    return [{"name": name + suffix, "route": "cuda", "source": SOURCE,
             "replaces": KERNELS[name], "launches": launches[name], **rows[name],
             "bound_by": "bytes", "library_ms": None, **(extra or {}).get(name, {})}
            for name in KERNELS if name in launches]

# ---------------------------------------------------------------------------
# The paper's other two CNNs: VGG-16 and MobileNetV1
# ---------------------------------------------------------------------------

# T_obj per model: the evaluate zero fraction mid-band on these random
# weights after 3 steps (VGG-16 0.677 at 1.0, MobileNetV1 0.664 at 0.5;
# PERF.md)
ZOO = {"vgg16": 1.0, "mobilenet": 0.5}
ZOO_STEPS, ZOO_EVAL_BATCHES = 3, 2


def run_zoo(device, name: str, steps=ZOO_STEPS, batch=TRAIN_BATCH, batches=ZOO_EVAL_BATCHES,
            eval_batch=BATCH, width_mult=1.0) -> list[dict]:
    """One CNN of the zoo at full width on Tiny-ImageNet shapes: train R
    (``reference``) and B (``pallas``) for ``steps`` steps, B equal to R
    bit for bit with the masking kernel sites x steps times; then evaluate
    B's variables on ``stream`` (each stream kernel sites x batches times,
    every site in the Eq. 2/3 band, logits == ``reference`` bitwise).
    Returns the kernel rows: the three stream kernels on one evaluate
    batch's site maps, the masking kernel on the site maps of one B
    training step (batch ``batch``), each held against its plain version
    on those maps."""
    import torch
    from repro_torch.core import ZebraConfig
    from repro_torch.data import SYN_TINYIMAGENET, StreamingLoader, image_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import CNNTrainConfig, CNNTrainer

    t_obj = ZOO[name]
    data = [tuple(torch.from_numpy(a).to(device)
                  for a in image_batch(SYN_TINYIMAGENET, batch, i)) for i in range(steps)]

    def trainer(backend):
        cfg = CNNTrainConfig(model=name, width_mult=width_mult, dataset=SYN_TINYIMAGENET,
                             batch=batch, steps=steps, grad_clip=10.0, seed=0,
                             zebra=ZebraConfig(block_hw=BLOCK, t_obj=t_obj, use_tnet=False,
                                               backend=backend))
        return CNNTrainer(cfg, sgd(step_decay(0.05, total_steps=steps)), device=device)

    R, B = trainer("reference"), trainer("pallas")
    n_sites = len(R.model.map_specs(SYN_TINYIMAGENET.hw, R.cfg.zebra))
    print(f"{name}: width {width_mult}, {n_sites} sites, T_obj {t_obj}, train batch {batch} "
          f"x {steps} steps, evaluate {batches} x {eval_batch}")
    # step 1: B's loss and gradients against R's, and R against itself (a
    # nondeterministic reduction would show there first)
    grads = {}
    for label, tr in (("R", R), ("R again", R), ("B", B)):
        _, loss, g, _, _ = tr.loss_and_grads(tr.init_state(), *data[0])
        grads[label] = (loss, g)
    for label in ("R again", "B"):
        loss, g = grads[label]
        bad = [k for k in g if not same_bits(g[k], grads["R"][1][k])]
        check(same_bits(loss, grads["R"][0]) and not bad,
              f"{name} step 1: {label} differs from R (loss {float(loss)} vs "
              f"{float(grads['R'][0])}; gradients {bad[:4]})")
    print(f"  step 1: R twice and B: loss and all {len(grads['R'][1])} gradients equal "
          f"(bitwise)")
    del grads
    states, ms = {}, {}
    for label, tr in (("R", R), ("B", B)):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[label], hist = tr.train(steps, log_every=steps,
                                       loader=StreamingLoader(lambda b, i: data[i], batch))
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) / steps * 1e3
        counts = launch_counts()
        check_launches(counts, {"zebra_mask_kernel": n_sites * steps} if label == "B" else {},
                       f"{name} train {label}")
        check(math.isfinite(hist[-1]["loss"]), f"{name} {label}: loss not finite")
        if label == "B":
            train_launches = {"zebra_mask_kernel": counts["zebra_mask_kernel"]}
        print(f"  {label}: {ms[label]:.3f} ms per step (host clock, synchronised, step 1 "
              f"included); step {steps} loss {hist[-1]['loss']} zero_frac "
              f"{hist[-1]['zero_frac']}")
    for k, v in states["R"]["variables"].items():
        check(same_bits(states["B"]["variables"][k], v),
              f"{name}: B after {steps} steps: {k} differs from R")
    print(f"  B: all {len(states['R']['variables'])} variables after {steps} steps == R "
          f"(bitwise)")
    variables = states["B"]["variables"]
    with SiteRecorder(keep_maps=True) as train_rec:
        B.loss_and_grads(states["B"], *data[0])
    check(len(train_rec.maps) == n_sites,
          f"{name}: {len(train_rec.maps)} B site maps, want {n_sites}")
    del states, R, B

    zcfg = ZebraConfig(mode="infer", backend="stream", block_hw=BLOCK, t_obj=t_obj,
                       use_tnet=False)
    ev = CNNTrainer(CNNTrainConfig(model=name, width_mult=width_mult,
                                   dataset=SYN_TINYIMAGENET, zebra=zcfg, seed=0),
                    device=device)
    reset_launch_counts()
    torch.cuda.synchronize()
    out = ev.evaluate(variables, batches=batches, batch=eval_batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches(launches, {k: n_sites * batches for k in STREAM_KERNELS},
                   f"{name} evaluate")
    specs = ev.model.map_specs(SYN_TINYIMAGENET.hw, zcfg)
    dense = sum(s.elems * 4 for s in specs)
    print(f"  evaluate: zero_frac {out['zero_frac']} reduced_bandwidth_pct "
          f"{out['reduced_bandwidth_pct']}; stream bytes per image "
          f"{out['measured_bytes'] / eval_batch} vs dense float32 {dense} "
          f"(per batch: {out['measured_bytes_per_batch']})")
    check(0.0 < out["zero_frac"] < 1.0, f"{name}: zero_frac {out['zero_frac']}")
    images = torch.from_numpy(image_batch(SYN_TINYIMAGENET, eval_batch, 10_000)[0]).to(device)
    with SiteRecorder(keep_maps=True) as rec:
        logits, _ = ev.forward(variables, images)
    check(len(rec.maps) == n_sites, f"{name}: {len(rec.maps)} site maps, want {n_sites}")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (eval_batch, 200),
          f"{name}: logits not finite of shape ({eval_batch}, 200)")
    worst = check_band(rec.records, f"{name} evaluate")
    ref_logits, _ = ev.forward(variables, images, zcfg.replace(backend="reference"))
    check(same_bits(logits, ref_logits), f"{name}: stream logits differ from reference")
    print(f"  every site inside the Eq. 2/3 band (worst |delta| {worst} B); logits: stream "
          f"== reference (bitwise)")
    fwd = {}
    for backend in ("stream", "reference"):
        z = zcfg.replace(backend=backend)
        ev.forward(variables, images, z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ev.forward(variables, images, z)
        torch.cuda.synchronize()
        fwd[backend] = (time.perf_counter() - t0) / 3 * 1e3
    print(f"  forward of one batch of {eval_batch}: stream {fwd['stream']:.3f} ms, reference "
          f"{fwd['reference']:.3f} ms (host clock, synchronised)")
    for backend in ("stream", "reference"):
        busy = profile_calls(lambda: ev.forward(variables, images, zcfg.replace(
            backend=backend)), 2, f"{name} {backend} forwards", "forward")
        if busy is not None:
            print(f"  {name} {backend}: device busy {100 * busy / fwd[backend]:.1f} % of an "
                  f"unprofiled forward ({busy:.3f} of {fwd[backend]:.3f} ms)")
    return (time_kernels([(STREAM_KERNELS, rec.maps, launches)], device, t_obj=t_obj,
                         suffix=f" ({name} evaluate)")
            + time_kernels([(("zebra_mask_kernel",), train_rec.maps, train_launches)],
                           device, t_obj=t_obj, suffix=f" ({name} training)"))


# ---------------------------------------------------------------------------
# The LM serving slice: gemma3-4b on the fused backend
# ---------------------------------------------------------------------------

LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "gemma3-4b", 2, 2048, 32
# ffn_hidden zero fraction mid-band (0.5-0.8) on these random weights: w_gate
# and w_up are drawn with fan_in d_ff (as the reference draws them), so gate
# and up are N(0, d/d_ff = 1/4) and the 8 x 128 block maxima of |silu(gate) *
# up| sit near 1 (T_obj 1.15 gave 0.778, PERF.md); at 3.0 every block is dead
LM_T_OBJ = 1.05
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)    # kernel vs plain float32 matmul: summation order
# the GEMMs' device body per operand dtype (csrc/zebra_gemm.cu)
GEMM_BODY = {"torch.bfloat16": "mma_block_rows: mma.sync m16n8k16 bf16 -> fp32, tensor cores",
             "torch.float32": "fma_block_rows: fmaf fp32, CUDA cores"}
# the fused warm prefill of this cell with the GEMMs' earlier fmaf body,
# as PERF.md records it (same card type, 700 W)
FMAF_WARM_PREFILL_MS = (404.5, 418.0)
Y_TOL = dict(rtol=2 ** -7, atol=1e-2)    # bf16 outputs: up to two bf16 ulps apart
BS, BC = 8, 128                          # the LM's token blocks
# starcoder2-15b at full width and depth on fused. Its GELU MLP's
# pre-activation is N(0, d/f = 1/4) per element on random weights
# (layernorm'd rows, w_up of fan-in f), so an 8 x 128 block dies when the
# largest of its 1024 values stays under gelu^-1(T_obj): zero fraction
# ~Phi(gelu^-1(T)/0.5)^1024, 0.45 at 1.5, 0.58 at 1.55, 0.67 at 1.6 on
# independent rows (a CPU draw agrees); the served maps sit higher, 0.734
# at 1.55 (PERF.md), as gemma3-4b's do above their own estimate
SC2 = dict(arch="starcoder2-15b", batch=2, prompt=2048, gen=32, t_obj=1.55)
SC2_STREAM_ROWS = {
    "zebra_bitmap_kernel (starcoder2-15b prefill)": ("zebra_bitmap_kernel", "ffn"),
    "zebra_pack_kernel (starcoder2-15b prefill)": ("zebra_pack_kernel", "ffn")}
# the three other dense architectures at full width, cut to 2 layers
# (chameleon-34b's 68 GB and command-r-35b's 70 GB of bf16 weights do not
# fit one card beside their activations), each with the field it brings;
# T_obj 1.8 puts their SwiGLU ffn_hidden zero fraction near 0.65 on
# independent rows (d/f ~0.37 against gemma3-4b's 0.25)
ARCH_RUNS = {"command-r-35b": "layernorm + SwiGLU", "qwen2.5-14b": "qkv_bias",
             "chameleon-34b": "untied head (lm_head)"}
ARCH_RUN = dict(batch=1, prompt=512, gen=4, t_obj=1.8, layers=2)


def gemm_pieces(x2, bitmap, bs, bc):
    """The plain upstream of the GEMMs: keep flags, slot map, payload."""
    import torch
    from repro_torch.kernels import mask_pack
    from repro_torch.kernels.schedule import slot_map
    keep, slot = slot_map(bitmap)
    n_live = keep.sum(dtype=torch.int32)
    return keep, slot, mask_pack.pack_plain(x2, bitmap, slot, n_live, bs, bc), int(n_live)


def close_err(got, want, tol, label: str) -> float:
    import torch
    ok = torch.allclose(got, want, equal_nan=True, **tol)
    check(ok, f"{label}: differs from its plain version beyond {tol} "
              f"(max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def compare_gemms(x2, w, bitmap, bs, bc, label: str) -> dict[str, float]:
    """Kernels 6 and 7 against their plain versions (GEMM_TOL) and against
    each other (bitwise)."""
    import torch
    from repro_torch.kernels import spmm_cs, zebra_spmm
    keep, slot, payload, _ = gemm_pieces(x2, bitmap, bs, bc)
    y7 = spmm_cs.spmm_cs_cuda(payload, w, bitmap, slot, bs, bc)
    y6 = zebra_spmm.spmm_cuda(x2, w, bitmap, bs, bc)
    torch.cuda.synchronize()
    check(same_bits(y6, y7), f"{label}: zebra_spmm != zebra_spmm_cs (bitwise)")
    return {"zebra_spmm_cs_kernel": close_err(
                y7, spmm_cs.spmm_cs_plain(payload, w, bitmap, keep, slot, bs, bc), GEMM_TOL,
                f"zebra_spmm_cs on {label}"),
            "zebra_spmm_kernel": close_err(
                y6, zebra_spmm.spmm_plain(x2, w, bitmap, bs, bc), GEMM_TOL,
                f"zebra_spmm on {label}")}


def compare_zebra_pack(x2, bs, bc, label: str) -> float:
    """The codec's pack (external nonzero-block bitmap), kernel vs plain,
    bitwise."""
    import torch
    from repro_torch.compress import nonzero_bitmap
    from repro_torch.kernels import mask_pack
    bitmap = nonzero_bitmap(x2, bs, bc)
    keep, slot, want, n_live = gemm_pieces(x2, bitmap, bs, bc)
    got = mask_pack.pack_launch(x2, bitmap, slot, keep.sum(dtype=torch.int32), bs, bc,
                                "zebra_pack")
    torch.cuda.synchronize()
    check(same_bits(got, want), f"zebra_pack differs from its plain version on {label}")
    return 0.0


def lm_edge_cases(device) -> dict[str, float]:
    """The LM kernels against their plain versions on edge cases; returns
    the worst error per kernel."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {
        # label: (M, K, N, bs, bc, dtype, t_obj, kind); float32 runs the GEMMs'
        # CUDA-core body, bfloat16 their tensor-core body (N % 8 != 0 takes its
        # element-wise w staging, bs < 8 zero rows, bc % 16 == 8 a half step)
        "8x128 bf16": (1024, 2048, 640, 8, 128, bf16, 0.5, "mixed"),
        "8x128 f32": (512, 1024, 384, 8, 128, f32, 0.5, "mixed"),
        "8x64 whole width": (256, 64, 130, 8, 64, f32, 0.5, "mixed"),
        "all dead": (256, 1024, 256, 8, 128, f32, 1e9, "mixed"),
        "all live": (256, 1024, 256, 8, 128, f32, 0.0, "mixed"),
        "one live block per column": (256, 1024, 256, 8, 128, f32, 0.5, "one"),
        "NaN/Inf in the map": (256, 1024, 256, 8, 128, f32, 0.5, "nan-inf"),
        "8x64 whole width bf16": (256, 64, 130, 8, 64, bf16, 0.5, "mixed"),
        "all dead bf16": (256, 1024, 256, 8, 128, bf16, 1e9, "mixed"),
        "all live bf16": (256, 1024, 256, 8, 128, bf16, 0.0, "mixed"),
        "one live block per column bf16": (256, 1024, 256, 8, 128, bf16, 0.5, "one"),
        "NaN/Inf in the map bf16": (256, 1024, 256, 8, 128, bf16, 0.5, "nan-inf"),
        "4x128 bf16 (bs < 8)": (512, 1024, 256, 4, 128, bf16, 0.5, "mixed"),
        "8x24 bf16 (bc % 16 == 8)": (256, 480, 200, 8, 24, bf16, 0.5, "mixed"),
    }
    from repro_torch.kernels import mask_pack, zebra_mask
    errs = {k: 0.0 for k in LM_KERNELS}
    for i, (label, (M, K, N, bs, bc, dtype, t, kind)) in enumerate(cases.items()):
        x = synthetic_map(M, K, bs, bc, torch.float32, True, 100 + i, device)
        if kind == "one":
            keep = torch.zeros(M // bs, K // bc, device=device)
            keep[torch.randint(0, M // bs, (K // bc,), device=device),
                 torch.arange(K // bc, device=device)] = 1.0
            x = x * (0.01 + 10 * keep).repeat_interleave(bs, 0).repeat_interleave(bc, 1)
        if kind == "nan-inf":
            x[1, 2] = float("nan")
            x[9, 200] = float("inf")
        x = x.to(dtype)
        g = torch.Generator(device=device).manual_seed(i)
        w = (torch.randn(K, N, generator=g, device=device) / K ** 0.5).to(dtype)
        bitmap = mask_pack.bitmap_plain(x, t, bs, bc)
        for k, e in compare_gemms(x, w, bitmap, bs, bc, label).items():
            errs[k] = max(errs[k], e)
        compare_zebra_pack(zebra_mask.mask_plain(x, t, bs, bc)[0], bs, bc, label)
        print(f"  GEMMs == plain ({GEMM_TOL}), 6 == 7 bitwise, zebra_pack == plain "
              f"(bitwise): {label} ({M}x{K}x{N}, block {bs}x{bc}, {dtype})")
    # the skip rule, in both bodies: Inf/NaN in the w rows of a dead block
    # never reach its rows
    from repro_torch.kernels import spmm_cs, zebra_spmm
    for dtype in (f32, bf16):
        x = synthetic_map(512, 1024, 8, 128, torch.float32, True, 7, device).to(dtype)
        bitmap = mask_pack.bitmap_plain(x, 0.5, 8, 128)
        w = (torch.randn(1024, 256, device=device) / 32.0).to(dtype)
        col = int((bitmap == 0).any(0).nonzero()[0])
        w_bad = w.clone()
        w_bad[col * 128 + 3] = float("inf")
        w_bad[col * 128 + 5, 7] = float("nan")
        keep, slot, payload, _ = gemm_pieces(x, bitmap, 8, 128)
        y7 = spmm_cs.spmm_cs_cuda(payload, w_bad, bitmap, slot, 8, 128)
        y6 = zebra_spmm.spmm_cuda(x, w_bad, bitmap, 8, 128)
        clean = spmm_cs.spmm_cs_cuda(payload, w, bitmap, slot, 8, 128)
        dead = (bitmap[:, col] == 0).repeat_interleave(8)
        check(same_bits(y6, y7), f"skip rule ({dtype}): zebra_spmm != zebra_spmm_cs")
        check(bool(torch.isfinite(y7[dead]).all()) and same_bits(y7[dead], clean[dead]),
              f"skip rule ({dtype}): Inf/NaN in a dead block's w rows reached its rows")
        check(not bool(torch.isfinite(y7[~dead]).all()),
              f"skip rule ({dtype}): live rows lost the Inf")
        print(f"  skip rule ({dtype}): Inf/NaN in the w rows of a dead block stay out of "
              f"its rows in both GEMM kernels (the plain version, which multiplies, gives "
              f"NaN there)")
    return errs


class LMSiteRecorder:
    """Records the serving path's Zebra sites without launching anything:
    every ``ffn_hidden`` site that consumes ``w_down`` (a copy of its input
    map, the weight, its output and SiteAux), and every ``kv_cache``
    site (copies of its input map and its output, and SiteAux)."""

    def __init__(self):
        self.ffn, self.ffn_decode, self.kv = [], [], []

    def __enter__(self):
        import repro_torch.core.engine as engine
        import repro_torch.models.lm.ffn as ffn
        self._mods = (engine, ffn)
        self._inner = engine.zebra_site

        def ffn_site(x, cfg, **kw):
            y, aux = self._inner(x, cfg, **kw)
            if kw.get("site") == "ffn_hidden" and kw.get("w") is not None:
                if aux.backend == "fused":
                    self.ffn.append((x.clone(), kw["w"], y, aux))
                else:                       # one-token decode maps (and an encoder's)
                    self.ffn_decode.append((x.shape[-2], aux.backend))
            return y, aux

        def engine_site(x, cfg, **kw):
            y, aux = self._inner(x, cfg, **kw)
            if kw.get("site") == "kv_cache":     # y may become a cache decode updates
                self.kv.append((x.clone(), y.clone(), aux))
            return y, aux
        ffn.zebra_site, engine.zebra_site = ffn_site, engine_site
        return self

    def __exit__(self, *exc):
        engine, ffn = self._mods
        engine.zebra_site = ffn.zebra_site = self._inner


class PhaseCounts:
    """Launch counts read at the serving path's phase boundaries: before
    the compressed handoff (prefill done) and before the decode loop
    (handoff done); and the logits each decode step chose its token from
    (``logits``). Wraps the calls and launches nothing."""

    def __init__(self, serve):
        self.serve, self.at, self.logits = serve, {}, []

    def __enter__(self):
        from repro_torch.launch import steps
        s = self.serve
        self._steps = steps
        self._handoff, self._generate = s.transport_state_compressed, s.generate
        self._next = steps._next_token

        def handoff(*a, **k):
            self.at["prefill"] = launch_counts()
            return self._handoff(*a, **k)

        def generate(*a, **k):
            self.at["handoff"] = launch_counts()
            return self._generate(*a, **k)

        def next_token(logits, *a, **k):
            self.logits.append(logits)
            return self._next(logits, *a, **k)
        s.transport_state_compressed, s.generate = handoff, generate
        steps._next_token = next_token
        return self

    def __exit__(self, *exc):
        self.serve.transport_state_compressed = self._handoff
        self.serve.generate = self._generate
        self._steps._next_token = self._next


def diff_counts(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def block_weighted(auxes) -> tuple[float, int]:
    """Block-weighted zero fraction and the summed stream bytes of sites."""
    nb = sum(int(a.n_blocks) for a in auxes)
    zf = sum(float(a.zero_frac) * int(a.n_blocks) for a in auxes) / max(nb, 1)
    return zf, sum(int(a.measured_bytes) for a in auxes)


def replay_ffn_sites(sites, cfg, t_obj, ffn_bc) -> float:
    """Replay every fused ``ffn_hidden`` site (input map, w, output, SiteAux)
    through the ``reference`` site and ``zebra_spmm``: bitmap, n_live, bytes
    and zero_frac bitwise, ``zebra_spmm_cs == zebra_spmm`` bitwise, the fused
    output the replayed kernel's; returns the worst abs error of y against
    the reference's mask(h) @ w (inside Y_TOL)."""
    from repro_torch.core.engine import stream_bytes, zebra_site
    from repro_torch.core.zebra import zero_fraction
    from repro_torch.kernels import mask_pack, spmm_cs, zebra_spmm
    from repro_torch.models.lm.ffn import zebra_cfg_for
    zc = zebra_cfg_for(cfg, "infer")
    worst_y = 0.0
    for i, (h, w, y, aux) in enumerate(sites):
        h2 = h.reshape(-1, h.shape[-1])
        payload, bitmap, n_live = mask_pack.zebra_mask_pack(h2, t_obj=t_obj, bs=BS,
                                                            bc=ffn_bc)
        y_ref, aux_ref = zebra_site(h, zc.replace(backend="reference"), site="ffn_hidden",
                                    w=w)
        keep_ref = mask_pack.bitmap_plain(h2, t_obj, BS, ffn_bc)
        check(same_bits(bitmap, keep_ref), f"layer {i}: bitmap != the reference's")
        check(int(n_live) == int(keep_ref.sum()), f"layer {i}: n_live != the reference's")
        want_bytes = stream_bytes(keep_ref.sum(), BS, ffn_bc, h.dtype, keep_ref.numel())
        check(int(aux.measured_bytes) == int(want_bytes), f"layer {i}: stream bytes")
        check(same_bits(aux.zero_frac, aux_ref.zero_frac)
              and same_bits(aux.zero_frac, zero_fraction(bitmap)), f"layer {i}: zero_frac")
        y7 = spmm_cs.zebra_spmm_cs(payload, w, bitmap, bs=BS, bc=ffn_bc)
        y6 = zebra_spmm.zebra_spmm(h2, w, bitmap, bs=BS, bc=ffn_bc)
        check(same_bits(y6, y7), f"layer {i}: zebra_spmm != zebra_spmm_cs")
        check(same_bits(y7.to(h.dtype).reshape(y.shape), y), f"layer {i}: fused output "
                                                             f"!= the replayed kernel's")
        worst_y = max(worst_y, close_err(y.float(), y_ref.float(), Y_TOL,
                                         f"layer {i}: fused y vs the reference's mask(h) @ w"))
    return worst_y


def run_lm(device, arch=LM_ARCH, batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN,
           t_obj=LM_T_OBJ, layers=0, zf_band=(0.5, 0.8), profile=True) -> dict:
    """Serve ``arch`` (gemma3-4b by default) through
    ``repro_torch.launch.serve.main`` on fused (``layers`` > 0 cuts the
    depth), check launches per phase, the observables, the handoff and a
    replay of every ffn_hidden and kv_cache site (the ffn_hidden zero
    fraction inside ``zf_band`` unless None); then serve the same model on
    reference for the tokens, and again on fused, warm, for its times."""
    import torch
    from repro_torch.compress import CompressedMap, decompress
    from repro_torch.core.zebra import zero_fraction
    from repro_torch.kernels import reset_launch_counts, zebra_mask
    from repro_torch.launch import serve, steps
    from repro_torch.models.lm.ffn import eff_block_ch
    from repro_torch.utils import map_tree

    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
            "--gen", str(gen), "--t-obj", str(t_obj), "--layers", str(layers)]
    cfg = serve.build_config(arch, t_obj=t_obj, backend="fused", n_layers=layers)
    print(f"LM serving: python -m repro_torch.launch.serve {' '.join(argv)} --backend fused")
    reset_launch_counts()
    with LMSiteRecorder() as rec, PhaseCounts(serve) as phases:
        out = serve.main([*argv, "--backend", "fused"])
    torch.cuda.synchronize()
    final = launch_counts()
    n_layers = len(rec.ffn)
    leaves = [r for r in out["meter"].records if r.compressed]
    # the kv_cache sites: K and V of every attention layer
    n_kv = 2 * sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] in ("global", "local")
                   for i in range(cfg.n_layers))
    check(n_layers == cfg.n_layers, f"{n_layers} ffn_hidden sites ran fused, want "
                                    f"{cfg.n_layers}")
    check_launches(phases.at["prefill"], {"zebra_spmm_cs_kernel": n_layers,
                                          "zebra_bitmap_kernel": n_layers,
                                          "zebra_pack_kernel": n_layers,
                                          "zebra_mask_kernel": n_kv}, f"{arch} prefill")
    # the handoff's lossless spot check expands its first compressed leaf
    check_launches(diff_counts(phases.at["handoff"], phases.at["prefill"]),
                   {"zebra_pack": len(leaves), "zebra_unpack_kernel": 1}, "LM handoff")
    check_launches(diff_counts(final, phases.at["handoff"]),
                   {"zebra_unpack_kernel": len(leaves)}, "LM decode (no GEMM)")
    print(f"  prefill {out['prefill_ms']:.3f} ms, decode {out['decode_ms_per_token']:.3f} "
          f"ms/token (host clock, synchronised)")
    ffn_bc = eff_block_ch(cfg.d_ff, cfg)
    ffn_zf, ffn_bytes = block_weighted([a for *_, a in rec.ffn])
    kv_zf, kv_bytes = block_weighted([a for *_, a in rec.kv])
    dense_ffn = sum(h.numel() * h.element_size() for h, *_ in rec.ffn)
    print(f"  ffn_hidden: {n_layers} sites, zero fraction {ffn_zf}, stream bytes {ffn_bytes} "
          f"of {dense_ffn} dense (T_obj {t_obj})")
    print(f"  kv_cache: {len(rec.kv)} sites (the masking pass), zero fraction {kv_zf}, "
          f"stream bytes {kv_bytes} (T_obj {t_obj})")
    maxima = [h.reshape(-1, BS, h.shape[-1] // ffn_bc, ffn_bc).float().abs().amax(dim=(1, 3))
              for h, *_ in rec.ffn]
    print("  ffn_hidden zero fraction by T_obj on these maps: " + ", ".join(
        f"{t}: {float(sum((m < t).sum() for m in maxima) / sum(m.numel() for m in maxima)):.4f}"
        for t in (0.5 * t_obj, 0.9 * t_obj, t_obj, 1.1 * t_obj, 1.5 * t_obj)))
    del maxima
    check(zf_band is None or zf_band[0] <= ffn_zf <= zf_band[1],
          f"ffn_hidden zero fraction {ffn_zf} outside {zf_band}")
    check(len(rec.kv) == n_kv, f"{len(rec.kv)} kv_cache sites, want {n_kv}")
    check(len(rec.ffn_decode) == n_layers * (gen - 1)
          and {b for _, b in rec.ffn_decode} == {"reference(degenerate-rows)"},
          f"decode ffn_hidden sites: {len(rec.ffn_decode)} x {set(rec.ffn_decode)}")
    print(f"  decode: {len(rec.ffn_decode)} ffn_hidden sites, all reference(degenerate-rows) "
          f"(the masked dense matmul)")

    # the handoff: every compressible leaf lossless and inside the band
    rec_kv = out["reconcile"]
    check(rec_kv["n_sites"] == len(leaves) > 0, "reconcile did not cover every leaf")
    dense = []
    map_tree(lambda _, l: dense.append(l), out["dense_state"][0])
    comp = []
    map_tree(lambda _, l: comp.append(l), out["handoff_state"][0])
    checked = 0
    for d, c in zip(dense, comp):
        if isinstance(c, CompressedMap):
            check(same_bits(decompress(c), d), "a KV leaf did not round-trip losslessly")
            checked += 1
    check(checked == len(leaves), f"{checked} compressed leaves checked, want {len(leaves)}")
    print(f"  KV handoff: {len(leaves)} compressed leaves, every leaf lossless, "
          f"max |measured - predicted| {rec_kv['max_abs_delta_bytes']} B; "
          f"{out['meter'].measured_bytes()} of {out['meter'].dense_bytes()} B")

    # replay every kv_cache input through the masking kernel and its plain
    # version; the path's output must be the plain version's, bit for bit
    reset_launch_counts()
    for i, (x, y, aux) in enumerate(rec.kv):
        x2 = x.reshape(-1, x.shape[-1])
        bs = BS if x.shape[-2] % BS == 0 else 1
        bc = BC if x2.shape[1] % BC == 0 else x2.shape[1]
        y_plain, bm_plain = zebra_mask.mask_plain(x2, t_obj, bs, bc)
        y_k, bm_k = zebra_mask.mask_cuda(x2, t_obj, bs, bc)
        check(same_bits(y.reshape(x2.shape), y_plain), f"kv site {i}: the path's masked "
                                                       f"map != mask_plain")
        check(same_bits(y_k, y_plain) and same_bits(bm_k, bm_plain),
              f"kv site {i}: zebra_mask != mask_plain (map or bitmap)")
        check(same_bits(aux.zero_frac, zero_fraction(bm_plain))
              and int(aux.measured_bytes) == 0, f"kv site {i}: zero_frac or bytes")
    print(f"  replay of {len(rec.kv)} kv_cache maps {tuple(rec.kv[0][0].shape)}: the path's "
          f"masked map, the kernel's map and bitmap == mask_plain (bitwise); zero fraction "
          f"{kv_zf} at T_obj {t_obj}{' (every block kept)' if kv_zf == 0 else ''}")

    worst_y = replay_ffn_sites(rec.ffn, cfg, t_obj, ffn_bc)
    torch.cuda.synchronize()
    replay = launch_counts()
    print(f"  replay of {n_layers} ffn_hidden maps: bitmap, n_live, bytes and zero_frac == "
          f"reference (bitwise); zebra_spmm_cs == zebra_spmm (bitwise); y vs reference "
          f"max abs err {worst_y} ({Y_TOL})")

    # the yardstick tokens from the same weights on reference (a second
    # model of starcoder2-15b's 31 GB would not fit beside the first)
    model, prompts = out["model"], out["prompts"]
    reset_launch_counts()
    ref = serve.serve_one_shot(model, prompts, gen, backend="reference", log=lambda *_: None)
    check(not any(launch_counts().values()), "the reference run launched a kernel")
    fused_t, ref_t = out["tokens"].cpu(), ref["tokens"].cpu()
    agree = int((fused_t == ref_t).sum())
    first = [int((fused_t[b] != ref_t[b]).nonzero()[0]) if (fused_t[b] != ref_t[b]).any()
             else fused_t.shape[1] for b in range(fused_t.shape[0])]
    for b in range(fused_t.shape[0]):
        print(f"  tokens lane {b}: fused     {fused_t[b].tolist()}")
        print(f"  tokens lane {b}: reference {ref_t[b].tolist()}")
    print(f"  greedy tokens: {agree} of {fused_t.numel()} agree; first divergence per lane "
          f"{first} (recorded, not asserted)")
    print(f"  reference prefill {ref['prefill_ms']:.3f} ms, decode "
          f"{ref['decode_ms_per_token']:.3f} ms/token")
    del ref
    # the first run paid the first calls' set-up (cuBLAS handles, allocator
    # growth); serve the same prompts again on the warm model for its times
    again = serve.serve_one_shot(model, prompts, gen, log=lambda *_: None)
    check(torch.equal(again["tokens"], out["tokens"]), "the second fused run's tokens differ")
    warm = (again["prefill_ms"], again["decode_ms_per_token"])
    print(f"  fused again (warm): prefill {again['prefill_ms']:.3f} ms, decode "
          f"{again['decode_ms_per_token']:.3f} ms/token (host clock, synchronised)")
    if arch == LM_ARCH and not layers:
        lo, hi = FMAF_WARM_PREFILL_MS
        print(f"  fused warm prefill {again['prefill_ms']:.3f} ms beside {lo}-{hi} ms "
              f"recorded with the GEMMs' fmaf body (PERF.md)")
    busy = (profile_calls(lambda: steps.prefill(model, prompts), 2, "fused prefills",
                          "prefill") if profile else None)
    if busy is not None:
        print(f"  fused prefill: device busy {100 * busy / again['prefill_ms']:.1f} % of an "
              f"unprofiled prefill ({busy:.3f} of {again['prefill_ms']:.3f} ms)")
    state = again["dense_state"]
    tok = again["tokens"][:, :1]
    busy = (profile_calls(lambda: steps.generate(model, tok, state, prompt, 4), 1,
                          "4-token decodes", "4 tokens") if profile else None)
    if busy is not None:
        print(f"  decode: device busy {100 * busy / 4 / again['decode_ms_per_token']:.1f} % "
              f"of an unprofiled token ({busy / 4:.3f} of "
              f"{again['decode_ms_per_token']:.3f} ms)")
    del again, state, model, prompts
    out.pop("model"), out.pop("prompts")
    check(bool(torch.isfinite(out["logits"]).all())
          and tuple(out["logits"].shape) == (batch, cfg.vocab),
          f"prefill logits not finite of shape ({batch}, {cfg.vocab})")
    # launches from the served run alone; the dense twin is off the path (0
    # there) and its replay launches are reported beside, under their own name
    return {"arch": arch, "t_obj": t_obj, "agree": agree, "warm_ms": warm,
            "logits": out["logits"].float().cpu(),
            "step_logits": torch.stack([out["logits"].float().cpu()]
                                       + [x.float().cpu() for x in phases.logits]),
            "records": [(r.site, r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live)
                        for r in out["meter"].records],
            "ffn_zf": [float(a.zero_frac) for *_, a in rec.ffn],
            "kv_zf": [float(a.zero_frac) for *_, a in rec.kv],
            "maps": [(h, w) for h, w, *_ in rec.ffn], "kv": [x for x, *_ in rec.kv],
            "dense": dense, "comp": comp, "tokens": out["tokens"].cpu(),
            "launches": {k: final[k] for k in (*LM_KERNELS, *KERNELS)},
            "replay_launches": {"zebra_spmm_kernel": replay["zebra_spmm_kernel"]}}


def time_lm_kernels(lm: dict, edge_errs: dict, device, gemms=("zebra_spmm_kernel",
                                                             "zebra_spmm_cs_kernel"),
                    codec: bool = True, stream_rows=None, suffix=None) -> list[dict]:
    """The LM kernels on the path's inputs: the GEMMs on the ffn_hidden maps
    of the prefill (summed per prefill), zebra_pack on the handoff's
    compressible leaves (summed per handoff, when ``codec``); each beside
    its plain version, its bound and, for the GEMMs, torch.matmul of the
    keep-gated dense bf16 map by w (TF32 off). For another architecture
    than gemma3-4b the rows are named ``... (<arch> prefill)`` (or
    ``suffix``). Then the stream kernels on the served inputs
    (``stream_rows``, by default gemma3-4b's LM_STREAM_ROWS)."""
    import torch
    from repro_torch.compress import CompressedMap, nonzero_bitmap
    from repro_torch.kernels import mask_pack, spmm_cs, zebra_spmm
    from repro_torch.kernels.stream_timing import bound_bytes
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    t_obj = lm["t_obj"]
    names = (*gemms, *(("zebra_pack",) if codec else ()))
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "max_abs_err": edge_errs[k], "bound_by": "bytes"} for k in names}
    terms = {k: [0.0, 0.0] for k in names}           # summed bytes and operations times
    live_flops = 0                                   # 2 n_live bs bc N, summed per prefill
    for h, w in (lm["maps"] if gemms else ()):
        x2 = h.reshape(-1, h.shape[-1])
        M, K = x2.shape
        N, item = w.shape[1], x2.element_size()
        bitmap = mask_pack.bitmap_plain(x2, t_obj, BS, BC)
        keep, slot, payload, n_live = gemm_pieces(x2, bitmap, BS, BC)
        for k, e in compare_gemms(x2, w, bitmap, BS, BC, f"ffn_hidden map {M}x{K}").items():
            if k in rows:
                rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], e)
        gated = zebra_spmm.gate_blocks(x2, bitmap, BS, BC)
        lib = time_ms(lambda: torch.matmul(gated, w), flush, iters=5, warmup=1)
        del gated
        live_flops += 2 * n_live * BS * BC * N
        flops_ms = 2 * n_live * BS * BC * N / BF16_FLOPS * 1e3
        common = n_live * BS * BC * item + bitmap.numel() + K * N * item + M * N * 4
        calls = {
            "zebra_spmm_cs_kernel": (
                lambda: spmm_cs.spmm_cs_cuda(payload, w, bitmap, slot, BS, BC),
                lambda: spmm_cs.spmm_cs_plain(payload, w, bitmap, keep, slot, BS, BC),
                common + 4 * n_live),
            "zebra_spmm_kernel": (lambda: zebra_spmm.spmm_cuda(x2, w, bitmap, BS, BC),
                                  lambda: zebra_spmm.spmm_plain(x2, w, bitmap, BS, BC),
                                  common)}
        for k in gemms:
            kern, plain, nbytes = calls[k]
            r = rows[k]
            r["ms"] += time_ms(kern, flush, iters=5, warmup=1)
            r["plain_ms"] += time_ms(plain, flush, iters=5, warmup=1)
            r["library_ms"] += lib
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            r["bound_ms"] += max(bytes_ms, flops_ms)
            terms[k][0] += bytes_ms
            terms[k][1] += flops_ms
    n_maps = len(lm["maps"])
    for k in gemms:
        r = rows[k]
        r["ms_per_launch"] = r["ms"] / n_maps
        r["bound_ms_per_launch"] = r["bound_ms"] / n_maps
        r["library_ms_per_launch"] = r["library_ms"] / n_maps
        r["tflops_live"] = live_flops / (r["ms"] * 1e-3) / 1e12
        r["body"] = GEMM_BODY[str(lm["maps"][0][1].dtype)]
        print(f"  {k}: {r['ms_per_launch']:.4f} ms per launch (bound "
              f"{r['bound_ms_per_launch']:.4f}, torch.matmul {r['library_ms_per_launch']:.4f}), "
              f"{r['tflops_live']:.2f} TFLOP/s of live work ({r['body']})")
    for k, (b, f) in terms.items():
        rows[k]["bound_by"] = "operations" if f > b else "bytes"
        if b or f:
            print(f"  {k}: bound terms over the prefill: bytes {b:.4f} ms, operations "
                  f"{f:.4f} ms")
    if codec:
        r = rows["zebra_pack"]
        r["library_ms"], r["copy_ms"] = None, 0.0
        for d, c in zip(lm["dense"], lm["comp"]):
            if not isinstance(c, CompressedMap):
                continue
            x2 = d.reshape(c.m, c.k)
            compare_zebra_pack(x2, c.bs, c.bc, f"KV leaf {tuple(d.shape)}")
            bitmap = nonzero_bitmap(x2, c.bs, c.bc)
            keep, slot, _, n_live = gemm_pieces(x2, bitmap, c.bs, c.bc)
            n_live_t = keep.sum(dtype=torch.int32)
            r["ms"] += time_ms(lambda: mask_pack.pack_launch(x2, bitmap, slot, n_live_t, c.bs,
                                                             c.bc, "zebra_pack"), flush)
            r["plain_ms"] += time_ms(lambda: mask_pack.pack_plain(x2, bitmap, slot, n_live_t,
                                                                  c.bs, c.bc), flush)
            y = torch.empty_like(x2)
            r["copy_ms"] += time_ms(lambda: y.copy_(x2), flush)
            r["bound_ms"] += bound_bytes("zebra_pack_kernel", c.m, c.k, c.bs, c.bc,
                                         x2.element_size(), n_live) / HBM_BYTES_PER_S * 1e3
    if suffix is None:
        suffix = "" if lm["arch"] == LM_ARCH else f" ({lm['arch']} prefill)"
    print(f"LM kernel times{suffix} (per prefill: {n_maps} ffn_hidden maps; zebra_pack per "
          f"handoff; CUDA events, L2 flushed):")
    for k, r in rows.items():
        copy = f"  copy {r['copy_ms']:.4f} ms" if "copy_ms" in r else ""
        print(f"  {k:22s} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  library {r['library_ms']}{copy}")
    for k, n in lm["replay_launches"].items():
        if k in rows:
            rows[k]["replay_launches"] = n
    return [{"name": k + suffix, "route": "cuda",
             "source": SOURCE if k == "zebra_pack" else GEMM_SOURCE,
             "replaces": LM_KERNELS[k], "launches": lm["launches"][k], **rows[k]}
            for k in names] + time_lm_stream_kernels(
                lm, flush, LM_STREAM_ROWS if stream_rows is None else stream_rows)


def lm_row_inputs(lm: dict, name: str, src: str):
    """Each input of an LM stream row: ``(map (M, K), bs, bc, (kernel call,
    plain call), n_live)``. The prefill's ffn_hidden and kv_cache maps feed
    the comparator, the masking kernel and pack as ``kernel_calls`` does;
    the compressed KV leaves of the handoff feed the expander with their
    own payload and bitmap, as decode's ``decompress`` does, and the map is
    the dense leaf it must give back."""
    from repro_torch.compress import CompressedMap
    from repro_torch.compress.stream import unpack_bitmap
    from repro_torch.kernels import pack
    from repro_torch.kernels.schedule import slot_map
    if src == "leaves":
        for d, c in zip(lm["dense"], lm["comp"]):
            if not isinstance(c, CompressedMap):
                continue
            nm, nk = c.m // c.bs, c.k // c.bc
            bitmap = unpack_bitmap(c.index, nm, nk)
            keep, slot = slot_map(bitmap)
            yield (d.reshape(c.m, c.k), c.bs, c.bc,
                   (lambda: pack.unpack_cuda(c.payload, bitmap, slot, c.bs, c.bc),
                    lambda: pack.expand_payload(c.payload, keep, slot, nm, nk, c.bs, c.bc)),
                   int(c.n_live))
        return
    for x in ([h for h, _ in lm["maps"]] if src == "ffn" else lm["kv"]):
        x2 = x.reshape(-1, x.shape[-1])
        bs = BS if x.shape[-2] % BS == 0 else 1
        bc = BC if x2.shape[1] % BC == 0 else x2.shape[1]
        calls, n_live = kernel_calls(x2, lm["t_obj"], bs, bc, (name,))
        yield x2, bs, bc, calls[name], n_live


def time_lm_stream_kernels(lm: dict, flush, stream_rows) -> list[dict]:
    """The stream kernels on the served inputs (``stream_rows``: row name ->
    (kernel, inputs)), each held bit for bit against its plain version and
    summed per prefill or per decode, beside the byte bound and torch.amax
    or copy_ of each map."""
    import torch
    from repro_torch.kernels.stream_timing import bound_bytes
    out = []
    for row, (name, src) in stream_rows.items():
        r = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
        yards = {k: 0.0 for k, names in (("amax_ms", AMAX_YARDSTICK),
                                         ("copy_ms", COPY_YARDSTICK)) if name in names}
        n = 0
        for x2, bs, bc, (kern, plain), n_live in lm_row_inputs(lm, name, src):
            label = f"{row} map {tuple(x2.shape)}"
            got, want = kern(), plain()
            torch.cuda.synchronize()
            check(same_bits(got, want), f"{label}: differs from its plain version (max abs "
                                        f"err {max_abs_err(got, want)})")
            check(src != "leaves" or same_bits(got, x2), f"{label}: leaf not expanded losslessly")
            r["max_abs_err"] = max(r["max_abs_err"], max_abs_err(got, want))
            del got, want
            r["ms"] += time_ms(kern, flush, iters=5, warmup=1)
            r["plain_ms"] += time_ms(plain, flush, iters=5, warmup=1)
            if "amax_ms" in yards:
                blocks = x2.view(x2.shape[0] // bs, bs, x2.shape[1] // bc, bc)
                yards["amax_ms"] += time_ms(lambda: torch.amax(blocks, dim=(1, 3)), flush,
                                            iters=5, warmup=1)
            if "copy_ms" in yards:
                y = torch.empty_like(x2)
                yards["copy_ms"] += time_ms(lambda: y.copy_(x2), flush, iters=5, warmup=1)
            r["bound_ms"] += bound_bytes(name, *x2.shape, bs, bc, x2.element_size(), n_live) \
                / HBM_BYTES_PER_S * 1e3
            n += 1
        print(f"  {row}: {n} maps {tuple(x2.shape)}, bitwise == plain; "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
              + "".join(f", {k[:-3]} {v:.4f} ms" for k, v in yards.items())
              + " (CUDA events, L2 flushed)")
        out.append({"name": row, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
                    "launches": lm["launches"][name], **r, "bound_by": "bytes",
                    "library_ms": None, **yards})
    return out


# ---------------------------------------------------------------------------
# The validated stream: integrity levels, fault injection and recovery
# ---------------------------------------------------------------------------

LEVELS = ("off", "structural", "checksum")
# benchmarks/faults_bench.py's operating point and detection matrix
F_M, F_K, F_N = 256, 1024, 512
F_CASES = (("bitflip", "structural"), ("truncate", "structural"), ("nan", "structural"),
           ("count", "structural"), ("value", "checksum"))
FUSED_TOL = dict(rtol=1e-4, atol=1e-4)   # recovery's float32 matmul vs the payload GEMM


def operating_x(seed: int):
    """``faults_bench._operating_x``: an (M, K) float32 map whose blocks
    survive T_obj 0.5 at about 64 % zero blocks (numpy, as the reference)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keep = rng.random((F_M // BS, F_K // BC)) > 0.64
    x = rng.uniform(0.6, 1.0, size=(F_M, F_K)).astype(np.float32)
    return x * np.repeat(np.repeat(keep, BS, 0), BC, 1)


def run_validated_slice(device, variables, batches=BATCHES, batch=BATCH, width_mult=1.0):
    """ResNet-18 evaluate on ``stream`` with B's variables at structural and
    checksum: the three stream kernels 17 x batches times each and the
    masking kernel never; no failure; one batch's logits and every site's
    bytes equal the ``off`` run's bit for bit. Returns the host-clock ms
    per forward and the device busy ms per forward at each level."""
    import torch
    from repro_torch.compress import integrity
    from repro_torch.core import ZebraConfig
    from repro_torch.data import SYN_TINYIMAGENET, image_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.train import CNNTrainConfig, CNNTrainer

    zcfg = ZebraConfig(mode="infer", backend="stream", block_hw=BLOCK, t_obj=T_OBJ,
                       use_tnet=False)
    images = torch.from_numpy(image_batch(SYN_TINYIMAGENET, batch, 10_000)[0]).to(device)
    trainers, first = {}, {}
    for level in LEVELS:
        cfg = CNNTrainConfig(model="resnet18", width_mult=width_mult,
                             dataset=SYN_TINYIMAGENET, zebra=zcfg.replace(validation=level),
                             seed=0)
        tr = trainers[level] = CNNTrainer(cfg, device=device)
        n_sites = len(tr.model.map_specs(cfg.dataset.hw, cfg.zebra))
        integrity.clear_failures()
        if level != "off":
            reset_launch_counts()
            torch.cuda.synchronize()
            out = tr.evaluate(variables, batches=batches, batch=batch)
            torch.cuda.synchronize()
            check_launches(launch_counts(), {k: n_sites * batches for k in STREAM_KERNELS},
                           f"evaluate at {level}")
            print(f"  evaluate at {level}: acc {out['acc']} zero_frac {out['zero_frac']} "
                  f"bytes per batch {out['measured_bytes_per_batch']}")
        with SiteRecorder() as rec:
            logits, _ = tr.forward(variables, images)
        check(integrity.failures() == [], f"{level}: clean run detected "
                                          f"{integrity.failures()}")
        first[level] = (logits, [int(a.measured_bytes) for *_, a in rec.records])
    for level in LEVELS[1:]:
        check(same_bits(first[level][0], first["off"][0]),
              f"validated logits at {level} differ from off")
        check(first[level][1] == first["off"][1], f"site bytes at {level} differ from off")
    print(f"  logits and all {len(first['off'][1])} sites' bytes: structural == checksum "
          f"== off (bitwise); failures() empty; masking kernel 0 launches")
    ms, busy = {level: [] for level in LEVELS}, {}
    for level in (*LEVELS, *reversed(LEVELS)):          # in turns, twice each
        tr = trainers[level]
        tr.forward(variables, images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            tr.forward(variables, images)
        torch.cuda.synchronize()
        ms[level].append((time.perf_counter() - t0) / 5 * 1e3)
    for level in LEVELS:
        busy[level] = profile_calls(lambda: trainers[level].forward(variables, images), 3,
                                    f"{level} forwards", "forward")
    print("  evaluate forward of one batch of " + str(batch) + " (host clock, synchronised, "
          "two turns): " + ", ".join(f"{lv} {ms[lv][0]:.3f} / {ms[lv][1]:.3f} ms"
                                     for lv in LEVELS))
    return {"ms": ms, "busy": busy}


def run_detection(device) -> list[dict]:
    """The ``BENCH_faults.json`` rows of this slice on the card: the three
    ``validate.*`` levels (426016 stream bytes at zero_frac 0.5938 each) and
    the 15 ``detect.{stream,fused,serve}.*`` cases, each one fault injected,
    detected once and recovered (stream and serve bitwise, fused allclose),
    the recovery taking the masking kernel exactly once."""
    import numpy as np
    import torch
    from repro_torch.compress import compress_tree, decompress_tree, integrity
    from repro_torch.core import ZebraConfig
    from repro_torch.core.engine import zebra_site
    from repro_torch.ft import Fault, inject
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.serve import validate_state_ingest

    rows = []
    x0 = torch.from_numpy(operating_x(0)).to(device)
    for level in LEVELS:
        _, aux = zebra_site(x0, ZebraConfig(t_obj=0.5, mode="infer", backend="stream",
                                            validation=level), site="bench")
        zf, nbytes = round(float(aux.zero_frac), 4), int(aux.measured_bytes)
        check((nbytes, zf) == (426016, 0.5938), f"validate.{level}: {nbytes} B at {zf}")
        rows.append({"name": f"faults/validate.{level}", "stream_bytes": nbytes,
                     "zero_frac": zf})
    x1 = torch.from_numpy(operating_x(1)).to(device)
    w = torch.from_numpy((np.random.default_rng(2).normal(size=(F_K, F_N)) / np.sqrt(F_K))
                         .astype(np.float32)).to(device)
    for backend in ("stream", "fused"):
        ww = w if backend == "fused" else None
        for kind, level in F_CASES:
            cfg = ZebraConfig(t_obj=0.5, mode="infer", backend=backend, validation=level)
            integrity.clear_failures()
            reset_launch_counts()
            clean, _ = zebra_site(x1, cfg, site="b", w=ww)
            check(integrity.failures() == [] and launch_counts()["zebra_mask_kernel"] == 0,
                  f"detect.{backend}.{kind}: the clean run recovered")
            with inject(Fault(kind, site="engine:b", arg=3)) as plan:
                y, _ = zebra_site(x1, cfg, site="b", w=ww)
            torch.cuda.synchronize()
            ok = (same_bits(y, clean) if backend == "stream"
                  else bool(torch.allclose(y, clean, **FUSED_TOL)))
            row = {"name": f"faults/detect.{backend}.{kind}", "level": level,
                   "injected": len(plan.injected), "detected": len(integrity.failures()),
                   "recovered": int(ok), "mask_launches": launch_counts()["zebra_mask_kernel"]}
            check((row["injected"], row["detected"], ok, row["mask_launches"]) == (1, 1, True, 1),
                  f"{row}")
            rows.append(row)
    rng = np.random.default_rng(4)
    keep = rng.random((F_M // BS, F_K // BC)) > 0.64
    dense = {"k": torch.from_numpy(rng.normal(size=(F_M, F_K)).astype(np.float32)
                                   * np.repeat(np.repeat(keep, BS, 0), BC, 1)).to(device)}
    for kind, level in F_CASES:
        ctree = compress_tree(dense, bs=BS, bc=BC, checksum=(level == "checksum"))
        with inject(Fault(kind, site="serve", arg=2)) as plan:
            out, n_bad = validate_state_ingest(ctree, dense, level, log=lambda *_: None)
        ok = same_bits(decompress_tree(out)["k"], dense["k"])
        row = {"name": f"faults/detect.serve.{kind}", "level": level,
               "injected": len(plan.injected), "detected": n_bad, "recovered": int(ok)}
        check((row["injected"], n_bad, ok) == (1, 1, True), f"{row}")
        rows.append(row)
    integrity.clear_failures()
    print(f"detection matrix on the card: {len(rows)} rows")
    for r in rows:
        print(f"  {json.dumps(r)}")
    return rows


def run_lm_validated(device, off_tokens) -> dict:
    """gemma3-4b served at full width through ``serve.main --validate
    checksum`` on fused, with a bitmap bit of the first ``kv_cache`` stream
    and a live value of the first handoff leaf corrupted: launches per
    phase, detected == injected == 2, every kv_cache map equal by value to
    the masking pass's, the tokens equal to the ``off`` run's. Then the
    warm prefill at off, structural and checksum, in turns, on the same
    model, each run clean."""
    import torch
    from repro_torch.compress import integrity
    from repro_torch.core.engine import stream_bytes
    from repro_torch.core.zebra import zero_fraction
    from repro_torch.ft import Fault, inject
    from repro_torch.kernels import reset_launch_counts, zebra_mask
    from repro_torch.launch import serve, steps

    argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
            "--gen", str(LM_GEN), "--t-obj", str(LM_T_OBJ), "--backend", "fused",
            "--validate", "checksum"]
    print(f"LM serving, validated: python -m repro_torch.launch.serve {' '.join(argv)}, "
          f"faults armed: bitflip at engine:kv_cache (bit 3), value at serve (slot 2)")
    integrity.clear_failures()
    reset_launch_counts()
    with inject(Fault("bitflip", site="engine:kv_cache", arg=3),
                Fault("value", site="serve", arg=2)) as plan, \
            LMSiteRecorder() as rec, PhaseCounts(serve) as phases:
        out = serve.main(argv)
    torch.cuda.synchronize()
    final = launch_counts()
    n_layers, n_kv = len(rec.ffn), len(rec.kv)
    leaves = [r for r in out["meter"].records if r.compressed]
    detected = len(integrity.failures()) + out["ingest_recovered"]
    print(f"  injected {plan.injected}; detected: engine {integrity.failures()}, handoff "
          f"{out['ingest_recovered']} leaf recovered dense")
    check(plan.injected == [("bitflip", "engine:kv_cache"), ("value", "serve")]
          and integrity.failures() == ["engine:kv_cache"] and detected == 2,
          "validated LM: detected != injected")
    # 68 kv_cache sites: 67 expanded from their checked stream, 1 recovered
    # by the masking kernel
    check_launches(phases.at["prefill"], {"zebra_spmm_cs_kernel": n_layers,
                                          "zebra_bitmap_kernel": n_layers + n_kv,
                                          "zebra_pack_kernel": n_layers + n_kv,
                                          "zebra_unpack_kernel": n_kv - 1,
                                          "zebra_mask_kernel": 1}, "validated LM prefill")
    check_launches(diff_counts(phases.at["handoff"], phases.at["prefill"]),
                   {"zebra_pack": len(leaves), "zebra_unpack_kernel": 1},
                   "validated LM handoff")
    # the recovered leaf is handed over dense: decode expands the other 19
    check_launches(diff_counts(final, phases.at["handoff"]),
                   {"zebra_unpack_kernel": len(leaves) - 1}, "validated LM decode")
    for i, (x, y, aux) in enumerate(rec.kv):
        x2 = x.reshape(-1, x.shape[-1])
        y_plain, bm = zebra_mask.mask_plain(x2, LM_T_OBJ, BS, BC)
        check(bool((y.reshape(x2.shape) == y_plain).all()), f"kv site {i}: the validated "
                                                            f"map != the masking pass's")
        check(same_bits(aux.zero_frac, zero_fraction(bm))
              and int(aux.measured_bytes) == int(stream_bytes(bm.sum(), BS, BC, x.dtype,
                                                              bm.numel())),
              f"kv site {i}: zero_frac or stream bytes")
    tokens = out["tokens"].cpu()
    agree = int((tokens == off_tokens).sum())
    check(agree == tokens.numel(), f"validated tokens: {agree} of {tokens.numel()} equal "
                                   f"to the off run's")
    print(f"  kv_cache: {n_kv} maps equal by value to the masking pass's, stream bytes and "
          f"zero fractions from their bitmaps; greedy tokens {agree} of {tokens.numel()} "
          f"== the off fused run's")
    model, prompts = out["model"], out["prompts"]
    del out, rec
    base = model.cfg
    prefill_ms, busy = {level: [] for level in LEVELS}, {}
    for level in (*LEVELS, *reversed(LEVELS)):          # in turns, twice each
        model.cfg = base.replace(zebra_validation=level)
        integrity.clear_failures()
        again = serve.serve_one_shot(model, prompts, LM_GEN, log=lambda *_: None)
        check(integrity.failures() == [] and again["ingest_recovered"] == 0,
              f"clean run at {level} recovered something")
        check(torch.equal(again["tokens"].cpu(), off_tokens), f"tokens at {level}")
        prefill_ms[level].append(again["prefill_ms"])
        del again
    for level in LEVELS:
        model.cfg = base.replace(zebra_validation=level)
        busy[level] = profile_calls(lambda: steps.prefill(model, prompts), 2,
                                    f"{level} prefills", "prefill")
    model.cfg = base
    print("  warm prefill (host clock, synchronised, two turns): " + ", ".join(
        f"{lv} {prefill_ms[lv][0]:.3f} / {prefill_ms[lv][1]:.3f} ms" for lv in LEVELS))
    return {"prefill_ms": prefill_ms, "busy": busy}


# ---------------------------------------------------------------------------
# LM training: gemma3-4b at full width through the masking and stream kernels
# ---------------------------------------------------------------------------

# gemma3-4b at full width cut to 12 layers (two superlayers: 10 local + 2
# global). float32 parameters, their gradients and AdamW's two moments take
# 64.6 GB at 34 layers before any activation (PERF.md §4); at 12, 29.8 GB.
# Batch 2 x 2048 in two microbatches of 1 x 2048: the banded local, the
# chunked global attention and the chunked CE (2 chunks) forward and
# backward; 3 steps of AdamW warmup_cosine(3e-4, 1, 3), bf16 gradients,
# clip 1.0, at the serving phase's T_obj
LMT = dict(layers=12, batch=2, seq=2048, grad_accum=2, steps=3, t_obj=LM_T_OBJ)
LMT_ROWS = {f"{k} (gemma3-4b training)": (k, "ffn") for k in
            ("zebra_mask_kernel", "zebra_bitmap_kernel", "zebra_pack_kernel",
             "zebra_unpack_kernel")}


class FFNSiteRecorder:
    """Records every ``ffn_hidden`` site of an LM run (training, or an MoE
    model served), or with ``site="layer_out"`` every enabled ``layer_out``
    site: its map shape, element size, backend label, zero fraction, stream
    bytes (detached: a threshold net's L2 term would hold the site's map for
    its backward) and whether it ran in a backward (remat's recompute), with
    a copy of the first ``keep`` input maps; counts the sites entered
    (``calls``: a recompute that stops early, once the backward has what it
    needs, can stop inside a unit's last site, after its kernels and before
    it returns) and the ``kv_cache`` sites. Adds no kernel launch."""

    def __init__(self, keep: int = 0, site: str = "ffn_hidden"):
        self.keep, self.kv, self.site, self.calls = keep, 0, site, 0
        self.records, self.maps = [], []

    def __enter__(self):
        import repro_torch.core.engine as engine
        import repro_torch.models.lm.blocks as blocks
        import repro_torch.models.lm.ffn as ffn
        self._owner = blocks if self.site == "layer_out" else ffn
        self._mods = (engine, self._owner)
        self._inner = (engine.zebra_site, self._owner.zebra_site)
        engine_site, own_site = self._inner

        def site(x, cfg, **kw):
            if not cfg.enabled:
                return own_site(x, cfg, **kw)
            import torch
            self.calls += 1
            if len(self.maps) < self.keep:
                self.maps.append(x.detach().clone())
            y, aux = own_site(x, cfg, **kw)
            self.records.append((tuple(x.shape), x.element_size(), aux.backend,
                                 aux.zero_frac.detach(), aux.measured_bytes,
                                 torch._C._current_graph_task_id() != -1))
            return y, aux

        def kv_site(x, cfg, **kw):
            self.kv += kw.get("site") == "kv_cache"
            return engine_site(x, cfg, **kw)
        self._owner.zebra_site, engine.zebra_site = site, kv_site
        return self

    def __exit__(self, *exc):
        (engine, owner), (engine_site, own_site) = self._mods, self._inner
        engine.zebra_site, owner.zebra_site = engine_site, own_site


def check_token_band(records, label: str) -> float:
    """Every token site's stream bytes inside the Eq. 2/3 band (8 x 128
    blocks): its zero fraction resolves to a whole count of live blocks,
    and the bytes lie in [0, 1) above Eq. 2/3 at that count (in exact
    rational arithmetic: a float product rounds at these map sizes)."""
    from fractions import Fraction
    from repro_torch.core.bandwidth import TokenMapSpec
    worst = 0.0
    for i, (shape, item, _, zf, nbytes, *_) in enumerate(records):
        spec = TokenMapSpec(s=math.prod(shape[:-1]), d=shape[-1], bits=8 * item,
                            block_seq=BS, block_ch=BC)
        nb, zf, nbytes = spec.n_blocks, float(zf), int(nbytes)
        live = round((1.0 - zf) * nb)
        check(abs((1.0 - zf) * nb - live) < 1e-2,
              f"{label} site {i}: zero_frac {zf} is no count of {nb} blocks")
        # Eq. 2 + 3 at zero fraction (nb - live) / nb: surviving data bits
        # plus one index bit a block
        delta = nbytes - (Fraction(spec.map_bits * live, nb) + spec.index_bits) / 8
        worst = max(worst, abs(float(delta)))
        check(0 <= delta < 1, f"{label} site {i}: {nbytes} B is {float(delta)} B off Eq. 2/3")
    return worst


def host_copy(tensors: dict) -> dict:
    """A copy on the host (also of host tensors: the step updates in place)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def differing(got: dict, want: dict) -> list[str]:
    """Names whose tensors differ in a bit (``want`` on the host)."""
    return [k for k, v in want.items() if not same_bits(got[k].detach().cpu(), v)]


def run_train_parity(device, arch, t_obj, runs, batch, seq, grad_accum, steps, *,
                     layers=0, remat="block", reduced=False, enc_feats=None, keep=0,
                     other_sites=None, before=None, site="ffn_hidden",
                     profiled=None) -> tuple[dict, list]:
    """Train ``arch`` at full width (``layers`` > 0 keeps the first that
    many) with ``remat`` through ``launch.train.train_lm`` on each backend
    of ``runs`` (backend -> the launch counts it must make), ``reference``
    first: a fresh model each, handed to ``before(backend, model, batch)``
    first, the launch counts set to 0 just before the run and read just
    after. Every run's loss, router_aux and gradient norm are finite (an
    MoE's loss ce + router_aux_coef · router_aux), and every later run's
    parameters after ``steps`` steps equal R's bit for bit. The ``stream``
    run's sites are all ``stream`` but ``other_sites`` (label -> sites a
    run, which launch nothing), each step's ``measured_bytes`` is the sum
    over its sites (under ``remat="block"`` each site is met once more in
    the recompute), and every ``stream`` site lies inside the Eq. 2/3 band.
    ``site`` is the architecture's one Zebra site kind (``ffn_hidden``, or
    mamba2's ``layer_out``). One more step of each backend in ``profiled``
    (default: every run) runs under the profiler for the busy share.
    Returns ({backend: counts}, the first ``keep`` maps of the ``stream``
    run's sites)."""
    import torch
    from collections import Counter
    from repro_torch.data import LMDatasetConfig, lm_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw, warmup_cosine

    base = train.build_config(arch, reduced=reduced, t_obj=t_obj, n_layers=layers).replace(
        zebra_tnet=False, grad_accum=grad_accum, remat=remat)
    check(base.zebra_sites == (site,), f"sites {base.zebra_sites}, want ({site},)")
    tokens0 = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=base.vocab), batch, seq, 0)
                               ).to(device=device, dtype=torch.int64)
    batch0 = {"tokens": tokens0, **({"enc_feats": enc_feats(0)} if enc_feats else {})}
    kinds = Counter(base.layer_pattern[i % len(base.layer_pattern)]
                    for i in range(base.n_layers))
    print(f"{arch} training: full width, {base.n_layers} layers "
          f"({', '.join(f'{n} {k}' for k, n in kinds.items())}"
          f"{f', {base.encoder_layers} encoder' if base.encoder_layers else ''}), remat "
          f"{remat}, batch {batch} x {seq} in {grad_accum} microbatches, {steps} steps, T_obj "
          f"{t_obj}, float32 parameters, bf16 compute"
          + (", fresh seeded frames each step" if enc_feats else ""))
    recompute = 2 if remat == "block" else 1
    params_r, counts, maps = None, {}, []
    for backend, want in runs.items():
        model = LM(base.replace(zebra_backend=backend),
                   generator=torch.Generator(device=device).manual_seed(0), device=device)
        if before is not None:
            before(backend, model, batch0)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        with FFNSiteRecorder(keep=keep if backend == "stream" else 0, site=site) as rec:
            _, state, hist, _ = train.train_lm(model.cfg, steps=steps, batch=batch, seq=seq,
                                               device=device, model=model,
                                               log=lambda *_: None, enc_feats=enc_feats)
        torch.cuda.synchronize()
        counts[backend] = launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
        check_launches(counts[backend], want, f"{arch} {backend}")
        labels = Counter(r[2] for r in rec.records)
        ms = [m["ms"] for m in hist]
        step_ms = sum(ms[1:] or ms) / len(ms[1:] or ms)
        print(f"  {backend}: {ms} ms per step, {step_ms:.3f} ms from step 2 on (host clock, "
              f"synchronised); max_memory_allocated {peak / 2 ** 30:.2f} GiB; sites by "
              f"label {dict(labels)}")
        for k in ("loss", "ce", "router_aux", "zero_frac", "grad_norm", "measured_bytes"):
            print(f"    {k} {[m[k] for m in hist]}")
        check(all(math.isfinite(m[k]) for m in hist for k in ("loss", "router_aux",
                                                                "grad_norm")),
              f"{backend}: loss, router_aux or grad_norm not finite")
        if base.is_moe:
            # the loss is ce + router_aux_coef * router_aux (no threshold nets)
            for m in hist:
                check(m["router_aux"] > 0 and math.isclose(
                    m["loss"], m["ce"] + base.router_aux_coef * m["router_aux"],
                    rel_tol=1e-5), f"{backend}: the loss is not ce + "
                                   f"{base.router_aux_coef} router_aux")
        if backend == "stream":
            # the forward's sites, each met again in the recompute (which may
            # stop early inside a unit's last site, unrecorded)
            fwd = [r for r in rec.records if not r[5]]
            want_fwd = Counter({k: n // recompute for k, n in
                                {"stream": want[STREAM_KERNELS[0]], **(other_sites or {})}.items()})
            check(Counter(r[2] for r in fwd) == want_fwd
                  and rec.calls == recompute * len(fwd) and set(labels) == set(want_fwd),
                  f"stream: forward sites by label {dict(Counter(r[2] for r in fwd))}, "
                  f"{rec.calls} entered, all {dict(labels)}")
            per_step, rest = divmod(len(fwd), steps)
            check(rest == 0, f"{len(fwd)} forward site records over {steps} steps")
            for i, m in enumerate(hist):
                sites = sum(int(r[4]) for r in fwd[i * per_step:(i + 1) * per_step])
                check(m["measured_bytes"] == sites > 0,
                      f"stream step {i + 1}: measured_bytes {m['measured_bytes']} != its "
                      f"forward sites' {sites}")
            worst = check_token_band([r for r in rec.records if r[2] == "stream"],
                                     f"{arch} stream train")
            print(f"  stream: each step's measured_bytes == the sum over its {per_step} "
                  f"forward sites ({rec.calls} sites entered, {len(rec.records) - len(fwd)} "
                  f"recorded in the recompute); every recorded stream site inside the Eq. "
                  f"2/3 band (worst |delta| {worst} B)")
            maps = rec.maps
        if params_r is None:
            params_r = host_copy(state["params"])
        else:
            bad = differing(state["params"], params_r)
            check(not bad, f"{backend} after {steps} steps: {bad[:4]} differ from reference")
            print(f"  {backend}: all {len(params_r)} parameters after {steps} steps == "
                  f"reference (bitwise)")
        # one more step under the profiler (it moves the state: after the
        # comparison)
        opt = adamw(warmup_cosine(3e-4, 1, steps))
        busy = (profile_calls(lambda: lm_steps.train_step(model, opt, state, batch0), 1,
                              f"{backend} steps", "step")
                if profiled is None or backend in profiled else None)
        if busy is not None:
            print(f"  {backend}: device busy {100 * busy / step_ms:.1f} % of an unprofiled "
                  f"step ({busy:.3f} of {step_ms:.3f} ms)")
        del model, state, rec
        torch.cuda.empty_cache()
    return counts, maps


def run_lm_training(device, arch=LM_ARCH, layers=LMT["layers"], batch=LMT["batch"],
                    seq=LMT["seq"], grad_accum=LMT["grad_accum"], steps=LMT["steps"],
                    t_obj=LMT["t_obj"], reduced=False, zf_band=(0.5, 0.8)) -> list[dict]:
    """The LM training runs R, B, C (``run_train_parity``, no remat, with
    step 1 checked outside any run first) and A (module docstring) through
    ``repro_torch.launch.train``; returns the kernel rows of the masking
    kernel, the comparator, pack and the expander per training step, held
    and timed on C's ffn_hidden maps of one step."""
    import torch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train
    from repro_torch.optim import adamw, warmup_cosine

    n_sites = train.build_config(arch, reduced=reduced, n_layers=layers).n_layers * grad_accum
    per_run = n_sites * steps
    ref = {}

    def step1(backend, model, batch0):
        """Step 1's gradients and loss outside any training run: R's twice
        (a nondeterministic reduction would show here first), then B's and
        C's against R's."""
        g, loss, m = lm_steps.accumulate_gradients(model, dict(model.named_parameters()),
                                                   batch0["tokens"])
        if backend == "reference":
            g_again, loss_again, _ = lm_steps.accumulate_gradients(
                model, dict(model.named_parameters()), batch0["tokens"])
            bad = [k for k in g if not same_bits(g_again[k], g[k])]
            check(same_bits(loss_again, loss) and not bad,
                  f"R step 1 twice: loss {float(loss_again)} vs {float(loss)}; "
                  f"gradients {bad[:4]}")
            ref.update(g=host_copy(g), loss=loss.cpu(), tokens=batch0["tokens"])
            zf = float(m["zero_frac"])
            print(f"  step 1: R twice: loss {float(loss)} and all {len(g)} gradients equal "
                  f"(bitwise); ffn_hidden zero fraction {zf} at T_obj {t_obj}")
            check(zf_band is None or zf_band[0] <= zf <= zf_band[1],
                  f"R step 1 ffn_hidden zero fraction {zf} outside {zf_band}")
        elif backend == "pallas":
            bad = differing(g, ref.pop("g"))
            check(same_bits(loss.cpu(), ref["loss"]) and not bad,
                  f"B step 1: loss {float(loss)} vs R {float(ref['loss'])}; gradients "
                  f"{bad[:4]}")
            print(f"  step 1: B pallas loss and all {len(g)} gradients == R (bitwise)")
        else:
            check(same_bits(loss.cpu(), ref["loss"]),
                  f"C step 1 loss {float(loss)} vs R {float(ref['loss'])}")
            print("  step 1: C stream loss == R (bitwise)")

    counts, maps = run_train_parity(
        device, arch, t_obj, {"reference": {}, "pallas": {"zebra_mask_kernel": per_run},
                              "stream": {k: per_run for k in STREAM_KERNELS}},
        batch, seq, grad_accum, steps, layers=layers, remat="none", reduced=reduced,
        keep=n_sites, before=step1)
    maxima = [h.reshape(-1, BS, h.shape[-1] // BC, BC).float().abs().amax(dim=(1, 3))
              for h in maps]
    print("  ffn_hidden zero fraction by T_obj on C's step-1 maps: " + ", ".join(
        f"{t}: {float(sum((m < t).sum() for m in maxima) / sum(m.numel() for m in maxima)):.4f}"
        for t in (0.5 * t_obj, 0.9 * t_obj, t_obj, 1.1 * t_obj, 1.5 * t_obj)))
    del maxima

    # A: the paper's Eq. 1 through the launcher, threshold nets asked for pallas
    argv = ["--arch", arch, "--layers", str(layers), "--batch", str(batch), "--seq",
            str(seq), "--steps", str(steps), "--t-obj", str(t_obj)]
    print(f"  A: python -m repro_torch.launch.train {' '.join(argv)} --backend pallas "
          f"--remat none")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    with FFNSiteRecorder() as rec:
        out = train.main([*argv, "--backend", "pallas", "--remat", "none",
                          *(["--reduced"] if reduced else []), "--device", str(device)])
    hist_a = out["history"]
    peak_a = torch.cuda.max_memory_allocated(device)
    rest = hist_a[1:] or hist_a
    a_ms = sum(m["ms"] for m in rest) / len(rest)
    opt = adamw(warmup_cosine(3e-4, 1, steps))
    busy = profile_calls(lambda: lm_steps.train_step(out["model"], opt, out["state"],
                                                     {"tokens": ref["tokens"]}),
                         1, "A steps", "step")
    if busy is not None:
        print(f"  A: device busy {100 * busy / a_ms:.1f} % of an unprofiled step "
              f"({busy:.3f} of {a_ms:.3f} ms)")
    del out
    torch.cuda.empty_cache()
    labels = {r[2] for r in rec.records}
    check(labels == {"reference(tnet)"}, f"A: site backends {labels}")
    check(not any(launch_counts().values()), f"A launched a kernel: {launch_counts()}")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["zebra_reg"]) for m in hist_a),
          "A: loss or zebra_reg not finite")
    print(f"  A: all {len(rec.records)} sites ran reference(tnet); per step: loss "
          f"{[m['loss'] for m in hist_a]}, zebra_reg {[m['zebra_reg'] for m in hist_a]}, "
          f"ce {[m['ce'] for m in hist_a]}, zero_frac {[m['zero_frac'] for m in hist_a]}, "
          f"{[round(m['ms'], 3) for m in hist_a]} ms; max_memory_allocated "
          f"{peak_a / 2 ** 30:.2f} GiB")
    del rec

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    lm = {"maps": [(h, None) for h in maps], "t_obj": t_obj,
          "launches": {**counts["stream"],
                       "zebra_mask_kernel": counts["pallas"]["zebra_mask_kernel"]}}
    print(f"LM training kernel times per step ({len(maps)} ffn_hidden maps of C's step 1):")
    return time_lm_stream_kernels(lm, flush, LMT_ROWS)


# ---------------------------------------------------------------------------
# Remat at depth, checkpointing and the step supervisor
# ---------------------------------------------------------------------------

# the deepest gemma3-4b that trains on one card with remat="block": all 34
# layers, at K 1 (67.50 GiB) and at K 2 (67.94 GiB), found by
# src/repro_torch/launch/lm_timing.py depth (34, then 6 fewer at a time)
LMD = dict(layers=34, batch=2, seq=2048, grad_accum=2, steps=2, t_obj=LM_T_OBJ)
# crash and resume: full width cut to 2 layers (0.87 B parameters, 10.4 GB of
# float32 state a checkpoint), 4 steps on stream, a checkpoint every 2
LMC = dict(layers=2, steps=4, ckpt_every=2, crash_at=3)


def two_copy_gradients(model, tokens):
    """The accumulation before one-copy ``.grad`` sums: each microbatch's
    float32 gradients by ``autograd.grad``, added into the first's
    (``acc + g`` in microbatch order), then divided by K: the yardstick the
    one-copy form must equal bit for bit."""
    import torch
    leaves = list(model.parameters())
    K = model.cfg.grad_accum
    grads = None
    for mb in tokens.reshape(K, tokens.shape[0] // K, -1):
        loss, _ = model.loss(mb, "train")
        gs = [torch.zeros_like(p) if g is None else g.float()
              for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        if grads is None:
            grads = gs
            continue
        for acc, g in zip(grads, gs):
            acc.add_(g)
        del gs
    for g in grads:
        g.div_(K)
    return dict(zip((n for n, _ in model.named_parameters()), grads))


def run_lm_depth(device, arch=LM_ARCH, layers=LMD["layers"], batch=LMD["batch"],
                 seq=LMD["seq"], grad_accum=LMD["grad_accum"], steps=LMD["steps"],
                 t_obj=LMD["t_obj"], check_layers=12, reduced=False) -> None:
    """Phase 11a: gemma3-4b at full width and ``layers`` deep with
    ``remat="block"`` through ``launch.train.train_lm``: R (reference) and
    C (stream) ``steps`` steps each at K ``grad_accum``, C's parameters
    equal to R's bit for bit and its stream kernels launched forward plus
    recompute; R again at K 1; step 1's one-copy gradients equal to the
    two-copy yardstick's; remat none and block equal at ``check_layers``."""
    import torch
    from repro_torch.data import LMDatasetConfig, lm_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw, warmup_cosine

    base = train.build_config(arch, reduced=reduced, t_obj=t_obj, n_layers=layers).replace(
        zebra_tnet=False, grad_accum=grad_accum, remat="block")
    tokens0 = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=base.vocab), batch, seq, 0)
                               ).to(device=device, dtype=torch.int64)
    print(f"LM remat at depth: {arch} at full width, {base.n_layers} layers, remat block, "
          f"batch {batch} x {seq}, {steps} steps, T_obj {t_obj}")

    def fresh(cfg):
        return LM(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)

    def run(model, label, want):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        _, state, hist, _ = train.train_lm(model.cfg, steps=steps, batch=batch, seq=seq,
                                           device=device, model=model, log=lambda *_: None)
        torch.cuda.synchronize()
        check_launches(launch_counts(), want, label)
        peak = torch.cuda.max_memory_allocated(device)
        check(all(math.isfinite(m["loss"]) for m in hist), f"{label}: loss not finite")
        print(f"  {label}: {[m['ms'] for m in hist]} ms per step (host clock, "
              f"synchronised); max_memory_allocated {peak / 2 ** 30:.2f} GiB; loss "
              f"{[m['loss'] for m in hist]}")
        return state, hist[-1]["ms"]

    def profile(model, state, label, step_ms):
        """One more step under the profiler (it moves the state: after any
        comparison of it)."""
        opt = adamw(warmup_cosine(3e-4, 1, steps))
        busy = profile_calls(lambda: lm_steps.train_step(model, opt, state,
                                                         {"tokens": tokens0}),
                             1, f"{label} steps", "step")
        if busy is not None:
            print(f"  {label}: device busy {100 * busy / step_ms:.1f} % of an unprofiled "
                  f"step ({busy:.3f} of {step_ms:.3f} ms)")

    # step 1 at K grad_accum: the one-copy accumulation against the two-copy form
    model = fresh(base)
    want = two_copy_gradients(model, tokens0)
    got, _, _ = lm_steps.accumulate_gradients(model, dict(model.named_parameters()), tokens0)
    bad = [k for k in want if not same_bits(got[k], want[k])]
    check(not bad, f"one-copy gradients differ from the two-copy form: {bad[:4]}")
    print(f"  step 1 at K {grad_accum}: all {len(want)} one-copy gradients == the "
          f"two-copy form (bitwise)")
    del want, got
    torch.cuda.empty_cache()

    # R then C at K grad_accum; C's stream kernels run forward and recompute
    n_sites = base.n_layers * grad_accum
    state, ms = run(model, f"R reference, K {grad_accum}", {})
    params_r = host_copy(state["params"])
    profile(model, state, f"R reference, K {grad_accum}", ms)
    del model, state
    torch.cuda.empty_cache()
    model = fresh(base.replace(zebra_backend="stream"))
    state, _ = run(model, f"C stream, K {grad_accum}",
                   {k: 2 * n_sites * steps for k in STREAM_KERNELS})
    bad = differing(state["params"], params_r)
    check(not bad, f"C after {steps} steps under remat: {bad[:4]} differ from R")
    print(f"  C: all {len(params_r)} parameters after {steps} steps == R (bitwise); each "
          f"stream kernel {2 * n_sites * steps} launches = {n_sites} sites x {steps} steps "
          f"x 2 (forward + recompute)")
    del model, state, params_r
    torch.cuda.empty_cache()
    model = fresh(base.replace(grad_accum=1))
    state, ms = run(model, "R reference, K 1", {})
    profile(model, state, "R reference, K 1", ms)
    del model, state
    torch.cuda.empty_cache()

    # remat none and block: the same step-1 gradients
    cut = base.replace(n_layers=check_layers)
    grads = {}
    for mode in ("none", "block"):
        model = fresh(cut.replace(remat=mode))
        grads[mode] = lm_steps.accumulate_gradients(model, dict(model.named_parameters()),
                                                    tokens0)[:2]
        del model
    bad = [k for k, v in grads["none"][0].items() if not same_bits(grads["block"][0][k], v)]
    check(same_bits(grads["block"][1], grads["none"][1]) and not bad,
          f"remat block vs none at {check_layers} layers: {bad[:4]}")
    print(f"  {check_layers} layers: remat block == none, loss and all "
          f"{len(grads['none'][0])} gradients (bitwise)")
    del grads
    torch.cuda.empty_cache()
    run_int8_depth(device, base.replace(grad_accum=1), tokens0)


def run_int8_depth(device, cfg, tokens) -> None:
    """One train step with int8 gradient compression under remat block at
    ``cfg``'s depth, then a pattern's length fewer layers at a time until a
    step fits the card: each attempt's ``max_memory_allocated`` and the
    bytes of the state by component (parameters, float32 gradients, the
    AdamW moments, the int8 residual); the step's extra memory above the
    state and the gradients is the compression's temporaries, a few
    ``compress.CHUNK``s. The loss must be finite."""
    import torch
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw, compress, warmup_cosine

    def nbytes(ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    # the pass alone on a 1 GiB gradient and a ragged tail: what it holds
    # above the gradient and its residual
    g = torch.randn((1 << 28) + 12345, device=device)
    st = compress.init_state({"w": g}, "int8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    compress.compressed_gradients({"w": g}, st, "int8")
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(device) - base
    chunk = compress.CHUNK * 4
    print(f"  int8 pass on a 1 GiB float32 gradient (2**28 + 12345 elements): {extra} B above "
          f"the gradient and its residual, {extra / chunk:.4f} chunks of {chunk} B")
    check(extra <= 6 * chunk, f"the int8 pass held {extra} B, more than 6 chunks")
    del g, st
    torch.cuda.empty_cache()
    print(f"  int8 gradient compression at depth: one step, batch {tokens.shape[0]} x "
          f"{tokens.shape[1] - 1}, remat block, from {cfg.n_layers} layers down")
    for layers in range(cfg.n_layers, 0, -len(cfg.layer_pattern)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        parts, err = {}, None
        try:
            model = LM(cfg.replace(n_layers=layers),
                       generator=torch.Generator(device=device).manual_seed(0), device=device)
            opt = adamw(warmup_cosine(3e-4, 1, 1))
            state = lm_steps.init_train_state(model, opt, "int8")
            params = list(state["params"].values())
            parts = {"params": nbytes(params), "grads": 4 * sum(p.numel() for p in params),
                     "adamw": nbytes([t for b in state["opt"].values() for t in b.values()]),
                     "int8 residual": nbytes(state["compress"].error.values())}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = lm_steps.train_step(model, opt, state, {"tokens": tokens}, compress="int8")
            loss = float(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0]
        peak = torch.cuda.max_memory_allocated(device)
        model = opt = state = params = None
        gc.collect()
        torch.cuda.empty_cache()
        comp = ", ".join(f"{k} {v / 2 ** 30:.2f}" for k, v in parts.items())
        if err is not None:
            print(f"  int8 at {layers} layers: out of memory ({err[:90]}...); peak "
                  f"{peak / 2 ** 30:.2f} GiB; state GiB: {comp} (sum "
                  f"{sum(parts.values()) / 2 ** 30:.2f})")
            continue
        check(math.isfinite(loss), f"int8 step at {layers} layers: loss {loss}")
        extra = peak - sum(parts.values())
        print(f"  int8 at {layers} layers: fits, {ms:.1f} ms, loss {loss:.4f}; "
              f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; state GiB: {comp} (sum "
              f"{sum(parts.values()) / 2 ** 30:.2f}); above it {extra / 2 ** 30:.2f} GiB "
              f"(activations under remat and the compression's chunks of "
              f"{compress.CHUNK * 4 / 2 ** 20:.0f} MiB)")
        return
    raise SmokeFailure("no depth fits an int8 step")


class CkptTimer:
    """Times ``CheckpointManager.save`` (what blocks the loop: the copy to
    the host; for ``ShardedCheckpointManager`` the gather to rank 0), its
    write (on the writer thread), ``restore`` (verify and load) and
    ``save_acts``/``restore_acts`` of ``cls`` (default the one-process
    manager); adds nothing else."""

    def __init__(self, cls=None):
        self.times, self._cls = {}, cls

    def __enter__(self):
        from repro_torch.checkpoint import manager
        self._cls = self._cls or manager.CheckpointManager
        self._own = set(vars(self._cls))
        self._inner = {n: getattr(self._cls, n) for n in
                       ("save", "_write", "restore", "save_acts", "restore_acts")}
        for name, fn in self._inner.items():
            setattr(self._cls, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return wrapped

    def __exit__(self, *exc):
        for name, fn in self._inner.items():
            if name in self._own:
                setattr(self._cls, name, fn)
            else:                       # inherited: the base class's again
                delattr(self._cls, name)


def run_lm_ckpt(device, arch=LM_ARCH, layers=LMC["layers"], batch=LMD["batch"],
                seq=LMD["seq"], grad_accum=LMD["grad_accum"], steps=LMC["steps"],
                ckpt_every=LMC["ckpt_every"], crash_at=LMC["crash_at"], t_obj=LM_T_OBJ,
                reduced=False) -> list[dict]:
    """Phase 11b: crash and resume under ``--ckpt`` (module docstring);
    returns the rows of the codec's pack and the expander on the
    ``save_acts`` maps."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.data import LMDatasetConfig, lm_batch
    from repro_torch.ft import CorruptStream, TransientStep, corrupt_file, crashing_step
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    cfg = train.build_config(arch, reduced=reduced, t_obj=t_obj, n_layers=layers,
                             backend="stream").replace(zebra_tnet=False,
                                                       grad_accum=grad_accum)
    tmp = tempfile.mkdtemp(prefix="zebra_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"LM checkpoint and resume: {arch} at full width, {cfg.n_layers} layers, "
              f"{steps} steps on stream, --ckpt-every {ckpt_every}, a crash at call "
              f"{crash_at}; {free / 1e9:.1f} GB free under {tempfile.gettempdir()}")

        def fresh():
            return LM(cfg, generator=torch.Generator(device=device).manual_seed(0),
                      device=device)

        def snapshot(state):
            return {**{f"params/{k}": v for k, v in state["params"].items()},
                    **{f"opt/{s}/{k}": v for s in ("m", "v")
                       for k, v in state["opt"][s].items()}}

        _, want, hist_u, _ = train.train_lm(cfg, steps=steps, batch=batch, seq=seq,
                                            device=device, model=fresh(),
                                            log=lambda *_: None)
        want_flat = snapshot(want)
        n_params = sum(v.numel() for k, v in want["params"].items())
        model = fresh()
        inner = train.train_step

        def dirty():
            """The crash after a half-applied update: every parameter and
            moment moved, then ``TransientStep``."""
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
            return TransientStep(f"injected crash at call {crash_at}")
        train.train_step = crashing_step(inner, crash_at, exc=dirty)
        try:
            with CkptTimer() as timer:
                _, got, hist, sup = train.train_lm(cfg, steps=steps, batch=batch, seq=seq,
                                                   device=device, model=model, ckpt=tmp,
                                                   ckpt_every=ckpt_every,
                                                   log=lambda *_: None)
        finally:
            train.train_step = inner
        check([e["class"] for e in sup.failure_log] == ["TransientStep"],
              f"failure log {sup.failure_log}")
        check([h["step"] for h in hist] == list(range(1, steps + 1)),
              f"history steps {[h['step'] for h in hist]}")
        bad = [k for k, v in snapshot(got).items() if not same_bits(v, want_flat[k])]
        check(not bad and got["step"] == want["step"] == steps,
              f"resumed run differs from the uninterrupted one: {bad[:4]}, step "
              f"{got['step']}")
        manifest = json.loads((Path(tmp) / f"step_{steps}" / "manifest.json").read_text())
        check(manifest["extra"] == {"loader_step": steps}, f"manifest extra {manifest}")
        check([h["loss"] for h in hist] == [h["loss"] for h in hist_u], "losses differ")
        state_bytes = sum(v.numel() * 4 for v in want_flat.values())
        print(f"  crashed at call {crash_at}, restored step {ckpt_every} and the loader at "
              f"{ckpt_every}: parameters, both AdamW moments ({len(want_flat)} tensors), "
              f"step {got['step']} and loader step {manifest['extra']['loader_step']} == "
              f"the uninterrupted run (bitwise); {n_params / 1e9:.3f} B parameters, "
              f"{state_bytes / 1e9:.2f} GB of float32 state a checkpoint")
        t = timer.times
        for i, (blk, wr) in enumerate(zip(t["save"], t["_write"])):
            print(f"  save {i + 1}: blocks the loop {blk * 1e3:.1f} ms (the copy to the "
                  f"host); write and CRCs {wr * 1e3:.1f} ms on the writer thread "
                  f"({state_bytes / wr / 1e6:.1f} MB/s)")
        print(f"  restore plus verify after the crash: {t['restore'][0] * 1e3:.1f} ms")
        del want, want_flat
        torch.cuda.empty_cache()

        # detect.ckpt.bitflip: the newest shard corrupted, restore falls back
        ckpt = sup.ckpt
        corrupt_file(str(Path(tmp) / f"step_{steps}" / "shard_0.npz"))
        t0 = time.perf_counter()
        step, _, extra = ckpt.restore(got)
        ms = (time.perf_counter() - t0) * 1e3
        # the fallback fired: the CRC (the zip member's or the manifest's) caught it
        detected = int(step < steps)
        recovered = int(step == steps - ckpt_every and extra["loader_step"] == step)
        check(detected == recovered == 1, f"ckpt bitflip: detected {detected}, restored "
                                          f"step {step}")
        print(f"  detect.ckpt.bitflip: injected 1, detected {detected}, recovered "
              f"{recovered} (restore-older: step {step}, {ms:.1f} ms)")

        # save_acts of one step's ffn_hidden maps (the masked site outputs)
        maps = []
        import repro_torch.models.lm.ffn as ffn
        site = ffn.zebra_site

        def keep(x, zcfg, **kw):
            y, aux = site(x, zcfg, **kw)
            maps.append(y.detach().clone())
            return y, aux
        ffn.zebra_site = keep
        try:
            with torch.no_grad():
                model.loss(torch.from_numpy(lm_batch(
                    LMDatasetConfig(vocab=cfg.vocab), batch // grad_accum, seq, 0)
                ).to(device=device, dtype=torch.int64))
        finally:
            ffn.zebra_site = site
        acts = {f"layer{i}/ffn_hidden": m for i, m in enumerate(maps)}
        reset_launch_counts()
        with CkptTimer() as timer:
            stats = ckpt.save_acts(steps, acts)
            torch.cuda.synchronize()
            back = ckpt.restore_acts(steps, device=device)
            torch.cuda.synchronize()
        counts = launch_counts()
        check(counts["zebra_pack"] == len(acts) and counts["zebra_unpack_kernel"] == len(acts),
              f"save_acts/restore_acts launches {counts}")
        with np.load(Path(tmp) / f"acts_{steps}.npz") as f:
            files = dict(f.items())
        for name, m in acts.items():
            check(same_bits(back[name], m), f"restore_acts {name} differs")
            stored = files[f"{name}/payload"].nbytes + files[f"{name}/index"].nbytes
            check(stats[name]["stored_bytes"] == stored, f"{name} stored bytes")
        t = timer.times
        print(f"  save_acts of {len(acts)} ffn_hidden maps {tuple(maps[0].shape)} bf16: "
              + ", ".join(f"{n} {s['stored_bytes']} of {s['dense_bytes']} B"
                          for n, s in stats.items())
              + f"; save {t['save_acts'][0] * 1e3:.1f} ms (the codec's pack on the card), "
              f"restore {t['restore_acts'][0] * 1e3:.1f} ms (the expander), each map equal "
              f"(bitwise), pack and expander {len(acts)} launches each")
        # detect.ckpt.acts_bitflip: a flipped index bit on disk
        name = next(iter(acts))
        files[f"{name}/index"] = files[f"{name}/index"].copy()
        files[f"{name}/index"][0] ^= 1
        np.savez(Path(tmp) / f"acts_{steps}.npz", **files)
        detected = 0
        try:
            ckpt.restore_acts(steps, device=device)
        except CorruptStream as e:
            detected = int(name in str(e))
            print(f"  detect.ckpt.acts_bitflip: {e}")
        check(detected == 1, "acts bitflip not detected, or not named")
        print("  detect.ckpt.acts_bitflip: injected 1, detected 1, recovered 1 "
              "(reject-named-invariant)")
        # the codec's pack and the expander on these maps, timed alone
        from repro_torch.compress import compress
        dense = [m.reshape(-1, m.shape[-1]) for m in acts.values()]
        lm = {"arch": arch, "t_obj": t_obj, "maps": [], "dense": dense,
              "comp": [compress(m, bs=BS, bc=BC) for m in dense], "launches": counts,
              "replay_launches": {}}
        print(f"save_acts / restore_acts kernel times ({len(dense)} maps):")
        rows = time_lm_kernels(lm, {"zebra_pack": 0.0}, device, gemms=(), codec=True,
                               suffix=f" ({arch} save_acts)", stream_rows={
                                   f"zebra_unpack_kernel ({arch} restore_acts)":
                                   ("zebra_unpack_kernel", "leaves")})
        del got, model, maps, acts, back, dense, lm
        torch.cuda.empty_cache()
        return rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 12: the MoE FFNs; phase 13: whisper-medium and the scanned local
# attention
# ---------------------------------------------------------------------------

# granite-moe-1b-a400m at full width and depth on stream. Its expert stacks
# are drawn with fan-in d·f (lecun_normal's default over (E, d, f)), so gate
# and up are N(0, 1/f) and the 8 x 128 block maxima of the hidden map sit
# near 0.006. A CPU draw of one full-width MoE layer on N(0, 1) rows (batch 2
# x 2048: 80 % of the 40960 slots filled) gives the filled slots' zero
# fraction 0.496 at T_obj 0.0060, 0.627 at 0.0064 and 0.781 at 0.0070
GRANITE = dict(arch="granite-moe-1b-a400m", batch=2, prompt=2048, gen=32, t_obj=0.0064)
# llama4-scout-17b-a16e at full width on fused, cut to the deepest that serves
# on one card beside a reference run of the same weights: 18 of 48 layers
# (76.9 GB of bf16 weights; src/repro_torch/launch/lm_timing.py serve: 20 ran
# out of memory, 18 peaked at 74.08 GiB, this phase at 74.77 GiB with its map
# copies). Gate and up are N(0, 1/8192), and the same CPU draw puts the
# filled slots' zero fraction at 0.35 at T_obj 0.00035 and 0.64 at 0.0004
LLAMA4 = dict(arch="llama4-scout-17b-a16e", batch=2, prompt=2048, gen=32, t_obj=0.00038,
              layers=18)
# MoE training: granite at full width and depth, batch 2 x 2048 in two
# microbatches of 1 x 2048 (capacity 640), remat block, 2 steps of AdamW
# warmup_cosine(3e-4, 1, 2), bf16 gradients, clip 1.0, at the serving T_obj
MOE_TRAIN = dict(batch=2, seq=2048, grad_accum=2, steps=2)
# whisper-medium at full width and depth (24 + 24 layers) on fused: batch 4,
# 1500 frames ~ N(0, 1) in bf16 from a torch.Generator seeded 1 on the card,
# prompt 416 + 32 greedy tokens = 448 positions, its decoder context. Its GELU
# MLP's pre-activation is N(0, d/f = 1/4), as starcoder2-15b's: the same T_obj
WHISPER = dict(arch="whisper-medium", batch=4, prompt=416, gen=32, t_obj=1.55)
WHISPER_TRAIN = dict(batch=4, seq=448, grad_accum=2, steps=2)
# the scanned local attention beside the banded one: phase 10's traffic
SCAN = dict(layers=12, batch=2, seq=2048, grad_accum=2, steps=2, t_obj=LM_T_OBJ)


def moe_cap(cfg, tokens: int) -> int:
    """The reference's capacity expression."""
    return int(max(1, round(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)))


def slot_zero_fractions(maps, t_obj) -> tuple[float, float]:
    """(zero fraction over every block, over the blocks of filled slots) of
    dispatch maps, dead as the comparator's plain version decides: an
    empty slot is a zero row, so a block of 8 empty slots has max 0 (a
    block mixing both counts as filled)."""
    from repro_torch.kernels import mask_pack
    dead = filled = dead_filled = total = 0
    for h in maps:
        h2 = h.reshape(-1, h.shape[-1])
        gone = mask_pack.bitmap_plain(h2, t_obj, BS, BC) == 0
        full = h2.reshape(-1, BS, h2.shape[1] // BC, BC).abs().amax(dim=(1, 3)) > 0
        dead += int(gone.sum())
        filled += int(full.sum())
        dead_filled += int((gone & full).sum())
        total += gone.numel()
    return dead / total, dead_filled / max(filled, 1)


def run_moe_serve(device, arch, batch, prompt, gen, t_obj, layers=0, backend="stream",
                  zf_band=None, validated=False) -> list[dict]:
    """Phase 12 (a)/(b): serve ``arch`` through ``launch.serve.main`` on
    ``backend``; launch counts per phase; the same weights on ``reference``
    give the same last logits and tokens bit for bit; the stream kernels
    (``stream``) or the masking kernel (``fused``: an MoE site hands the
    engine no weight) held bit for bit against their plain versions on the
    prefill's dispatch maps and one decode step's, and timed. Returns the
    kernel rows."""
    import torch
    from repro_torch.compress import integrity
    from repro_torch.core.engine import stream_bytes
    from repro_torch.kernels import mask_pack, reset_launch_counts
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
            "--gen", str(gen), "--t-obj", str(t_obj), "--layers", str(layers)]
    cfg = serve.build_config(arch, t_obj=t_obj, backend=backend, n_layers=layers)
    L, E, f = cfg.n_layers, cfg.n_experts, cfg.d_ff
    rows_pre, rows_dec = E * moe_cap(cfg, batch * prompt), E * moe_cap(cfg, batch)
    print(f"MoE serving: python -m repro_torch.launch.serve {' '.join(argv)} "
          f"--backend {backend}: {L} layers, {E} experts top-{cfg.top_k}, d_ff {f}; "
          f"dispatch maps ({rows_pre}, {f}) in prefill, ({rows_dec}, {f}) a decode step")
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    with FFNSiteRecorder(keep=2 * L) as rec, PhaseCounts(serve) as phases:
        out = serve.main([*argv, "--backend", backend])
    torch.cuda.synchronize()
    # keep what the checks read: a served run's caches are ~1 GB at llama4's depth
    out = {k: out[k] for k in ("model", "prompts", "meter", "tokens", "logits", "prefill_ms",
                               "decode_ms_per_token")}
    final = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    model, prompts = out["model"], out["prompts"]
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    leaves = [r for r in out["meter"].records if r.compressed]
    n_dec = gen - 1
    if backend == "stream":
        pre = {k: 3 * L for k in STREAM_KERNELS}
        dec = {k: L * n_dec for k in STREAM_KERNELS}
        dec["zebra_unpack_kernel"] += len(leaves)
    else:
        pre = {"zebra_mask_kernel": 3 * L}
        dec = {"zebra_mask_kernel": L * n_dec, "zebra_unpack_kernel": len(leaves)}
    check_launches(phases.at["prefill"], pre, f"{arch} prefill ({L} ffn_hidden + {2 * L} "
                                              f"kv_cache sites)")
    check_launches(diff_counts(phases.at["handoff"], phases.at["prefill"]),
                   {"zebra_pack": len(leaves), "zebra_unpack_kernel": 1}, f"{arch} handoff")
    check_launches(diff_counts(final, phases.at["handoff"]), dec,
                   f"{arch} decode ({L} MoE sites x {n_dec} steps)")
    shapes = [r[0] for r in rec.records]
    labels = {r[2] for r in rec.records}
    check(len(rec.records) == L * gen and rec.kv == 2 * L,
          f"{len(rec.records)} ffn_hidden and {rec.kv} kv_cache sites")
    check(shapes[:L] == [(1, rows_pre, f)] * L and shapes[L:] == [(1, rows_dec, f)] * L * n_dec,
          f"dispatch map shapes {set(shapes)}")
    check(labels == {backend}, f"MoE site backends {labels}, want {backend}")
    pre_maps, dec_maps = rec.maps[:L], rec.maps[L:]
    # the stream bytes: on stream, Eq. 2/3 of the comparator's plain bitmap
    # of each kept map (the prefill's and decode step 1's), and every site
    # of the run inside the band; fused's masking pass moves none
    if backend == "stream":
        for i, (h, r) in enumerate(zip(rec.maps, rec.records)):
            keep = mask_pack.bitmap_plain(h.reshape(-1, f), t_obj, BS, BC)
            check(int(r[4]) == int(stream_bytes(keep.sum(), BS, BC, h.dtype, keep.numel())),
                  f"dispatch map {i}: stream bytes {int(r[4])} != Eq. 2/3 of its bitmap")
        worst = check_token_band(rec.records, f"{arch} serve")
        print(f"  stream bytes: the {len(rec.maps)} kept maps' == Eq. 2/3 of their plain "
              f"bitmaps; all {len(rec.records)} sites inside the Eq. 2/3 band (worst |delta| "
              f"{worst} B)")
    else:
        check(not any(int(r[4]) for r in rec.records), "a masking-pass site moved stream bytes")
    zf_all, zf_filled = slot_zero_fractions(pre_maps, t_obj)
    zf_aux = sum(float(r[3]) for r in rec.records[:L]) / L
    print(f"  ffn_hidden (prefill): zero fraction {zf_all:.4f} over all slots "
          f"(the sites' aux: {zf_aux:.4f}), {zf_filled:.4f} over the filled slots "
          f"(T_obj {t_obj})")
    check(abs(zf_aux - zf_all) < 1e-5, "the sites' zero fraction != the maps'")
    check(zf_band is None or zf_band[0] <= zf_filled <= zf_band[1],
          f"filled-slot zero fraction {zf_filled} outside {zf_band}")
    dzf, dzf_filled = slot_zero_fractions(dec_maps, t_obj)
    print(f"  ffn_hidden (decode step 1): zero fraction {dzf:.4f}, {dzf_filled:.4f} over "
          f"the filled slots")
    print(f"  weights {weight_bytes / 1e9:.3f} GB (bf16; float32 router); "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; prefill {out['prefill_ms']:.3f} "
          f"ms, decode {out['decode_ms_per_token']:.3f} ms/token (cold)")

    def served(**kw) -> dict:
        """One more ``serve_one_shot`` of the same prompts; the caches dropped."""
        r = serve.serve_one_shot(model, prompts, gen, log=lambda *_: None, **kw)
        return {k: r[k] for k in ("tokens", "logits", "prefill_ms", "decode_ms_per_token",
                                  "ingest_recovered")}

    # the same weights on reference: logits and tokens bit for bit
    reset_launch_counts()
    ref = served(backend="reference")
    check(not any(launch_counts().values()), "the reference run launched a kernel")
    check(same_bits(ref["logits"], out["logits"]),
          f"last logits differ from reference (max abs err "
          f"{max_abs_err(ref['logits'], out['logits'])})")
    agree = int((ref["tokens"] == out["tokens"]).sum())
    check(agree == out["tokens"].numel(), f"{agree} of {out['tokens'].numel()} greedy tokens "
                                          f"== reference")
    print(f"  == reference: last logits (bitwise) and {agree} of {agree} greedy tokens")
    # warm times, the two backends in turns (backend, reference, backend)
    again = served()
    ref = served(backend="reference")
    third = served()
    check(torch.equal(again["tokens"], out["tokens"])
          and torch.equal(third["tokens"], out["tokens"]), "a later run's tokens differ")
    print(f"  warm, in turns: {backend} prefill {again['prefill_ms']:.3f} / "
          f"{third['prefill_ms']:.3f} ms, decode {again['decode_ms_per_token']:.3f} / "
          f"{third['decode_ms_per_token']:.3f} ms/token; reference prefill "
          f"{ref['prefill_ms']:.3f} ms, decode {ref['decode_ms_per_token']:.3f} ms/token (host "
          f"clock, synchronised; {backend} runs "
          f"{'3 kernel launches' if backend == 'stream' else '1 kernel launch'} a layer a "
          f"decode token, reference none)")
    del third
    if validated:
        # the validated stream on one tiny dispatch map a layer a token
        own = model.cfg
        model.cfg = own.replace(zebra_validation="checksum")
        integrity.clear_failures()
        reset_launch_counts()
        try:
            val = served()
        finally:
            model.cfg = own
        counts = launch_counts()
        check(not integrity.failures() and torch.equal(val["tokens"], out["tokens"])
              and val["ingest_recovered"] == 0, "the checksum run detected a fault or "
                                                "changed a token")
        # every site validated: 3L in prefill, L a decode step
        sites = 3 * L + L * n_dec
        check_launches(counts, {"zebra_bitmap_kernel": sites, "zebra_pack_kernel": sites,
                                "zebra_unpack_kernel": sites + 1 + len(leaves),
                                "zebra_pack": len(leaves)}, f"{arch} --validate checksum")
        print(f"  --validate checksum: tokens == off, no detection; prefill "
              f"{val['prefill_ms']:.3f} ms, decode {val['decode_ms_per_token']:.3f} ms/token")
    del out, ref, again, model, prompts
    torch.cuda.empty_cache()

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    names = STREAM_KERNELS if backend == "stream" else ("zebra_mask_kernel",)
    rows = []
    for what, maps in (("prefill", pre_maps), ("decode step", dec_maps)):
        print(f"{arch} kernel times per {what} ({len(maps)} dispatch maps):")
        rows += time_lm_stream_kernels(
            {"maps": [(h, None) for h in maps], "t_obj": t_obj, "launches": final}, flush,
            {f"{k} ({arch} {what})": (k, "ffn") for k in names})
    return rows


def run_moe_training(device, arch=GRANITE["arch"], t_obj=GRANITE["t_obj"],
                     batch=MOE_TRAIN["batch"], seq=MOE_TRAIN["seq"],
                     grad_accum=MOE_TRAIN["grad_accum"], steps=MOE_TRAIN["steps"]
                     ) -> list[dict]:
    """Phase 12 (c): granite-moe-1b-a400m trained R / B / C; returns the
    rows of kernels 1-4 per training step on C's dispatch maps of step 1."""
    import torch
    from repro_torch import configs
    L, K, n = configs.get(arch).n_layers, grad_accum, steps
    per_run = L * K * n * 2                      # forward + the recompute
    counts, maps = run_train_parity(
        device, arch, t_obj,
        {"reference": {}, "pallas": {"zebra_mask_kernel": per_run},
         "stream": {k: per_run for k in STREAM_KERNELS}}, batch, seq, grad_accum, steps,
        keep=2 * L * K)
    print(f"  B: the masking kernel {per_run} launches, C: each stream kernel {per_run} "
          f"= {L} sites x {K} microbatches x {n} steps x 2 (forward + recompute)")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    lm = {"maps": [(h, None) for h in maps], "t_obj": t_obj,
          "launches": {**counts["stream"],
                       "zebra_mask_kernel": counts["pallas"]["zebra_mask_kernel"]}}
    print(f"granite training kernel times per step ({len(maps)} dispatch maps of C's step 1, "
          f"forward and recompute):")
    return time_lm_stream_kernels(lm, flush, {
        f"{k} (granite-moe-1b-a400m training)": (k, "ffn")
        for k in ("zebra_mask_kernel", *STREAM_KERNELS)})


def whisper_frames(device, batch, seed):
    """(batch, enc_seq, d) bf16 frames ~ N(0, 1) from a generator seeded
    ``seed`` on the device (whisper-medium: 1500 x 1024)."""
    import torch
    from repro_torch import configs
    cfg = configs.get(WHISPER["arch"])
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=g,
                       device=device).to(torch.bfloat16)


def run_whisper_serve(device, edge_errs, arch=WHISPER["arch"], batch=WHISPER["batch"],
                      prompt=WHISPER["prompt"], gen=WHISPER["gen"], t_obj=WHISPER["t_obj"]
                      ) -> list[dict]:
    """Phase 13 (a): whisper-medium served on fused through
    ``launch.serve.serve_one_shot``; returns the kernel rows per prefill."""
    import torch
    from repro_torch.data import LMDatasetConfig, lm_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve, steps
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.ffn import eff_block_ch

    cfg = serve.build_config(arch, t_obj=t_obj, backend="fused")
    L, Le = cfg.n_layers, cfg.encoder_layers
    model = LM(cfg, generator=torch.Generator(device=device).manual_seed(0),
               device=device).requires_grad_(False)
    prompts = torch.from_numpy(lm_batch(LMDatasetConfig(vocab=cfg.vocab), batch, prompt, 0)
                               [:, :prompt]).to(device=device, dtype=torch.int64)
    frames = whisper_frames(device, batch, 1)
    print(f"whisper serving: {arch} at full width and depth ({Le} encoder + {L} decoder "
          f"layers) on fused, batch {batch}, {cfg.enc_seq} frames, prompt {prompt}, {gen} "
          f"tokens, T_obj {t_obj}")
    reset_launch_counts()
    with LMSiteRecorder() as rec, PhaseCounts(serve) as phases:
        out = serve.serve_one_shot(model, prompts, gen, enc_feats=frames, log=lambda *_: None)
    torch.cuda.synchronize()
    final = launch_counts()
    leaves = [r for r in out["meter"].records if r.compressed]
    check_launches(phases.at["prefill"], {"zebra_spmm_cs_kernel": L,
                                          "zebra_bitmap_kernel": L, "zebra_pack_kernel": L,
                                          "zebra_mask_kernel": 2 * L},
                   "whisper prefill (the encoder: none)")
    check_launches(diff_counts(phases.at["handoff"], phases.at["prefill"]),
                   {"zebra_pack": len(leaves), "zebra_unpack_kernel": 1}, "whisper handoff")
    check_launches(diff_counts(final, phases.at["handoff"]),
                   {"zebra_unpack_kernel": len(leaves)}, "whisper decode")
    enc_sites = [(r, b) for r, b in rec.ffn_decode if r == cfg.enc_seq]
    dec_sites = [(r, b) for r, b in rec.ffn_decode if r != cfg.enc_seq]
    check(len(rec.ffn) == L and len(enc_sites) == Le
          and set(b for _, b in enc_sites) == {"reference(degenerate-rows)"},
          f"{len(rec.ffn)} fused decoder sites; encoder sites {set(enc_sites)}")
    check(len(dec_sites) == L * (gen - 1) and len(rec.kv) == 2 * L,
          f"{len(dec_sites)} decode ffn sites, {len(rec.kv)} kv_cache sites")
    print(f"  encoder: {Le} ffn_hidden sites, all reference(degenerate-rows) ({cfg.enc_seq} "
          f"frames, no multiple of {BS}), no kernel launch; decoder: {L} fused sites")
    ffn_zf, ffn_bytes = block_weighted([a for *_, a in rec.ffn])
    print(f"  decoder ffn_hidden: zero fraction {ffn_zf}, stream bytes {ffn_bytes} of "
          f"{sum(h.numel() * h.element_size() for h, *_ in rec.ffn)} dense; prefill "
          f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms_per_token']:.3f} ms/token (cold)")
    check(0.0 < ffn_zf < 1.0, f"decoder ffn_hidden zero fraction {ffn_zf}")
    worst_y = replay_ffn_sites(rec.ffn, cfg, t_obj, eff_block_ch(cfg.d_ff, cfg))
    torch.cuda.synchronize()
    replay = launch_counts()
    print(f"  replay of {L} decoder ffn_hidden maps: bitmap, n_live, bytes and zero_frac == "
          f"reference (bitwise); zebra_spmm_cs == zebra_spmm (bitwise); y vs reference max "
          f"abs err {worst_y} ({Y_TOL})")
    ref = serve.serve_one_shot(model, prompts, gen, backend="reference", enc_feats=frames,
                               log=lambda *_: None)
    agree = int((ref["tokens"] == out["tokens"]).sum())
    print(f"  greedy tokens: {agree} of {out['tokens'].numel()} agree with reference "
          f"(recorded, not asserted: the payload GEMM sums in another order)")
    again = serve.serve_one_shot(model, prompts, gen, enc_feats=frames, log=lambda *_: None)
    print(f"  warm fused: prefill {again['prefill_ms']:.3f} ms, decode "
          f"{again['decode_ms_per_token']:.3f} ms/token; reference prefill "
          f"{ref['prefill_ms']:.3f} ms (host clock, synchronised)")
    enc_busy = profile_calls(lambda: model._encode(frames, "infer"), 2, "encoder passes",
                             "encoder pass")
    pre_busy = profile_calls(lambda: steps.prefill(model, prompts, frames), 2,
                             "whisper prefills", "prefill")
    if enc_busy is not None and pre_busy is not None:
        print(f"  the encoder: {100 * enc_busy / pre_busy:.1f} % of the prefill's device time "
              f"({enc_busy:.3f} of {pre_busy:.3f} ms)")
    lm = {"arch": arch, "t_obj": t_obj, "maps": [(h, w) for h, w, *_ in rec.ffn],
          "launches": {k: final[k] for k in (*LM_KERNELS, *KERNELS)},
          "replay_launches": {"zebra_spmm_kernel": replay["zebra_spmm_kernel"]}}
    check(bool(torch.isfinite(out["logits"]).all()), "whisper logits not finite")
    del out, ref, again, model, rec
    torch.cuda.empty_cache()
    return time_lm_kernels(lm, edge_errs, device, gemms=("zebra_spmm_cs_kernel",),
                           codec=False, stream_rows={
                               f"{k} (whisper-medium prefill)": (k, "ffn")
                               for k in ("zebra_bitmap_kernel", "zebra_pack_kernel")})


def run_whisper_training(device, t_obj=WHISPER["t_obj"], batch=WHISPER_TRAIN["batch"],
                         seq=WHISPER_TRAIN["seq"], grad_accum=WHISPER_TRAIN["grad_accum"],
                         steps=WHISPER_TRAIN["steps"]) -> None:
    """Phase 13 (b): whisper-medium trained R and C with fresh frames each
    step; C's parameters == R's, its stream kernels only at the decoder's
    sites."""
    from repro_torch import configs
    cfg = configs.get(WHISPER["arch"])
    L, Le, K, n = cfg.n_layers, cfg.encoder_layers, grad_accum, steps
    per_run = L * K * n * 2
    run_train_parity(device, WHISPER["arch"], t_obj,
                     {"reference": {}, "stream": {k: per_run for k in STREAM_KERNELS}},
                     batch, seq, grad_accum, steps,
                     enc_feats=lambda s: whisper_frames(device, batch, 100 + s),
                     other_sites={"reference(degenerate-rows)": Le * K * n * 2})
    print(f"  C: each stream kernel {per_run} launches = {L} decoder sites x {K} "
          f"microbatches x {n} steps x 2 (forward + recompute); the encoder's sites ran "
          f"reference(degenerate-rows)")


def run_scanned(device, layers=SCAN["layers"], batch=SCAN["batch"], seq=SCAN["seq"],
                grad_accum=SCAN["grad_accum"], steps=SCAN["steps"], t_obj=SCAN["t_obj"],
                reduced=False) -> None:
    """Phase 13 (c): gemma3-4b at full width cut to ``layers`` trained with
    ``local_impl="banded"`` and ``"scanned"`` (no remat, the reference
    backend): the losses and the ffn_hidden bitmaps of step 1 equal bit for
    bit, max_memory_allocated and ms per step of both."""
    import torch
    from repro_torch.kernels import mask_pack
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    base = train.build_config(LM_ARCH, reduced=reduced, t_obj=t_obj, n_layers=layers).replace(
        zebra_tnet=False, grad_accum=grad_accum, remat="none")
    n_sites = base.n_layers * grad_accum
    out = {}
    for impl in ("banded", "scanned"):
        model = LM(base.replace(local_impl=impl),
                   generator=torch.Generator(device=device).manual_seed(0), device=device)
        torch.cuda.reset_peak_memory_stats(device)
        with FFNSiteRecorder(keep=n_sites) as rec:
            _, _, hist, _ = train.train_lm(model.cfg, steps=steps, batch=batch, seq=seq,
                                           device=device, model=model, log=lambda *_: None)
        peak = torch.cuda.max_memory_allocated(device)
        bitmaps = [mask_pack.bitmap_plain(h.reshape(-1, h.shape[-1]), t_obj, BS, BC)
                   for h in rec.maps]
        out[impl] = ([m["loss"] for m in hist], [m["ms"] for m in hist], peak, bitmaps)
        print(f"  {impl}: loss {out[impl][0]}, {out[impl][1]} ms per step (host clock, "
              f"synchronised), max_memory_allocated {peak / 2 ** 30:.2f} GiB")
        del model, rec
        torch.cuda.empty_cache()
    (lb, _, _, bb), (ls, _, _, bsc) = out["banded"], out["scanned"]
    flips = sum(int((x != y).sum()) for x, y in zip(bb, bsc))
    total = sum(x.numel() for x in bb)
    check(ls == lb, f"scanned losses {ls} != banded {lb}")
    check(flips == 0, f"step-1 ffn_hidden bitmaps: {flips} of {total} blocks differ")
    print(f"  scanned == banded: losses and all {total} step-1 ffn_hidden blocks over "
          f"{len(bb)} maps (bitwise); peak {out['banded'][2] / 2 ** 30:.2f} -> "
          f"{out['scanned'][2] / 2 ** 30:.2f} GiB")


# ---------------------------------------------------------------------------
# Phase 14: the recurrent architectures, Mamba-2's SSD and Griffin's RG-LRU
# ---------------------------------------------------------------------------

# mamba2-2.7b at full width and depth (64 layers) on stream. Its one Zebra
# site is layer_out, the residual stream plus the SSD block's output, whose
# 8 x 128 block maxima sit above the ~3.2 of 1024 N(0, 1) values: a CPU draw
# of the full-width first layer (bf16, batch 1 x 2048, random weights from a
# CPU generator seeded 0) gave the zero fraction 0.48 at T_obj 4.8, 0.635 at
# 5.0 and 0.787 at 5.2
# mamba2-2.7b served at 16 of its 64 layers (phase 19's depth): it served
# at full depth until phase 21 needed the time (PERF.md, section 4)
MAMBA2 = dict(arch="mamba2-2.7b", batch=2, prompt=2048, gen=32, t_obj=5.0, layers=16)
# recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU, 8 local
# attention with window 2048) on fused. Its SwiGLU pre-activations are
# N(0, d/f = 1/3); the same CPU draw of the first layer's ffn_hidden map
# gave the zero fraction 0.43 at T_obj 1.4 and 0.544 at 1.5
RGEMMA = dict(arch="recurrentgemma-2b", batch=2, prompt=2048, gen=32, t_obj=1.5)
RGEMMA_STREAM_ROWS = {
    f"{k} (recurrentgemma-2b prefill)": (k, src)
    for k, src in (("zebra_bitmap_kernel", "ffn"), ("zebra_mask_kernel", "kv"),
                   ("zebra_pack_kernel", "ffn"))}
REC_ZF_BAND = (0.3, 0.8)
# both trained R and C at full width and depth: batch 2 x 2048 in two
# microbatches, remat block, 2 steps of AdamW warmup_cosine(3e-4, 1, 2), bf16
# gradients, clip 1.0, float32 parameters, bf16 compute, the serving T_obj
REC_TRAIN = dict(batch=2, seq=2048, grad_accum=2, steps=2)
# the depths phase 14 trains at (of 64 and 26), cut for phase 20's time:
# mamba2 a quarter of its layers, recurrentgemma four whole
# rglru/rglru/local patterns
REC_TRAIN_LAYERS = {"mamba2-2.7b": 16, "recurrentgemma-2b": 12}


def run_mamba2_serve(device, edge_errs, arch=MAMBA2["arch"], batch=MAMBA2["batch"],
                     prompt=MAMBA2["prompt"], gen=MAMBA2["gen"], t_obj=MAMBA2["t_obj"],
                     zf_band=REC_ZF_BAND, layers=MAMBA2["layers"]) -> list[dict]:
    """Phase 14 (a): mamba2-2.7b served on stream through ``launch.serve.main``:
    launch counts per phase (prefill: the three stream kernels once a
    ``layer_out`` site; the handoff: ``zebra_pack`` a cache leaf, the float32
    SSD state ``H`` among them; decode: only the expander of those leaves),
    every site's bytes equal to Eq. 2/3 of the comparator's plain bitmap and
    inside the band, every leaf lossless, the last logits and every greedy
    token equal to a ``reference`` run on the same weights bit for bit.
    Returns the kernel rows: the stream kernels per prefill, pack and the
    expander on the handoff's leaves."""
    import torch
    from repro_torch.compress import CompressedMap, decompress
    from repro_torch.compress.stream import _leaf_dims
    from repro_torch.core.engine import stream_bytes
    from repro_torch.kernels import mask_pack, reset_launch_counts
    from repro_torch.launch import serve, steps
    from repro_torch.utils import map_tree

    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
            "--gen", str(gen), "--t-obj", str(t_obj), "--backend", "stream", "--layers",
            str(layers)]
    cfg = serve.build_config(arch, t_obj=t_obj, backend="stream", n_layers=layers)
    L = cfg.n_layers
    print(f"mamba2 serving: python -m repro_torch.launch.serve {' '.join(argv)}: {L} SSD "
          f"layers, d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}; one layer_out site a layer")
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    with FFNSiteRecorder(keep=L, site="layer_out") as rec, PhaseCounts(serve) as phases:
        out = serve.main(argv)
    torch.cuda.synchronize()
    final = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    leaves = [r for r in out["meter"].records if r.compressed]
    check_launches(phases.at["prefill"], {k: L for k in STREAM_KERNELS},
                   f"{arch} prefill ({L} layer_out sites)")
    check_launches(diff_counts(phases.at["handoff"], phases.at["prefill"]),
                   {"zebra_pack": len(leaves), "zebra_unpack_kernel": 1}, f"{arch} handoff")
    check_launches(diff_counts(final, phases.at["handoff"]),
                   {"zebra_unpack_kernel": len(leaves)}, f"{arch} decode (no Zebra site)")
    # every cache leaf that divides into 8 x 128 blocks goes compressed: at
    # full width all four, H (L, B, 80, 128, 64) as (L·B·80, 8192)
    names = sorted(r.site.rsplit("/", 1)[-1] for r in leaves)
    want = sorted(n for n, leaf in out["dense_state"][0][0]["sub0"].items()
                  if _leaf_dims(leaf, BS, BC) is not None)
    check("H" in names and names == want, f"compressed handoff leaves {names}, want {want}")
    check(len(rec.records) == L and rec.kv == 0
          and {r[2] for r in rec.records} == {"stream"}
          and {r[0] for r in rec.records} == {(batch, prompt, cfg.d_model)},
          f"{len(rec.records)} layer_out sites {set(r[:3] for r in rec.records)}, "
          f"{rec.kv} kv_cache sites")
    for i, (h, r) in enumerate(zip(rec.maps, rec.records)):
        keep = mask_pack.bitmap_plain(h.reshape(-1, h.shape[-1]), t_obj, BS, BC)
        check(int(r[4]) == int(stream_bytes(keep.sum(), BS, BC, h.dtype, keep.numel())),
              f"layer_out map {i}: stream bytes {int(r[4])} != Eq. 2/3 of its bitmap")
    worst = check_token_band(rec.records, f"{arch} serve")
    zfs = [float(r[3]) for r in rec.records]
    zf = sum(zfs) / L
    print(f"  layer_out: {L} maps {rec.records[0][0]} bf16, zero fraction {zf:.4f} (layers 1-4 "
          f"{[round(z, 4) for z in zfs[:4]]}, last {zfs[-1]:.4f}) at T_obj {t_obj}; stream "
          f"bytes {sum(int(r[4]) for r in rec.records)} of "
          f"{L * math.prod(rec.records[0][0]) * 2} dense, each == Eq. 2/3 of its plain "
          f"bitmap, all inside the band (worst |delta| {worst} B)")
    check((zf_band is None or zf_band[0] <= zfs[0] <= zf_band[1]) and 0.0 < zf < 1.0,
          f"layer_out zero fraction: layer 1 {zfs[0]} outside {zf_band}, mean {zf}")
    # the handoff: every leaf lossless; the float32 SSD state's bytes
    dense, comp = [], []
    map_tree(lambda _, leaf: dense.append(leaf), out["dense_state"][0])
    map_tree(lambda _, leaf: comp.append(leaf), out["handoff_state"][0])
    pairs = [(d, c) for d, c in zip(dense, comp) if isinstance(c, CompressedMap)]
    check(len(pairs) == len(leaves) and all(same_bits(decompress(c), d) for d, c in pairs),
          "a handoff leaf did not round-trip losslessly")
    h_rec = next(r for r in leaves if r.site.endswith("/H"))
    h_leaf = next(d for d, c in pairs if d.dtype == torch.float32)
    print(f"  handoff: {len(leaves)} leaves lossless, max |measured - predicted| "
          f"{out['reconcile']['max_abs_delta_bytes']} B; H {tuple(h_leaf.shape)} float32 "
          f"as ({h_rec.spec.s}, {h_rec.spec.d}): measured {h_rec.measured_bytes} B, "
          f"predicted {h_rec.predicted_bytes} B, dense {h_rec.dense_bytes} B (zero "
          f"fraction {h_rec.zero_frac:.6f}); all leaves {out['meter'].measured_bytes()} of "
          f"{out['meter'].dense_bytes()} B")
    model, prompts = out["model"], out["prompts"]
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  weights {weight_bytes / 1e9:.3f} GB (bf16; float32 A_log, D, dt_bias, "
          f"out_norm); max_memory_allocated {peak / 2 ** 30:.2f} GiB; prefill "
          f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms_per_token']:.3f} ms/token (cold)")

    def served(**kw) -> dict:
        r = serve.serve_one_shot(model, prompts, gen, log=lambda *_: None, **kw)
        return {k: r[k] for k in ("tokens", "logits", "prefill_ms", "decode_ms_per_token")}

    reset_launch_counts()
    ref = served(backend="reference")
    check(not any(launch_counts().values()), "the reference run launched a kernel")
    check(same_bits(ref["logits"], out["logits"]),
          f"last logits differ from reference (max abs err "
          f"{max_abs_err(ref['logits'], out['logits'])})")
    agree = int((ref["tokens"] == out["tokens"]).sum())
    check(agree == out["tokens"].numel(), f"{agree} of {out['tokens'].numel()} greedy tokens "
                                          f"== reference")
    check(bool(torch.isfinite(out["logits"]).all())
          and tuple(out["logits"].shape) == (batch, cfg.vocab), "logits not finite")
    print(f"  == reference: last logits (bitwise) and {agree} of {agree} greedy tokens")
    again, ref, third = served(), served(backend="reference"), served()
    check(torch.equal(again["tokens"], out["tokens"])
          and torch.equal(third["tokens"], out["tokens"]), "a later run's tokens differ")
    print(f"  warm, in turns: stream prefill {again['prefill_ms']:.3f} / "
          f"{third['prefill_ms']:.3f} ms, decode {again['decode_ms_per_token']:.3f} / "
          f"{third['decode_ms_per_token']:.3f} ms/token; reference prefill "
          f"{ref['prefill_ms']:.3f} ms, decode {ref['decode_ms_per_token']:.3f} ms/token (host "
          f"clock, synchronised)")
    t0 = time.perf_counter()
    busy = profile_calls(lambda: steps.prefill(model, prompts), 2, "stream prefills", "prefill")
    if busy is not None:
        print(f"  stream prefill: device busy {100 * busy / again['prefill_ms']:.1f} % of an "
              f"unprofiled prefill ({busy:.3f} of {again['prefill_ms']:.3f} ms)")
    state = steps.prefill(model, prompts)[1]
    tok = out["tokens"][:, :1]
    busy = profile_calls(lambda: steps.generate(model, tok, state, prompt, 4), 1,
                         "4-token decodes", "4 tokens")
    if busy is not None:
        print(f"  decode: device busy {100 * busy / 4 / again['decode_ms_per_token']:.1f} % of "
              f"an unprofiled token ({busy / 4:.3f} of {again['decode_ms_per_token']:.3f} ms)")
    print(f"  (the profiles took {time.perf_counter() - t0:.1f} s)")
    del out, ref, again, third, model, prompts, state
    torch.cuda.empty_cache()
    lm = {"arch": arch, "t_obj": t_obj, "maps": [(h, None) for h in rec.maps],
          "dense": [d for d, _ in pairs], "comp": [c for _, c in pairs],
          "launches": final, "replay_launches": {}}
    return time_lm_kernels(
        lm, edge_errs, device, gemms=(), codec=True, suffix=f" ({arch} handoff)",
        stream_rows={**{f"{k} ({arch} prefill)": (k, "ffn") for k in STREAM_KERNELS},
                     f"zebra_unpack_kernel ({arch} handoff)": ("zebra_unpack_kernel",
                                                               "leaves")})


def run_recurrent_training(device, arch, t_obj, site, batch=REC_TRAIN["batch"],
                           seq=REC_TRAIN["seq"], grad_accum=REC_TRAIN["grad_accum"],
                           steps=REC_TRAIN["steps"], layers=None) -> list[dict]:
    """Phase 14 (c): ``arch`` trained R and C at full width through the
    harness of 10 at ``layers`` (default ``REC_TRAIN_LAYERS``; 0: its full
    depth) (C's parameters equal R's bit for bit, each stream kernel sites x
    microbatches x steps x 2 times, forward and recompute, every site on
    ``stream`` and in the band); returns the stream kernels' rows per
    training step on C's maps of step 1."""
    import torch
    from repro_torch import configs
    layers = REC_TRAIN_LAYERS.get(arch, 0) if layers is None else layers
    L, K, n = layers or configs.get(arch).n_layers, grad_accum, steps
    per_run = L * K * n * 2
    counts, maps = run_train_parity(
        device, arch, t_obj, {"reference": {}, "stream": {k: per_run for k in STREAM_KERNELS}},
        batch, seq, grad_accum, steps, layers=layers, keep=2 * L * K, site=site,
        profiled=("stream",))
    print(f"  C: each stream kernel {per_run} launches = {L} {site} sites x {K} microbatches "
          f"x {n} steps x 2 (forward + recompute)")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    t0 = time.perf_counter()
    print(f"{arch} training kernel times per step ({len(maps)} {site} maps of C's step 1, "
          f"forward and recompute):")
    rows = time_lm_stream_kernels(
        {"maps": [(h, None) for h in maps], "t_obj": t_obj, "launches": counts["stream"]},
        flush, {f"{k} ({arch} training)": (k, "ffn") for k in STREAM_KERNELS})
    print(f"  (timing took {time.perf_counter() - t0:.1f} s)")
    del maps
    torch.cuda.empty_cache()
    return rows


def run_recurrent(device, edge_errs) -> list[dict]:
    """Phase 14: mamba2-2.7b served on stream, recurrentgemma-2b served on
    fused (``run_lm``: launches, replays, tokens beside ``reference``), both
    trained R and C; returns their kernel rows."""
    import torch
    t = [time.perf_counter()]
    with torch.inference_mode():
        rows = run_mamba2_serve(device, edge_errs)
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
        lm = run_lm(device, **RGEMMA, zf_band=REC_ZF_BAND)
        rows += time_lm_kernels(lm, edge_errs, device, gemms=("zebra_spmm_cs_kernel",),
                                codec=False, stream_rows=RGEMMA_STREAM_ROWS)
        del lm
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    rows += run_recurrent_training(device, MAMBA2["arch"], MAMBA2["t_obj"], "layer_out")
    t.append(time.perf_counter())
    rows += run_recurrent_training(device, RGEMMA["arch"], RGEMMA["t_obj"], "ffn_hidden")
    t.append(time.perf_counter())
    print("phase 14 times: " + ", ".join(
        f"{what} {b - a:.1f} s" for what, a, b in zip(
            ("mamba2 serving", "recurrentgemma serving", "mamba2 training",
             "recurrentgemma training"), t, t[1:])))
    return rows


# ---------------------------------------------------------------------------
# Phase 15: continuous serving (the slotted decode, the scheduler, the paged
# compressed-KV pool and the supervised engine)
# ---------------------------------------------------------------------------

# gemma3-4b at full width on fused, through the continuous CLI (all requests
# at tick 0, a lane evicted while others wait); the ring's window 1024 is
# the cache ladder's floor, so the hot set is (4, 1024). Phase 15's trace
# is phase 21's (``continuous_trace(8, seed 0)``, prompts 80-320, 4-16
# generated, 4 slots, pages of 64, a lane evicted after 16 steps: 114
# ticks, 18 evictions, prefill buckets 64, 128 and 256), so its run is
# phase 21's one-process yardstick; it served 16 requests of 128-512 tokens
# in 8 slots, 8-32 generated, pages of 16, a lane evicted after 64 steps,
# until phase 21 needed the time. Prompts of 128-512, pages of 16 and an
# eviction after 8 steps made 286 ticks (a 512-token prompt teacher-forces
# up to 255 tokens after its 256-token prefill), 79 evictions and 66,816
# pages out a rank at 6 layers: 314 s of phase 21 over 4 ranks on one card
# (PERF.md, section 6)
SV = dict(requests=8, slots=4, prompt=320, gen=16, t_obj=LM_T_OBJ, preempt_after=16,
          page_tokens=64, one_shot=3)
# the depth phase 15 serves: one whole pattern (5 local + 1 global) of the 34
# layers, as the storm's; the smoke's time went to phase 18 (PERF.md)
SV_LAYERS = 6
# benchmarks/serve_chaos_bench.py's storm at full width and one pattern period
# (5 local + 1 global layers): 6 requests arriving one a tick, 4 slots, queue
# bound 4, a 96-tick deadline, a crash at tick 12 and 6 corrupt pages, its
# breaker; pages of 64 positions and a snapshot every 4 ticks keep the
# snapshots' page traffic affordable. The bench truncates its pages; at full
# width 15 of the first 16 pages it reaches are all dead (the window's unused
# tail), where a truncation has nothing to cut and passes unseen, so the
# storm corrupts each page's live count instead (seen at any page)
SV_STORM = dict(layers=6, requests=6, slots=4, max_cache=128, page_tokens=64,
                snapshot_every=4, deadline=96, queue_bound=4, crash_tick=12, page_faults=6,
                fault="count")
SV_BREAKER = dict(trip_after=3, window=64, probe_after=1, probe_backoff=2.0, probe_cap=8,
                  close_after=2)


class StepRecorder:
    """Records every engine step's batch bucket ``Bb`` by request (every
    step the request took part in, teacher-forced ones too) and, for every
    token a ``ServeEngine`` run generates, the logits row it was chosen
    from, the ``Bb`` and the request's step count. Wraps
    ``serve.engine.decode_slotted`` (the port's own runs, its logits taken
    from the model's ``decode_step`` inside it) and ``ServeEngine._step``;
    launches nothing. Where the lanes split over ``data``, the rows of
    every lane are gathered over ``data`` after the step, outside the
    port's traffic counters."""

    def __init__(self):
        self.bb, self.rows = {}, {}

    def __enter__(self):
        import repro_torch.serve.engine as engine
        self._engine = engine
        self._decode, self._step = engine.decode_slotted, engine.ServeEngine._step
        last = {}

        def decode(model, token, state, pos, temperature=0.0, generator=None, lanes=None):
            inner = model.decode_step

            def decode_step(*args, **kwargs):
                logits, st = inner(*args, **kwargs)
                last["logits"] = logits
                return logits, st
            model.decode_step = decode_step
            try:
                out = self._decode(model, token, state, pos, temperature, generator,
                                   lanes=lanes)
            finally:
                del model.decode_step
            if lanes is not None:               # every lane's row, as the engine's tokens
                import torch
                from repro_torch.distributed.collectives import Wire
                got = Wire(lanes).all_gather(last["logits"].float())
                last["logits"] = torch.cat(got.unbind(0), dim=0)
            return out

        def step(eng, now):
            before = [(lane, r, len(r.out)) for lane, r in enumerate(eng._lanes) if r]
            Bb = eng._Bb
            now = self._step(eng, now)
            for lane, r, n in before:
                hist = self.bb.setdefault(r.rid, [])
                hist.append(Bb)
                if len(r.out) > n:
                    self.rows.setdefault(r.rid, []).append(
                        (last["logits"][lane].clone(), Bb, len(hist)))
            return now
        engine.decode_slotted, engine.ServeEngine._step = decode, step
        return self

    def __exit__(self, *exc):
        self._engine.decode_slotted = self._decode
        self._engine.ServeEngine._step = self._step


def near_tie(label, yard, got) -> dict | None:
    """The first token where ``got`` differs from ``yard``, each a (tokens,
    logits rows) pair, under the near-tie rule: the gap between the two
    candidates' logits in the yardstick's row is no larger than the max
    |Δlogit| between the two rows at that token. Returns the divergence
    (None if the tokens agree); fails if the rule does not hold."""
    (ya, ra), (yb, rb) = yard, got
    check(len(ya) == len(yb), f"{label}: {len(ya)} vs {len(yb)} tokens")
    for t, (a, b) in enumerate(zip(ya, yb)):
        if a == b:
            continue
        row_a, row_b = ra[t].float(), rb[t].float()
        gap = float(row_a[a] - row_a[b])
        delta = float((row_a - row_b).abs().max())
        check(0.0 <= gap <= delta, f"{label}: token {t} is {b}, the yardstick's {a}, logit "
                                   f"gap {gap} > max |Δlogit| {delta}: not a near tie")
        return {"token": t, "yard": a, "got": b, "gap": gap, "delta": delta}
    return None


def hold_engine_runs(label, a_eng, a_rec, b_eng, b_rec) -> list:
    """Each request's tokens in run b against run a: bit for bit up to the
    first token whose steps ran at another ``Bb`` sequence in the two runs
    (there the logits rows must also agree bit for bit), the near-tie rule
    from there. Returns the divergences."""
    a = {r.rid: r for r in a_eng.scheduler.completed}
    b = {r.rid: r for r in b_eng.scheduler.completed}
    check(set(a) == set(b), f"{label}: the runs completed other requests")
    out, same_bb_tokens = [], 0
    for rid in sorted(a):
        ra, rb = a_rec.rows[rid], b_rec.rows[rid]
        n_same = 0
        for (la, _, na), (lb, _, nb) in zip(ra, rb):
            if na != nb or a_rec.bb[rid][:na] != b_rec.bb[rid][:nb]:
                break
            check(same_bits(la, lb), f"{label}: request {rid} token {n_same}: logits differ "
                                     f"at the same Bb sequence")
            n_same += 1
        check(a[rid].out[:n_same] == b[rid].out[:n_same],
              f"{label}: request {rid} tokens differ at the same Bb sequence")
        same_bb_tokens += n_same
        d = near_tie(f"{label} request {rid}", (a[rid].out[n_same:], [x[0] for x in ra[n_same:]]),
                     (b[rid].out[n_same:], [x[0] for x in rb[n_same:]]))
        if d is not None:
            d = dict(d, rid=rid, token=d["token"] + n_same)
            out.append(d)
            print(f"  divergence ({label}): request {rid} token {d['token']}: {d['got']} for "
                  f"{d['yard']}, logit gap {d['gap']} <= max |Δlogit| {d['delta']}")
    print(f"  {label}: {same_bb_tokens} tokens at the same Bb sequence, bit for bit (tokens "
          f"and logits); {len(out)} requests diverged, each a near tie")
    return out


def time_page_kernels(pool, lane, flush) -> tuple[dict, int]:
    """Kernels 5 and 3 on one lane's compressed pages (``pool`` holds the
    lane paged out): each page held bit for bit against its plain version
    (and the expander's output against the page that left), timed with its
    plain version, its bound and ``copy_`` of the page; summed per lane.
    Returns the rows' numbers and the count of pages."""
    import torch
    from repro_torch.compress import CompressedMap
    from repro_torch.compress.stream import nonzero_bitmap, unpack_bitmap
    from repro_torch.kernels import mask_pack, pack
    from repro_torch.kernels.schedule import slot_map
    from repro_torch.kernels.stream_timing import bound_bytes
    from repro_torch.utils import map_tree
    dense = []
    map_tree(lambda _, leaf: dense.append(leaf), lane)
    slab = pool._slabs["lane"]
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                "copy_ms": 0.0} for k in ("zebra_pack", "zebra_unpack_kernel")}
    n = 0
    for leaf, (kind, pages), pshape in zip(dense, slab.leaves, slab.page_shapes):
        if kind != "paged":
            continue
        ax = leaf.dim() - 3
        for p, c in enumerate(pages):
            if not isinstance(c, CompressedMap):
                continue
            x2 = leaf.narrow(ax, p * pool.page_tokens, pool.page_tokens).reshape(c.m, c.k)
            bs, bc, item = c.bs, c.bc, x2.element_size()
            compare_zebra_pack(x2, bs, bc, f"page {tuple(x2.shape)}")
            bitmap = nonzero_bitmap(x2, bs, bc)
            keep, slot = slot_map(bitmap)
            n_live_t = keep.sum(dtype=torch.int32)
            nm, nk = bitmap.shape
            ubitmap = unpack_bitmap(c.index, nm, nk)
            got = pack.unpack_cuda(c.payload, ubitmap, slot, bs, bc)
            want = pack.expand_payload(c.payload, keep, slot, nm, nk, bs, bc)
            torch.cuda.synchronize()
            check(same_bits(got, want) and same_bits(got, x2),
                  f"page {n}: the expander != its plain version or the page that left")
            y = torch.empty_like(x2)
            copy = time_ms(lambda: y.copy_(x2), flush, iters=3, warmup=1)
            timed = {
                "zebra_pack": (
                    lambda: mask_pack.pack_launch(x2, bitmap, slot, n_live_t, bs, bc,
                                                  "zebra_pack"),
                    lambda: mask_pack.pack_plain(x2, bitmap, slot, n_live_t, bs, bc),
                    "zebra_pack_kernel"),
                "zebra_unpack_kernel": (
                    lambda: pack.unpack_cuda(c.payload, ubitmap, slot, bs, bc),
                    lambda: pack.expand_payload(c.payload, keep, slot, nm, nk, bs, bc),
                    "zebra_unpack_kernel")}
            for k, (kern, plain, bname) in timed.items():
                r = rows[k]
                r["ms"] += time_ms(kern, flush, iters=3, warmup=1)
                r["plain_ms"] += time_ms(plain, flush, iters=3, warmup=1)
                r["copy_ms"] += copy
                r["bound_ms"] += bound_bytes(bname, c.m, c.k, bs, bc, item,
                                             int(c.n_live)) / HBM_BYTES_PER_S * 1e3
            n += 1
    print(f"  kernels 5 and 3 per lane ({n} compressed pages; CUDA events, L2 flushed):")
    for k, r in rows.items():
        print(f"    {k:20s} {r['ms']:.4f} ms ({1e3 * r['ms'] / n:.2f} µs a page)  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms  copy {r['copy_ms']:.4f} ms")
    return rows, n


def run_continuous(device, edge_errs=None, layers=0, prompt=SV["prompt"], gen=SV["gen"],
                   requests=SV["requests"], slots=SV["slots"],
                   preempt_after=SV["preempt_after"], one_shot=SV["one_shot"],
                   storm=SV_STORM, yard: dict | None = None) -> list[dict]:
    """Phase 15: continuous serving. (a) gemma3-4b (full width; ``layers``
    > 0 cuts the depth) served to an 8-request trace through ``python -m
    repro_torch.launch.serve --requests``; (b) the tokens against the run
    without preemption and against one-shot serving; (c) the supervised
    engine under the chaos storm against its clean run. Returns the kernel
    rows; fills ``yard`` with (a)'s run on the host, phase 21's one-process
    yardstick (:func:`engine_yardstick`)."""
    import torch
    from repro_torch.ft import ENGINE_TICK_SITE, BreakerConfig, Fault, FTConfig, inject
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve, steps
    from repro_torch.models.lm import LM
    from repro_torch.serve import PagedKVPool, ServeEngine, synthetic_trace
    from repro_torch.serve.bucket import pow2_floor
    t = [time.perf_counter()]
    t_obj = SV["t_obj"]
    argv = ["--arch", LM_ARCH, "--backend", "fused", "--requests", str(requests),
            "--slots", str(slots), "--prompt-len", str(prompt), "--gen", str(gen),
            "--t-obj", str(t_obj), "--validate", "structural", "--preempt-after",
            str(preempt_after), "--page-tokens", str(SV["page_tokens"]), "--layers",
            str(layers)]
    cfg = serve.build_config(LM_ARCH, t_obj=t_obj, backend="fused", validation="structural",
                             n_layers=layers)
    L = cfg.n_layers
    n_kv = 2 * sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] in ("global", "local")
                   for i in range(L))
    print(f"continuous serving: python -m repro_torch.launch.serve {' '.join(argv)} ({L} "
          f"layers, window {cfg.window})")
    with StepRecorder() as rec_a:
        reset_launch_counts()
        out = serve.main(argv)
        torch.cuda.synchronize()
        final = launch_counts()
    eng, rep, model = out["engine"], out["report"], out["model"]
    pool = eng.pool
    if yard is not None:
        yard.update(engine_yardstick(argv, eng, rep, rec_a, final))
    done = {r.rid: r for r in eng.scheduler.completed}
    check(len(done) == requests and all(r.status == "done" for r in done.values()),
          f"{len(done)} requests completed: {[(r.rid, r.status) for r in done.values()]}")
    check(rep["decode_shapes"] <= rep["decode_shape_bound"]
          and rep["prefill_shapes"] <= rep["prefill_shape_bound"],
          f"shapes: decode {rep['decode_shapes']}/{rep['decode_shape_bound']}, prefill "
          f"{rep['prefill_shapes']}/{rep['prefill_shape_bound']}")
    check(rep["evictions"] > 0, "no lane was evicted")
    # each prefill: every site validated (--validate structural), so the
    # kv_cache sites (no weight) run the checked stream, comparator + pack +
    # expander, not the masking pass; the ffn_hidden sites comparator + pack +
    # the payload GEMM. Then the codec's pack once a compressed page out, the
    # expander once a page in
    n_prefill = sum(pow2_floor(r.prompt_len) >= eng.p_lo for r in out["trace"])
    check_launches(final, {"zebra_pack": pool.n_pages_out,
                           "zebra_unpack_kernel": pool.n_pages_in + n_kv * n_prefill,
                           "zebra_spmm_cs_kernel": L * n_prefill,
                           "zebra_bitmap_kernel": (L + n_kv) * n_prefill,
                           "zebra_pack_kernel": (L + n_kv) * n_prefill},
                   f"continuous ({n_prefill} prefills of {L} ffn_hidden and {n_kv} kv_cache "
                   f"sites, {pool.n_pages_out} compressed pages out, {pool.n_pages_in} in)")
    hot = sum(x.numel() * x.element_size() for x in _tensors(eng._hot))
    print(f"  hot set ({eng._Bb}, {eng._C}): {hot} B; ladders: batch {eng.batch_ladder}, "
          f"cache {eng.cache_ladder}, prefill {eng.prefill_ladder}; {rep['steps']} ticks, "
          f"{sum(len(h) for h in rec_a.bb.values())} lane steps, {rep['evictions']} "
          f"evictions; {rep['kv_pages']} pages metered for the completed requests, every page "
          f"inside the Eq. 2/3 band (max |measured - predicted| "
          f"{rep['reconcile_max_delta_bytes']} B); {pool.n_pages_out} compressed pages out, "
          f"{pool.n_pages_in} in, {pool.bytes_out} / {pool.bytes_in} B")
    print(f"  wall {rep['wall_s']:.3f} s: {rep['tokens_per_s']:.2f} tokens/s, p50 "
          f"{rep['p50_token_ms']:.3f} ms, p95 {rep['p95_token_ms']:.3f} ms a token (host "
          f"clock)")

    # one lane paged out and back in through a pool of the engine's settings
    lane = eng._take_lane(0)
    lane_pool = PagedKVPool(page_tokens=pool.page_tokens, bs=pool.bs, bc=pool.bc,
                            validation=pool.validation)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lane_pool.page_out("lane", lane)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = lane_pool.page_in("lane")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_pages = lane_pool.n_pages_out
    check(all(same_bits(a, b) for a, b in zip(_tensors(back), _tensors(lane))),
          "a lane paged out and in differs from what left the hot set")
    lane_bytes = sum(x.numel() * x.element_size() for x in _tensors(lane))
    print(f"  one lane ({len(_tensors(lane))} leaves, {lane_bytes} B dense) paged out and "
          f"back in bit for bit: {n_pages} pages, zero fraction {lane_pool.zero_frac():.4f}, "
          f"{lane_pool.bytes_out} B on the wire; page out {(t1 - t0) * 1e3:.1f} ms "
          f"({(t1 - t0) * 1e6 / n_pages:.1f} µs a page), page in {(t2 - t1) * 1e3:.1f} ms "
          f"({(t2 - t1) * 1e6 / n_pages:.1f} µs a page) (host clock, synchronised)")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    page_rows, n_timed = time_page_kernels(lane_pool, lane, flush)
    del back, lane_pool
    t.append(time.perf_counter())

    # (b) the same trace without preemption, and the first requests alone
    with StepRecorder() as rec_b:
        eng0 = ServeEngine(model, n_slots=slots, max_cache_len=eng.cache_ladder[-1],
                           page_tokens=pool.page_tokens, validation=pool.validation)
        rep0 = eng0.run(serve.continuous_trace(requests, cfg.vocab, prompt, gen))
    check(rep0["evictions"] == 0 and rep0["n_requests"] == requests, "the run without "
          "preemption")
    div = hold_engine_runs("without preemption", eng, rec_a, eng0, rec_b)
    print(f"  without preemption: {rep0['steps']} ticks, wall {rep0['wall_s']:.3f} s; "
          f"{len(div)} divergences")
    del eng0
    one_div = []
    for r in sorted(out["trace"], key=lambda r: r.rid)[:one_shot]:
        rows = []

        def capture(tok, state, pos, model=model):
            logits, state = LM.decode_step(model, tok, state, pos)
            rows.append(logits[0].clone())
            return logits, state
        model.decode_step = capture
        try:
            prompt_t = torch.as_tensor(r.prompt, dtype=torch.int64, device=device)[None]
            res = serve.serve_one_shot(model, prompt_t, r.max_new, log=lambda *_: None)
        finally:
            del model.decode_step
        toks = res["tokens"][0].tolist()
        d = near_tie(f"one-shot request {r.rid}", (toks, [res["logits"][0]] + rows),
                     (done[r.rid].out, [x[0] for x in rec_a.rows[r.rid]]))
        agree = sum(a == b for a, b in zip(toks, done[r.rid].out))
        print(f"  one-shot request {r.rid} (prompt {r.prompt_len}, {r.max_new} tokens): "
              f"{agree} of {len(toks)} tokens == the engine's"
              + ("" if d is None else f"; divergence at token {d['token']}: {d['got']} for "
                 f"{d['yard']}, logit gap {d['gap']} <= max |Δlogit| {d['delta']}"))
        if d is not None:
            one_div.append(dict(d, rid=r.rid))
        del res
    t.append(time.perf_counter())

    # the prefill kernels on one largest-bucket prefill's maps (kernel rows)
    pb = max(eng._prefill_shapes)
    first = next(r for r in sorted(out["trace"], key=lambda r: r.rid)
                 if pow2_floor(r.prompt_len) == pb)
    with LMSiteRecorder() as rec_p:
        steps.prefill(model, torch.as_tensor(first.prompt[:pb], dtype=torch.int64,
                                             device=device)[None])
    lm = {"arch": LM_ARCH, "t_obj": t_obj, "maps": [(h, w) for h, w, *_ in rec_p.ffn],
          "kv": [x for x, *_ in rec_p.kv], "dense": [], "comp": [], "launches": final,
          "replay_launches": {}}
    suffix = f" (gemma3-4b continuous prefill {pb})"
    kv = f" (gemma3-4b continuous prefill {pb}, kv_cache)"
    rows = time_lm_kernels(lm, edge_errs or {"zebra_spmm_cs_kernel": 0.0}, device,
                           gemms=("zebra_spmm_cs_kernel",), codec=False, suffix=suffix,
                           stream_rows={
                               f"zebra_bitmap_kernel{suffix}": ("zebra_bitmap_kernel", "ffn"),
                               f"zebra_pack_kernel{suffix}": ("zebra_pack_kernel", "ffn"),
                               **{f"{k}{kv}": (k, "kv") for k in STREAM_KERNELS}})
    for k, r in page_rows.items():
        rows.append({"name": f"{k} (gemma3-4b continuous, per lane)", "route": "cuda",
                     "source": SOURCE, "replaces": {**LM_KERNELS, **KERNELS}[k],
                     "launches": final[k], **r, "bound_by": "bytes", "library_ms": None,
                     "pages_per_lane": n_timed})
    del lm, rec_p, rec_a, rec_b, done, out, eng, pool, model, lane
    torch.cuda.empty_cache()
    t.append(time.perf_counter())

    # (c) the supervised engine under the storm, against its clean run
    st = storm
    cfg6 = serve.build_config(LM_ARCH, t_obj=t_obj, backend="fused", validation="structural",
                              n_layers=st["layers"])
    model6 = LM(cfg6, generator=torch.Generator(device=device).manual_seed(0),
                device=device).requires_grad_(False)
    print(f"supervised engine at {st['layers']} layers: {st['requests']} requests arriving one "
          f"a tick into {st['slots']} slots, queue bound {st['queue_bound']}, deadline "
          f"{st['deadline']} ticks, pages of {st['page_tokens']}, a snapshot every "
          f"{st['snapshot_every']} ticks")

    def storm_run(*faults):
        e = ServeEngine(model6, n_slots=st["slots"], max_cache_len=st["max_cache"],
                        page_tokens=st["page_tokens"], validation="structural",
                        queue_bound=st["queue_bound"], breaker=BreakerConfig(**SV_BREAKER))
        trace = synthetic_trace(st["requests"], vocab=cfg6.vocab, seed=0, prompt_lo=8,
                                prompt_hi=48, gen_lo=8, gen_hi=16, arrival_every=1,
                                deadline_ticks=st["deadline"])
        with inject(*faults) as plan:
            r = e.run(trace, ft_cfg=FTConfig(max_failures=4, backoff_base_s=0.0,
                                             jitter_seed=0),
                      snapshot_every=st["snapshot_every"])
        return e, r, list(plan.injected)
    clean, crep, _ = storm_run()
    storm_eng, srep, injected = storm_run(
        Fault("crash", site=ENGINE_TICK_SITE, arg=st["crash_tick"]),
        Fault(st["fault"], site="page", times=st["page_faults"]))
    n_page = sum(s == "page" for _, s in injected)
    n_crash = sum(s == ENGINE_TICK_SITE for _, s in injected)
    page_state = srep["breakers"].get("page", {}).get("state", "closed")
    goodput = srep["n_requests"] / max(crep["n_requests"], 1)
    print(f"  clean: {crep['n_requests']} done, {crep['steps']} ticks, {crep['kv_pages']} "
          f"pages, wall {crep['wall_s']:.3f} s; storm: {len(injected)} faults injected "
          f"({n_crash} crash, {n_page} pages), {srep['pages_recovered']} pages detected and "
          f"kept dense, {srep['crash_recoveries']} crash recoveries, {srep['retries']} "
          f"re-admissions, breaker trips {srep['breaker_trips']}, probes "
          f"{srep['breaker_probes']}, {srep['pages_breaker_dense']} pages dense while open, "
          f"page breaker {page_state} at the end; goodput {goodput}; wall "
          f"{srep['wall_s']:.3f} s")
    check(len(injected) == st["page_faults"] + 1 and n_crash == 1, f"injected {injected}")
    check(srep["pages_recovered"] == n_page and srep["crash_recoveries"] == n_crash,
          "a fault was not detected exactly once")
    check(srep["breaker_trips"] >= 1 and page_state == "closed",
          f"the page breaker: {srep['breaker_trips']} trips, {page_state} at the end")
    check(goodput == 1.0 and crep["n_requests"] == st["requests"], f"goodput {goodput}")
    storm_out = {r.rid: r.out for r in storm_eng.scheduler.completed}
    clean_out = {r.rid: r.out for r in clean.scheduler.completed}
    check(storm_out == clean_out, "the storm's tokens differ from the clean run's")
    print(f"  storm tokens == clean tokens, bit for bit ({sum(map(len, storm_out.values()))} "
          f"tokens of {len(storm_out)} requests)")
    del clean, storm_eng, model6
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    print("phase 15 times: " + ", ".join(
        f"{what} {b - a:.1f} s" for what, a, b in zip(
            ("continuous run and lane pages", "parity runs", "kernel timing",
             "supervised storm"), t, t[1:])))
    print(f"phase 15 divergences: {len(div)} without preemption, {len(one_div)} against "
          f"one-shot: {div + one_div}")
    return rows


# ---------------------------------------------------------------------------
# Phase 16: the compressed collectives over 8 ranks
# ---------------------------------------------------------------------------

COLL = dict(world=8, data=2, model=4, bs=8, bc=128)
# BENCH_collectives.json's shards (benchmarks/collectives_bench.py): (n, seed)
COLL_BENCH = dict(M=256, K=1024, zero_frac=0.64, seeds={"model": (4, 7), "data": (2, 11)})
# BENCH_faults.json's ring rows (benchmarks/faults_bench.py::bench_ring):
# (row, collective, level, site, hop)
COLL_FAULTS = (("drop_hop_structural", "all_gather", "structural", "bench", 2),
               ("drop_hop_checksum", "all_gather", "checksum", "bench", 2),
               ("psum_drop_hop", "psum", "checksum", "p", 1))
# gemma3-4b's prefill activation, sequence-sharded over "model"; T_obj of
# the layer_out maps (the FFN output of a N(0, 1) input on random weights,
# std ~0.134: 0.475 kills ~0.62 of its blocks) and of the N(0, 1) K/V
COLL_G3 = dict(batch=2, seq=2048, t_obj=0.475, kv_t_obj=3.5)
COLL_GRANITE = dict(arch="granite-moe-1b-a400m", batch=8, prompt=2048, t_obj=0.0064)
COLL_ZF_BAND = (0.5, 0.8)
COLL_TIMED = 5


def coll_shards(M, K, bs, bc, zero_frac, n, seed, integer=True):
    """(n, M, K) float32 shards with ~zero_frac dead (bs, bc) blocks, by the
    collectives bench's rule (integer-valued), or the faults bench's
    (N(0, 1))."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keep = (rng.random((n, M // bs, K // bc)) > zero_frac).astype(np.float32)
    vals = (rng.integers(-8, 9, size=(n, M, K)).astype(np.float32) if integer
            else rng.normal(size=(n, M, K)).astype(np.float32))
    return vals * np.repeat(np.repeat(keep, bs, axis=1), bc, axis=2)


def collectives_rank(rank: int, out_dir: str, opts: dict) -> None:
    """One rank of phase 16: (a) the bench rows, (b) the ring faults, (c)
    gemma3-4b's layer_out and K/V exchanges, (d) granite's data-parallel
    MoE, (e) the collectives' host-clock times. Checks what one rank can
    see and saves the rest for the parent (``rank<r>.pt``)."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.compress import BandwidthMeter, integrity
    from repro_torch.compress.stream import nonzero_bitmap
    from repro_torch.core.engine import zebra_site
    from repro_torch.core.zebra import ZebraConfig
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.ctx import CommAxis, axis_of, comm_context, sharding_hints
    from repro_torch.ft import Fault, inject
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.models.lm.attention import gather_kv_shards
    from repro_torch.models.lm.ffn import FFN, ffn_apply, zebra_cfg_for

    device = torch.device(opts["device"], torch.cuda.current_device()) \
        if opts["device"] == "cuda" else torch.device("cpu")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bs, bc = COLL["bs"], COLL["bc"]
    mesh = make_host_mesh(opts["data"], opts["model"], device=device.type)
    axes = {"model": axis_of(mesh, "model"), "data": axis_of(mesh, "data")}
    world = CommAxis("world", dist.get_world_size(), dist.group.WORLD, rank)
    res = {"wire": coll.wire_name(axes["model"].group), "times": {}}

    ring = {"bench shard": {}, "gemma3-4b layer_out": {}}

    def launched(fn, on_ring=None):
        """fn's result and the launches it made (on the card), added to
        ``ring[on_ring]``'s count."""
        sync()
        before = launch_counts()
        out = fn()
        sync()
        got = {k: v for k, v in diff_counts(launch_counts(), before).items() if v}
        if on_ring is not None:
            for k, v in got.items():
                ring[on_ring][k] = ring[on_ring].get(k, 0) + v
        return out, got

    def want_counts(got, want, label):
        if on_card:          # the plain versions count nothing
            check(got == want, f"rank {rank} {label}: launches {got}, want {want}")

    def wall_ms(fn, group) -> float:
        fn()
        sync()
        dist.barrier(group)
        t0 = time.perf_counter()
        for _ in range(COLL_TIMED):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / COLL_TIMED

    def index_bytes(m, k):
        return ((m // bs) * (k // bc) + 7) // 8

    # (a) BENCH_collectives.json's rows, from the bench's seeds
    B = COLL_BENCH
    bench = {}
    for name, ax in axes.items():
        n, seed = B["seeds"][name]
        x = torch.from_numpy(coll_shards(B["M"], B["K"], bs, bc, B["zero_frac"], n, seed)
                             [ax.index]).to(device)
        wire = coll.Wire(ax)
        coll.PAYLOAD_BYTES.update(sent=0, received=0)
        (ag, l_ag), got = launched(lambda: coll.zebra_all_gather(x, ax, bs=bs, bc=bc,
                                                                 tiled=True), "bench shard")
        want_counts(got, {"zebra_pack": 1, "zebra_unpack_kernel": n - 1}, f"all_gather.{name}")
        check(coll.PAYLOAD_BYTES["received"] == int(l_ag.moved) - (n - 1) * index_bytes(
            B["M"], B["K"]), f"rank {rank}: the ring's payload bytes != moved's payload part")
        sent = coll.psum_exact_bytes(coll.PAYLOAD_BYTES["sent"], ax)
        received = coll.psum_exact_bytes(coll.PAYLOAD_BYTES["received"], ax)
        check(int(sent) == int(received), f"rank {rank}: the ring sent {int(sent)} B, "
                                          f"received {int(received)} B")
        (ps, _, l_ps), got = launched(lambda: coll.zebra_psum_stream(x, ax, bs=bs, bc=bc),
                                      "bench shard")
        want_counts(got, {"zebra_pack": 1, "zebra_unpack_kernel": 1}, f"psum_stream.{name}")
        (rs, l_rs), got = launched(lambda: coll.zebra_reduce_scatter(x, ax, bs=bs, bc=bc),
                                   "bench shard")
        want_counts(got, {"zebra_pack": 1, "zebra_unpack_kernel": 1}, f"reduce_scatter.{name}")
        check(torch.equal(ag, wire.all_gather(x).reshape(-1, B["K"])), "all_gather != dense")
        check(torch.equal(ps, wire.all_reduce(x)), "psum_stream != all_reduce")
        check(torch.equal(rs, wire.reduce_scatter(x)), "reduce_scatter != reduce_scatter_tensor")
        for op, link in (("all_gather", l_ag), ("psum_stream", l_ps), ("reduce_scatter", l_rs)):
            bench[f"{op}.{name}"] = (int(coll.psum_exact_bytes(link.moved, ax)),
                                     int(coll.psum_exact_bytes(link.dense, ax)))
        # (e) host-clock times, compressed beside dense, on this wire
        for op, comp, dense in (
                ("all_gather", lambda: coll.zebra_all_gather(x, ax, bs=bs, bc=bc),
                 lambda: wire.all_gather(x)),
                ("psum_stream", lambda: coll.zebra_psum_stream(x, ax, bs=bs, bc=bc),
                 lambda: wire.all_reduce(x)),
                ("reduce_scatter", lambda: coll.zebra_reduce_scatter(x, ax, bs=bs, bc=bc),
                 lambda: wire.reduce_scatter(x))):
            res["times"][f"{op}.{name}"] = (wall_ms(comp, ax.group), wall_ms(dense, ax.group))
    res["bench"] = bench

    # (b) the three ring faults: injected, detected, recovered by the dense retry
    ax = axes["model"]
    x = torch.from_numpy(coll_shards(B["M"], B["K"], bs, bc, B["zero_frac"], 4, 6,
                                     integer=False)[ax.index]).to(device)
    wire = coll.Wire(ax)
    dense = {"all_gather": wire.all_gather(x).reshape(-1, B["K"]),
             "psum": wire.all_reduce(x)}
    faults = {}
    for row, op, level, site, hop in COLL_FAULTS:
        def run(op=op, level=level, site=site):
            if op == "all_gather":
                return coll.zebra_all_gather(x, ax, bs=bs, bc=bc, tiled=True, validation=level,
                                             site=site)
            y, _, link = coll.zebra_psum_stream(x, ax, bs=bs, bc=bc, validation=level,
                                                site=site)
            return y, link
        integrity.clear_failures()
        y_clean, l_clean = run()
        check(not integrity.failures(), f"rank {rank} {row}: a clean ring detected "
                                        f"{integrity.failures()}")
        with inject(Fault("drop_hop", site=f"ring:{site}", arg=hop)) as plan:
            (y, link), got = launched(run, "bench shard")
        want_counts(got, {"zebra_pack": 1,
                          "zebra_unpack_kernel": 3 if op == "all_gather" else 1}, row)
        detected = len(integrity.failures())
        check(len(plan.injected) == 1 and detected == 1,
              f"rank {rank} {row}: injected {plan.injected}, detected {detected}")
        check(torch.equal(y, dense[op]), f"rank {rank} {row}: the retry != the dense result")
        check(int(link.moved) == int(l_clean.moved) + int(link.dense),
              f"rank {rank} {row}: the retry's bytes are not on the link")
        if op == "all_gather":
            check(torch.equal(y, y_clean), f"rank {rank} {row}: output != the clean run's")
        faults[row] = (len(plan.injected), detected, 1)
    res["faults"] = faults

    # (c) gemma3-4b at full width: the layer_out exchange and the K/V gather
    G = COLL_G3
    g3 = configs.reduced("gemma3-4b") if opts["reduced"] else configs.get("gemma3-4b")
    cfg = g3.replace(param_dtype="bfloat16", zebra_backend="stream", zebra_sites=("layer_out",),
                     zebra_t_obj=G["t_obj"], zebra_tnet=False)
    n, m = ax.size, ax.index
    S = opts["seq"] // n
    d, hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(100 + axes["data"].index)
    x_full = torch.randn(G["batch"], opts["seq"], d, generator=gen, device=device)
    k_full, v_full = (torch.randn(G["batch"], opts["seq"], hkv, hd, generator=gen,
                                  device=device) for _ in range(2))
    x, k, v = (t[:, m * S:(m + 1) * S].to(torch.bfloat16).contiguous()
               for t in (x_full, k_full, v_full))
    ffn = FFN(cfg, generator=torch.Generator(device=device).manual_seed(0),
              dtype=torch.bfloat16, device=device).requires_grad_(False)
    meter = BandwidthMeter()
    with torch.inference_mode():
        y_local, _ = ffn_apply(ffn, x, cfg, "infer")
        zc = zebra_cfg_for(cfg, "infer").replace(use_tnet=False)
        masked, site = zebra_site(y_local, zc, site="layer_out")
        with comm_context("model", mesh=mesh):
            (y_full, aux), got = launched(lambda: ffn_apply(ffn, x, cfg, "infer"),
                                          "gemma3-4b layer_out")
        want_counts(got, {"zebra_bitmap_kernel": 1, "zebra_pack_kernel": 1, "zebra_pack": 1,
                          "zebra_unpack_kernel": n}, "layer_out exchange")
        zc_kv = ZebraConfig(enabled=True, t_obj=G["kv_t_obj"], mode="infer", backend="stream",
                            use_tnet=False)
        with comm_context("model", mesh=mesh):
            (kf, vf, kv_aux), got = launched(lambda: gather_kv_shards(k, v, zc_kv),
                                             "gemma3-4b layer_out")
        want_counts(got, {"zebra_bitmap_kernel": 2, "zebra_pack_kernel": 2, "zebra_pack": 2,
                          "zebra_unpack_kernel": 2 * n}, "kv gather")
        exch = {}
        for label, got_full, shard, a, D in (
                ("layer_out", y_full, masked, aux, d),
                ("k", kf, zebra_site(k.reshape(G["batch"], S, -1), zc_kv, site="kv_cache")[0],
                 kv_aux[0], hkv * hd),
                ("v", vf, zebra_site(v.reshape(G["batch"], S, -1), zc_kv, site="kv_cache")[0],
                 kv_aux[1], hkv * hd)):
            gathered = wire.all_gather(shard.reshape(G["batch"], S, D))
            want = gathered.transpose(0, 1).reshape(got_full.shape)
            check(same_bits(got_full, want), f"rank {rank} {label}: the gathered map != a dense "
                                             f"gather of the masked shards")
            lives = [int(nonzero_bitmap(gathered[s].reshape(-1, D), bs, bc).sum())
                     for s in range(n)]
            nb = (G["batch"] * S // bs) * (D // bc)
            others = sum(lv for s, lv in enumerate(lives) if s != m)
            pred = others * bs * bc * 2 + (n - 1) * ((nb + 7) // 8)
            check(int(a.ici_bytes) == pred, f"rank {rank} {label}: moved {int(a.ici_bytes)} B "
                                            f"!= Eq. 2/3 {pred} B")
            r = meter.record_link(label, "model", m=G["batch"] * S, k=D, bs=bs, bc=bc,
                                  dtype_bits=16, n_live=others, n_maps=n - 1)
            check(r.measured_bytes == int(a.ici_bytes) and r.dense_bytes ==
                  int(a.ici_dense_bytes), f"rank {rank} {label}: the link record != the aux")
            exch[label] = {"moved": int(a.ici_bytes), "dense": int(a.ici_dense_bytes),
                           "zero_frac": [1 - lv / nb for lv in lives], "label": a.backend}
        rec = meter.reconcile()
        res["exchange"] = exch
        res["reconcile"] = rec["max_abs_delta_bytes"]
        res["exchange_aux"] = {"label": aux.backend, "measured": int(aux.measured_bytes),
                               "site_measured": int(site.measured_bytes)}
        del ffn, x_full, k_full, v_full, y_full, kf, vf

    # (d) granite-moe-1b-a400m at full width and depth under the "dp" profile
    R = COLL_GRANITE
    gcfg = serve.build_config(R["arch"], reduced=opts["reduced"], t_obj=opts["granite_t_obj"],
                              backend="stream").replace(sharding_profile="dp")
    model = LM(gcfg, generator=torch.Generator(device=device).manual_seed(0),
               device=device).requires_grad_(False)
    tokens = torch.randint(gcfg.vocab, (R["batch"], opts["prompt"]), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    row = tokens[rank:rank + 1]
    with torch.inference_mode():
        with FFNSiteRecorder() as rec_dp, sharding_hints(mesh, dp=("data", "model")):
            (logits_dp, aux_dp), got = launched(lambda: model(row, "infer"))
        n_sites = gcfg.n_layers
        want_counts(got, {k: n_sites for k in STREAM_KERNELS}, "dp forward")
        with FFNSiteRecorder() as rec_1:
            logits_1, aux_1 = model(row, "infer")
        check(same_bits(logits_dp, logits_1), f"rank {rank}: dp logits != the single-process "
                                              f"forward of its row")
        b_dp = [int(r_[4]) for r_ in rec_dp.records]
        b_1 = [int(r_[4]) for r_ in rec_1.records]
        check(b_dp == b_1 and len(b_1) == n_sites, f"rank {rank}: site bytes {b_dp} != {b_1}")
        check(all(r_[2] == "stream" for r_ in rec_dp.records), "a dp site left stream")
        total = int(coll.psum_exact_bytes(aux_1.measured_bytes, world))
        check(aux_dp.measured_bytes_exact() == total,
              f"rank {rank}: dp bytes {aux_dp.measured_bytes_exact()} != the ranks' sum {total}")
        res["dp"] = {"bytes": aux_dp.measured_bytes_exact(), "rank_bytes":
                     aux_1.measured_bytes_exact(), "zero_frac": float(aux_dp.zero_frac),
                     "rank_zero_frac": float(aux_1.zero_frac), "launches": got,
                     "finite": bool(torch.isfinite(logits_dp).all())}
        del model, logits_dp, logits_1
    res["ring_launches"] = ring
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def time_ring_kernels(device, launches: dict) -> list[dict]:
    """Kernels 5 and 3 on the ring's shapes, one process: the bench's
    model-axis shard 0 ((256, 1024) float32) and a map shaped as one rank's
    gemma3-4b layer_out shard ((1024, 2560) bf16 N(0, 1) masked at T_obj
    3.5: ~0.6 of its blocks dead). Each kernel is held bit for bit against
    its plain version and timed with CUDA events, L2 flushed, beside the
    plain version, its byte bound and ``copy_`` of the map. ``launches``:
    rank 0's launches of each on the ring path of that map's part."""
    import torch
    from repro_torch.compress.stream import nonzero_bitmap
    from repro_torch.kernels import mask_pack, pack
    from repro_torch.kernels.schedule import slot_map
    from repro_torch.kernels.stream_timing import bound_bytes
    bs, bc = COLL["bs"], COLL["bc"]
    B = COLL_BENCH
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    gen = torch.Generator(device=device).manual_seed(3)
    g3 = torch.randn(1024, 2560, generator=gen, device=device).to(torch.bfloat16)
    keep = mask_pack.bitmap_plain(g3, COLL_G3["kv_t_obj"], bs, bc).bool()
    g3 = torch.where(keep.repeat_interleave(bs, 0).repeat_interleave(bc, 1), g3,
                     torch.zeros((), dtype=g3.dtype, device=device))
    maps = {"bench shard": torch.from_numpy(coll_shards(B["M"], B["K"], bs, bc, B["zero_frac"],
                                                       4, 7)[0]).to(device),
            "gemma3-4b layer_out": g3}
    rows = []
    for what, x in maps.items():
        bitmap = nonzero_bitmap(x, bs, bc)
        keep, slot = slot_map(bitmap)
        n_live = keep.sum(dtype=torch.int32)
        nm, nk = bitmap.shape
        payload = mask_pack.pack_launch(x, bitmap, slot, n_live, bs, bc, "zebra_pack")
        plain_payload = mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc)
        dense = pack.unpack_cuda(payload, bitmap, slot, bs, bc)
        plain_dense = pack.expand_payload(payload, keep, slot, nm, nk, bs, bc)
        torch.cuda.synchronize()
        check(same_bits(payload, plain_payload), f"ring {what}: pack != its plain version")
        check(same_bits(dense, plain_dense) and torch.equal(dense, x),
              f"ring {what}: unpack != its plain version or the map")
        y = torch.empty_like(x)
        copy = time_ms(lambda: y.copy_(x), flush)
        item, live = x.element_size(), int(n_live)
        for name, kern, plain, bname, src in (
                ("zebra_pack", lambda: mask_pack.pack_launch(x, bitmap, slot, n_live, bs, bc,
                                                             "zebra_pack"),
                 lambda: mask_pack.pack_plain(x, bitmap, slot, n_live, bs, bc),
                 "zebra_pack_kernel", LM_KERNELS["zebra_pack"]),
                ("zebra_unpack_kernel", lambda: pack.unpack_cuda(payload, bitmap, slot, bs, bc),
                 lambda: pack.expand_payload(payload, keep, slot, nm, nk, bs, bc),
                 "zebra_unpack_kernel", KERNELS["zebra_unpack_kernel"])):
            rows.append({"name": f"{name} (collectives ring, {what})", "route": "cuda",
                         "source": SOURCE, "replaces": src,
                         "launches": launches[what].get(name, 0), "max_abs_err": 0.0,
                         "ms": time_ms(kern, flush), "plain_ms": time_ms(plain, flush),
                         "bound_ms": bound_bytes(bname, *x.shape, bs, bc, item, live)
                         / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
                         "copy_ms": copy, "map": f"{tuple(x.shape)} {x.dtype}",
                         "zero_frac": 1 - live / bitmap.numel()})
    print("  kernels 5 and 3 on the ring's maps (CUDA events, L2 flushed, one process):")
    for r in rows:
        print(f"    {r['name']:58s} {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms  copy {r['copy_ms']:.4f} ms  ({r['map']}, zero_frac "
              f"{r['zero_frac']:.4f}, {r['launches']} launches a rank)")
    return rows


def run_collectives(device, *, reduced=False, seq=COLL_G3["seq"],
                    prompt=COLL_GRANITE["prompt"], granite_t_obj=COLL_GRANITE["t_obj"]
                    ) -> list[dict]:
    """Phase 16: 8 ranks on a (data 2, model 4) mesh (the reference bench's)
    run :func:`collectives_rank`; the parent holds the ranks' results
    together, then times kernels 5 and 3 on the ring's maps. ``reduced``
    (with ``device`` the CPU) rehearses the flow at the reduced configs."""
    import shutil

    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import backend_for, spawn
    world = COLL["world"]
    out = ROOT / "build" / "collectives"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    if device.type == "cuda":
        build.load_library()         # built once here: the ranks only load it
    opts = dict(device=device.type, data=COLL["data"], model=COLL["model"], reduced=reduced,
                seq=seq, prompt=prompt, granite_t_obj=granite_t_obj)
    print(f"collectives: {world} ranks, mesh (data {COLL['data']}, model {COLL['model']}), "
          f"process group {backend_for(device, world)} on {device.type} "
          f"({torch.cuda.device_count() if device.type == 'cuda' else 0} card(s))")
    t0 = time.perf_counter()
    try:
        spawn(collectives_rank, world, (str(out), opts), device=device.type)
    except Exception as e:     # a rank that raised: its traceback is in e
        raise SmokeFailure(f"phase 16: a rank failed:\n{e}") from None
    res = [torch.load(out / f"rank{r}.pt") for r in range(world)]
    t1 = time.perf_counter()
    print(f"  the ranks ran in {t1 - t0:.1f} s (start-up included); wire: {res[0]['wire']}")
    # (a) the bench rows
    rows = {r["name"]: r for r in json.loads((ROOT / "BENCH_collectives.json").read_text())
            ["rows"]}
    for key in res[0]["bench"]:
        op, axis = key.split(".")
        comp, dense = rows[f"collectives/{op}.{axis}.compressed"], \
            rows[f"collectives/{op}.{axis}.dense"]
        for r in res:
            moved, dn = r["bench"][key]
            check(moved == comp["ici_bytes"] and dn == comp["ici_dense_bytes"] ==
                  dense["ici_bytes"], f"{key}: {moved} / {dn} B != BENCH_collectives.json's "
                                      f"{comp['ici_bytes']} / {comp['ici_dense_bytes']} B")
        ms_c, ms_d = res[0]["times"][key]
        print(f"  (a) {key:22s} ici_bytes {moved:>9d} of {dn:>9d} dense == BENCH_collectives."
              f"json on every rank; equal to the dense collective; host clock {ms_c:.3f} ms "
              f"compressed vs {ms_d:.3f} ms dense ({res[0]['wire']}, rank 0)")
    # (b) the fault rows
    faults = {r["name"]: r for r in json.loads((ROOT / "BENCH_faults.json").read_text())
              ["rows"]}
    for row in res[0]["faults"]:
        rec = faults[f"faults/detect.ring.{row}"]
        for r in res:
            check(r["faults"][row] == (rec["injected"], rec["detected"], rec["recovered"]),
                  f"{row}: {r['faults'][row]} != the record's")
        print(f"  (b) detect.ring.{row}: injected 1, detected 1, recovered 1 (dense retry) "
              f"on each of the {world} ranks, as BENCH_faults.json")
    # (c) the exchanges
    for label in ("layer_out", "k", "v"):
        zfs = [z for r in res for z in r["exchange"][label]["zero_frac"]]
        moved = sum(r["exchange"][label]["moved"] for r in res)
        dense = sum(r["exchange"][label]["dense"] for r in res)
        print(f"  (c) gemma3-4b {label}: {res[0]['exchange'][label]['label']}, moved {moved} "
              f"of {dense} B dense over the {world} inbound links (Eq. 2/3 exact, reconciled),"
              f" exchanged maps' zero fraction {min(zfs):.4f}-{max(zfs):.4f}, gathered == "
              f"dense gather of the masked shards bit for bit")
        if label == "layer_out" and not reduced:
            check(all(COLL_ZF_BAND[0] <= z <= COLL_ZF_BAND[1] for z in zfs),
                  f"layer_out zero fractions {min(zfs)}-{max(zfs)} outside {COLL_ZF_BAND}")
    # (d) granite
    dp = [r["dp"] for r in res]
    total = sum(x["rank_bytes"] for x in dp)
    check(all(x["bytes"] == total for x in dp), "dp bytes != the sum over the ranks")
    check(all(x["finite"] for x in dp), "dp logits not finite")
    print(f"  (d) {COLL_GRANITE['arch']} dp, {COLL_GRANITE['batch']} x {prompt} tokens one row "
          f"a rank: logits and site bytes of every rank == its single-process forward bit for "
          f"bit; bytes {total} == the ranks' sum; zero fraction {dp[0]['zero_frac']:.4f} "
          f"(rank 0 alone {dp[0]['rank_zero_frac']:.4f}); launches a rank {dp[0]['launches']}")
    shutil.rmtree(out, ignore_errors=True)
    if device.type != "cuda":
        return []
    rows = time_ring_kernels(device, res[0]["ring_launches"])
    print(f"  phase 16 times: ranks {t1 - t0:.1f} s, kernel timing "
          f"{time.perf_counter() - t1:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 17: tensor-parallel serving (--model-parallel)
# ---------------------------------------------------------------------------

# gemma3-4b served at 6 of its 34 layers (one whole local/global pattern):
# phase 18 took the time its full depth took, phase 21's (data 2, model 2)
# job the time its second pattern took (PERF.md)
TP = dict(model=4, batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, g3_layers=6,
          g3_rules={"ffn_hidden": "blocks", "kv_cache": "gather"},
          sc2_rules={"ffn_hidden": "blocks", "kv_cache": "blocks"})
# the second, shorter run (8 of 40 layers, 8 tokens): the yardstick is its
# own single-process run at this depth. Both serve nonzero biases (zero at
# init, as in the reference, which would hide a b_down added on every rank
# or a QKV bias cut wrongly): every bias leaf drawn N(0, bias_std) from
# numpy's bias_seed and loaded over the seed-0 weights with --params
TP_SC2 = dict(arch="starcoder2-15b", layers=8, t_obj=SC2["t_obj"], sc2_gen=8,
              bias_std=0.25, bias_seed=1)
TP_BIASES = ("bq", "bk", "bv", "b_up", "b_down", "bias")
# max |Δlogit| of the tensor-parallel prefill against the single-process one
# (bf16 compute; the row-parallel sums add in another order), written in
# PERF.md before the phase first ran
TP_LOGIT_BOUND = 1.5
TP_ZF_TOL = 1e-3             # per site kind, against the single-process run
TP_ROWS = {"zebra_bitmap_kernel (gemma3-4b tensor-parallel prefill, a rank)":
           ("zebra_bitmap_kernel", "ffn"),
           "zebra_pack_kernel (gemma3-4b tensor-parallel prefill, a rank)":
           ("zebra_pack_kernel", "ffn"),
           "zebra_mask_kernel (gemma3-4b tensor-parallel prefill, a rank)":
           ("zebra_mask_kernel", "kv")}


def tp_yardstick(lm: dict, model: int = TP["model"]) -> dict:
    """Host copies of phase 7's single-process run that phase 17 holds the
    tensor-parallel run against: its tokens, the logits of every token,
    the handoff's records, each site's zero fraction and keep flags; and
    the maps a tensor-parallel rank's kernels take: rank 0's d_ff columns
    of every ffn_hidden map with its rows of w_down, and the whole
    kv_cache maps (the K/V sites gather them)."""
    from repro_torch.kernels import mask_pack, zebra_mask
    t = lm["t_obj"]
    ffn_keep, shards, kv_keep, kv = [], [], [], []
    for h, w in lm["maps"]:
        x2 = h.reshape(-1, h.shape[-1])
        ffn_keep.append(mask_pack.bitmap_plain(x2, t, BS, BC).cpu())
        f = x2.shape[1] // model
        shards.append((x2[:, :f].contiguous().cpu(), w[:f].contiguous().cpu()))
    for x in lm["kv"]:
        x2 = x.reshape(-1, x.shape[-1])
        bs = BS if x.shape[-2] % BS == 0 else 1
        bc = BC if x2.shape[1] % BC == 0 else x2.shape[1]
        kv_keep.append(zebra_mask.mask_plain(x2, t, bs, bc)[1].cpu())
        kv.append(x2.cpu())
    return {k: lm[k] for k in ("arch", "t_obj", "tokens", "logits", "step_logits", "records",
                               "ffn_zf", "kv_zf")} | {
        "ffn_keep": ffn_keep, "kv_keep": kv_keep, "ffn_shards": shards, "kv": kv,
        "prefill_ms": lm["warm_ms"][0], "decode_ms": lm["warm_ms"][1]}


def tp_argv(tp: dict, arch: str, layers: int, t_obj: float) -> list:
    return ["--arch", arch, "--backend", "fused", "--batch", str(tp["batch"]),
            "--prompt-len", str(tp["prompt"]), "--gen", str(tp["gen"]), "--t-obj", str(t_obj),
            "--layers", str(layers), *(["--reduced", "--device", "cpu"] if tp.get("reduced")
                                        else []),
            *(["--params", tp["params"]] if tp.get("params") else [])]


def tp_biases(tp: dict, arch: str, layers: int, path: str) -> int:
    """Write to ``path`` every bias of ``arch`` at ``layers`` (whole, as
    ``serve --params`` loads them) drawn N(0, bias_std) from numpy's
    ``bias_seed``; returns how many values."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    cfg = serve.build_config(arch, reduced=bool(tp.get("reduced")), n_layers=layers)
    rng = np.random.default_rng(tp["bias_seed"])
    sd = {n: torch.from_numpy(rng.normal(0.0, tp["bias_std"], tuple(p.shape)).astype(np.float32))
          for n, p in LM(cfg, device="meta").named_parameters()
          if n.rsplit(".", 1)[-1] in TP_BIASES}
    check(any(n.endswith("b_down") for n in sd) and any(n.endswith("bq") for n in sd),
          f"{arch}: no b_down or bq to draw")
    torch.save(sd, path)
    return sum(t.numel() for t in sd.values())


def single_yardstick(tp: dict, arch, layers, t_obj) -> dict:
    """A single-process served run of ``arch`` (``layers`` deep) through
    ``serve.main``: the host copies :func:`tp_yardstick` keeps, without the
    maps."""
    import torch
    from repro_torch.launch import serve
    argv = tp_argv(tp, arch, layers, t_obj)
    with LMSiteRecorder() as rec, PhaseCounts(serve) as phases, yard_sums():
        out = serve.main(argv)
    from repro_torch.kernels import mask_pack
    yard = {"arch": arch, "t_obj": t_obj, "tokens": out["tokens"].cpu(),
            "logits": out["logits"].float().cpu(),
            "step_logits": torch.stack([out["logits"].float().cpu()]
                                       + [x.float().cpu() for x in phases.logits]),
            "records": [(r.site, r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live)
                        for r in out["meter"].records],
            "ffn_zf": [float(a.zero_frac) for *_, a in rec.ffn],
            "kv_zf": [float(a.zero_frac) for *_, a in rec.kv],
            "ffn_keep": [mask_pack.bitmap_plain(h.reshape(-1, h.shape[-1]), t_obj, BS,
                                                BC).cpu() for h, *_ in rec.ffn],
            "kv_keep": [mask_pack.bitmap_plain(x.reshape(-1, x.shape[-1]), t_obj, BS,
                                               BC).cpu() for x, *_ in rec.kv],
            "prefill_ms": out["prefill_ms"], "decode_ms": out["decode_ms_per_token"]}
    del out, rec, phases
    torch.cuda.empty_cache()
    return yard


def hold_tp_run(label: str, ranks: list, yard: dict, rules: dict, n_layers: int,
                n_kv: int, tp: dict) -> None:
    """One tensor-parallel served run (its ranks' reports) against its
    single-process yardstick: the ranks agree bit for bit; the sites ran by
    ``rules``, every stream site and handoff leaf inside the Eq. 2/3 band;
    the zero fraction per site kind within TP_ZF_TOL of the yardstick's
    (the blocks that differ counted); the prefill logits within
    TP_LOGIT_BOUND; the tokens equal but for near ties; each rank's
    launches per phase. Prints times, memory and the collectives."""
    import torch
    r0 = ranks[0]
    check(sorted(r["model_index"] for r in ranks) == list(range(tp["model"]))
          and all(r["data_index"] == 0 for r in ranks), f"{label}: mesh coordinates")
    check(all(same_bits(r["logits"], r0["logits"]) and torch.equal(r["tokens"], r0["tokens"])
              for r in ranks), f"{label}: the ranks' logits or tokens differ")
    sites = r0["sites"]
    for kind, rule in rules.items():
        got = {(s["rule"], s["backend"]) for s in sites if s["site"] == kind}
        check(got == {(rule, "fused")}, f"{label}: {kind} sites ran {got}, want {rule}")
    ffn = [s for s in sites if s["site"] == "ffn_hidden"]
    kv = [s for s in sites if s["site"] == "kv_cache"]
    check(len(ffn) == n_layers and len(kv) == n_kv, f"{label}: {len(ffn)} ffn_hidden and "
                                                    f"{len(kv)} kv_cache sites")
    for r in ranks[1:]:
        check([{k: v for k, v in s.items() if k != "keep"} for s in r["sites"]] ==
              [{k: v for k, v in s.items() if k != "keep"} for s in sites],
              f"{label}: rank {r['rank']}'s sites differ from rank 0's")
    band = check_token_band([((s["rows"], s["width"]), 2, None, s["zero_frac"],
                              s["measured_bytes"]) for s in ffn], f"{label} ffn_hidden")
    check(all(s["measured_bytes"] == 0 for s in kv), f"{label}: a masking-pass kv site "
                                                     f"reported stream bytes")
    leaves = [x for x in r0["records"] if x["n_blocks"]]
    worst_leaf = max(x["payload_bytes"] + x["index_bytes"] - x["predicted"] for x in leaves)
    check(all(0 <= x["payload_bytes"] + x["index_bytes"] - x["predicted"] < 1 for x in leaves)
          and r0["reconcile"]["n_sites"] == len(leaves) > 0,
          f"{label}: a handoff leaf outside the Eq. 2/3 band")
    # against the single-process run
    for kind, got, zf_yard, keep_yard in (("ffn_hidden", ffn, yard["ffn_zf"], yard["ffn_keep"]),
                                          ("kv_cache", kv, yard["kv_zf"], yard["kv_keep"])):
        nb = [s["n_total"] for s in got]
        zf_tp = sum(s["zero_frac"] * n for s, n in zip(got, nb)) / sum(nb)
        zf_1 = sum(z * n for z, n in zip(zf_yard, nb)) / sum(nb)
        flips = sum(int((s["keep"] != k).sum()) for s, k in zip(got, keep_yard))
        print(f"  {label} {kind}: {len(got)} sites ({got[0]['rule']}), zero fraction "
              f"{zf_tp:.6f} vs {zf_1:.6f} in one process; {flips} of {sum(nb)} blocks differ")
        check(abs(zf_tp - zf_1) <= TP_ZF_TOL, f"{label} {kind}: zero fraction {zf_tp} vs "
                                              f"{zf_1} beyond {TP_ZF_TOL}")
    moved = sum(x["payload_bytes"] + x["index_bytes"] for x in r0["records"])
    moved_1 = sum(p + i for _, p, i, *_ in yard["records"])
    print(f"  {label} handoff: {len(leaves)} compressed leaves, {moved} B (one process "
          f"{moved_1} B), every leaf in the Eq. 2/3 band (worst {worst_leaf:.3f} B); stream "
          f"sites in the band (worst {band:.3f} B)")
    err = float((r0["logits"] - yard["logits"]).abs().max())
    print(f"  {label} prefill logits: max |Δ| {err} against one process (bound "
          f"{TP_LOGIT_BOUND}, max |logit| {float(yard['logits'].abs().max())})")
    check(err <= TP_LOGIT_BOUND, f"{label}: prefill logits {err} off one process's")
    for b in range(r0["tokens"].shape[0]):
        d = near_tie(f"{label} lane {b}",
                     (yard["tokens"][b].tolist(), yard["step_logits"][:, b]),
                     (r0["tokens"][b].tolist(), r0["step_logits"][:, b]))
        print(f"  {label} lane {b}: tokens "
              + ("equal to one process's" if d is None else
                 f"part at token {d['token']} ({d['got']} for {d['yard']}), a near tie: "
                 f"gap {d['gap']} <= max |Δlogit| {d['delta']}"))
    # launches and collectives, per rank
    n_leaves = len(leaves)
    want = {"prefill": {"zebra_bitmap_kernel": n_layers, "zebra_pack_kernel": n_layers,
                        "zebra_spmm_cs_kernel": n_layers, "zebra_mask_kernel": n_kv},
            "handoff": {"zebra_pack": n_leaves, "zebra_unpack_kernel": 1},
            "decode": {"zebra_unpack_kernel": n_leaves}}
    for r in ranks if not tp.get("reduced") else ():   # the CPU's plain versions count nothing
        for phase, counts in want.items():
            got = {k: v for k, v in r["phases"][phase].items()
                   if not k.startswith(("tp_", "dp_"))}
            if r is r0:
                check_launches(got, counts, f"{label} rank 0 {phase}")
            else:
                check(all(got[k] == counts.get(k, 0) for k in got),
                      f"{label} rank {r['rank']} {phase}: {got}")
    ph = r0["phases"]
    steps_ = tp["gen"] - 1
    print(f"  {label}: prefill {r0['prefill_ms']:.3f} ms (one process {yard['prefill_ms']:.3f}),"
          f" decode {r0['decode_ms_per_token']:.3f} ms a token (one process "
          f"{yard['decode_ms']:.3f}); host clock, rank 0, {r0['wire']}")
    print(f"  {label}: max_memory_allocated by rank "
          f"{[round(r['max_memory_allocated'] / 2 ** 30, 3) for r in ranks]} GiB serving, "
          f"{[round(r['build_peak_memory'] / 2 ** 30, 3) for r in ranks]} GiB building "
          f"(drawn straight into the shards)")
    print(f"  {label}: rank 0's stages: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in r0["stage_s"].items()))
    print(f"  {label}: tensor-parallel collectives a rank: prefill {ph['prefill']['tp_calls']} "
          f"calls, {ph['prefill']['tp_bytes']} B handed in; handoff "
          f"{ph['handoff']['tp_calls']} calls, {ph['handoff']['tp_bytes']} B; decode "
          f"{ph['decode']['tp_calls'] / steps_:.1f} calls, {ph['decode']['tp_bytes'] / steps_:.0f}"
          f" B a token")


def tp_serve(tp: dict, arch, layers, t_obj) -> list:
    """``python -m repro_torch.launch.serve --model-parallel 4`` from this
    process (it spawns the ranks); returns the ranks' reports."""
    from repro_torch.launch import serve
    argv = [*tp_argv(tp, arch, layers, t_obj), "--model-parallel", str(tp["model"]),
            "--record"]
    print(f"  python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    try:
        res = serve.main(argv)
    except Exception as e:     # a rank that raised: its traceback is in e
        raise SmokeFailure(f"phase 17: {arch}: a rank failed:\n{e}") from None
    print(f"  {arch}: {len(res['ranks'])} ranks served in {time.perf_counter() - t0:.1f} s "
          f"(spawn, build and cut included)")
    return res["ranks"]


def run_tensor_parallel(device, yard: dict, edge_errs: dict, **over) -> list[dict]:
    """Phase 17: gemma3-4b at full width cut to ``g3_layers`` (0: its depth)
    and starcoder2-15b at full width cut to 8 layers, each served by
    ``launch.serve.main --model-parallel 4`` (4 ranks spawned on this host,
    (data 1, model 4), ``gloo`` with host copies on one card) on ``fused``,
    held against its single-process run at that depth (at full depth phase
    7's, kept as ``yard``) by :func:`hold_tp_run`; then kernels 1, 2, 4 and
    7 held bit for bit (7: to GEMM_TOL) against their plain versions on a
    rank's maps (phase 7's, of those layers) and timed. ``over`` replaces entries of TP and
    TP_SC2 (``reduced=True`` with the CPU as ``device`` rehearses the flow
    on the reduced configs: no launch checks, no timing)."""
    import os
    import shutil
    import tempfile

    import torch
    tp = {**TP, **TP_SC2, **over}
    t0 = time.perf_counter()
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    print(f"tensor-parallel serving: {tp['model']} ranks on {cards} card(s), batch "
          f"{tp['batch']} x {tp['prompt']}, {tp['gen']} greedy tokens, fused")
    g3 = tp["g3_layers"]
    if g3:      # its own single-process run at that depth; phase 7's maps of those layers
        yard = {**single_yardstick(tp, LM_ARCH, g3, yard["t_obj"]),
                **{k: yard[k][:n] for k, n in (("ffn_shards", g3), ("kv", 2 * g3))
                   if k in yard}}
    ranks = tp_serve(tp, LM_ARCH, g3, yard["t_obj"])
    n_layers = len(yard["ffn_zf"])
    hold_tp_run(LM_ARCH, ranks, yard, tp["g3_rules"], n_layers, len(yard["kv_zf"]), tp)
    launches = ranks[0]["phases"]["prefill"]
    del ranks
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zebra_tp_")
    tp = {**tp, "gen": tp["sc2_gen"], "params": os.path.join(tmp, "biases.pt")}
    n = tp_biases(tp, tp["arch"], tp["layers"], tp["params"])
    print(f"  {tp['arch']}: {n} bias values drawn N(0, {tp['bias_std']}) from numpy seed "
          f"{tp['bias_seed']}, served by both runs (--params)")
    sc2 = single_yardstick(tp, tp["arch"], tp["layers"], tp["t_obj"])
    ranks = tp_serve(tp, tp["arch"], tp["layers"], tp["t_obj"])
    shutil.rmtree(tmp, ignore_errors=True)
    hold_tp_run(tp["arch"], ranks, sc2, tp["sc2_rules"], len(sc2["ffn_zf"]),
                len(sc2["kv_zf"]), tp)
    del ranks, sc2
    t2 = time.perf_counter()
    if device.type != "cuda":
        return []
    # kernels 1, 2, 4 and 7 on a rank's maps of the gemma3-4b prefill
    lm = {"arch": LM_ARCH, "t_obj": yard["t_obj"],
          "maps": [(h.to(device), w.to(device)) for h, w in yard["ffn_shards"]],
          "kv": [x.to(device) for x in yard["kv"]], "replay_launches": {},
          "launches": {k: launches[k] for k in (*LM_KERNELS, *KERNELS)}}
    rows = time_lm_kernels(lm, edge_errs, device, gemms=("zebra_spmm_cs_kernel",),
                           codec=False, stream_rows=TP_ROWS,
                           suffix=" (gemma3-4b tensor-parallel prefill, a rank)")
    del lm
    torch.cuda.empty_cache()
    print(f"  phase 17 times: gemma3-4b {t1 - t0:.1f} s, starcoder2-15b {t2 - t1:.1f} s, "
          f"kernel timing {time.perf_counter() - t2:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 18: the sharded train step (launch.train --model-parallel)
# ---------------------------------------------------------------------------

# gemma3-4b at full width and 6 layers (one whole pattern: 5 local, the
# global), batch 4 x 1024 in 2 microbatches, stream, constant T_obj, the
# config's remat, float32 state and bf16 compute: 2 bf16 steps (the int8
# check is phase 18b's uninterrupted run, TPC); 4 ranks on the card, (data
# 2, model 2), gloo with host copies. Bounds written in PERF.md before the
# phase first ran.
TPT = dict(world=4, model=2, layers=6, batch=4, seq=1024, grad_accum=2, steps=2, lr=3e-4,
           t_obj=LM_T_OBJ)
TPT_LOSS_TOL = 1e-2          # absolute, against the single-process run's
TPT_GNORM_TOL = 0.02         # relative
TPT_ZF_TOL = 1e-3
TPT_PARAM_LR = 2.5           # |Δparam| after step 2 in units of that step's lr
# the first AdamW moment after step 1 ((1 - b1) times the reduced, compressed
# and clipped gradient), per leaf: ||m_ranks - m_one|| / ||m_one|| over every
# rank's shard of the leaf. Step 1's lr is 0, so this, not the parameters
# (Adam's first moving step moves any element by at most ~lr, so the 2.5 x
# lr bound cannot fail), is the per-element check of the sharded backward
# on the card. Set between two readings (PERF.md, PR 27): the sound run's
# worst leaf 0.1156 (an FFN weight: 1.2 % of the stream's blocks cross
# T_obj between the runs); with copy_model the identity every leaf
# 0.859-1.373
TPT_MOM_REL = 0.3
TPT_STRIDE = 8               # the yardstick's 2-D leaves compared on every 8th row


def row_sample(tensors: dict, stride: int = TPT_STRIDE) -> dict:
    """A host copy of each leaf, one of two or more dimensions whose rows
    are a multiple of 32 x ``stride`` on every ``stride``-th row only: a
    rank's share of those rows (at most 32 parts) is then a multiple of
    ``stride`` at an offset that is one, so the same sample of its shard is
    its ``[::stride]``. Returns {"stride", "strided": names, "t": tensors}."""
    out, names = {}, []
    for k, v in tensors.items():
        if v.dim() >= 2 and v.shape[0] % (32 * stride) == 0:
            v = v[::stride]
            names.append(k)
        out[k] = v.detach().to("cpu", copy=True)
    return {"stride": stride, "strided": names, "t": out}
TPT_ROWS = {f"{k} (gemma3-4b tensor-parallel training, a rank)": (k, "ffn") for k in
            ("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_unpack_kernel")}


def tpt_config(tpt: dict):
    from repro_torch.launch import train
    cfg = train.build_config(LM_ARCH, reduced=bool(tpt.get("reduced")), t_obj=tpt["t_obj"],
                             backend="stream", n_layers=tpt["layers"])
    if "pattern" in tpt:
        cfg = cfg.replace(layer_pattern=tpt["pattern"])
    return cfg.replace(zebra_tnet=False, grad_accum=tpt["grad_accum"])


def tpt_argv(tpt: dict, compress: str, steps: int) -> list:
    return ["--arch", LM_ARCH, "--layers", str(tpt["layers"]), "--batch", str(tpt["batch"]),
            "--seq", str(tpt["seq"]), "--steps", str(steps), "--lr", str(tpt["lr"]),
            "--compress", compress, "--t-obj", str(tpt["t_obj"]), "--backend", "stream",
            "--model-parallel", str(tpt["model"]),
            *(["--reduced", "--device", "cpu"] if tpt.get("reduced") else [])]


class SiteKeeps:
    """Every forward ``ffn_hidden`` site of a one-process run (a remat
    recompute inside the backward is skipped): its keep flags on the host,
    its zero fraction and stream bytes; with ``maps`` also a copy of the
    first that many input maps."""

    def __init__(self, maps: int = 0):
        self.keep, self.zf, self.bytes, self.maps, self.n_maps = [], [], [], [], maps

    def __enter__(self):
        import torch
        import repro_torch.models.lm.ffn as ffn
        self._inner = inner = ffn.zebra_site

        def site(x, cfg, **kw):
            y, aux = inner(x, cfg, **kw)
            if cfg.enabled and torch._C._current_graph_task_id() == -1:
                if len(self.maps) < self.n_maps:
                    self.maps.append(x.detach().reshape(-1, x.shape[-1]).cpu())
                if aux.keep is not None:
                    k = aux.keep
                    self.keep.append(k.reshape(-1, k.shape[-1]).to(torch.int8).cpu())
                self.zf.append(float(aux.zero_frac))
                self.bytes.append(int(aux.measured_bytes))
            return y, aux
        ffn.zebra_site = site
        return self

    def __exit__(self, *exc):
        import repro_torch.models.lm.ffn as ffn
        ffn.zebra_site = self._inner


class FirstMoment:
    """Around ``launch.train.train_lm`` (if ``on``): ``self.m``, ``copy`` of
    the first AdamW moment after step 1 (a host copy), taken when step 1 is
    logged (after the step's timing), in ``self.s`` seconds."""

    def __init__(self, on: bool = True, copy=host_copy):
        self.on, self.copy, self.m, self.s = on, copy, None, 0.0

    def __enter__(self):
        from repro_torch.launch import train
        if not self.on:
            return self
        self._step, self._log, last = train.train_step, train._log, []

        def step(*a, **k):
            out = self._step(*a, **k)
            last[:] = [out[0]]
            return out

        def log(i, m, fn):
            self._log(i, m, fn)
            if i == 1:
                t0 = time.perf_counter()
                self.m = self.copy(last[0]["opt"]["m"])
                self.s = time.perf_counter() - t0
        train.train_step, train._log = step, log
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train
        if self.on:
            train.train_step, train._log = self._step, self._log


def tpt_single(device, tpt: dict, path: str) -> dict:
    """The yardstick: the same layers, batch and steps in one process on
    this device (``launch.train.train_lm``): the bf16 run's history, sites
    and launches, its parameters after the last step written whole to
    ``path`` and its first moment after step 1 to ``tpt["yard_m1"]`` for
    the ranks (``row_sample``s), then phase 18b's int8 run (:func:`tpc_run`)
    from fresh seed-0 weights."""
    import torch
    from repro_torch.kernels import launch_counters
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    out = {}
    for compress, run in (("bf16", tpt), ("int8", tpc_run(tpt))):
        cfg = tpt_config(run)
        model = LM(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
        before = {k: w.launches for k, w in launch_counters().items()}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with SiteKeeps() as rec, FirstMoment(compress == "bf16", row_sample) as m1, \
                yard_sums():
            model, state, hist, _ = train.train_lm(
                cfg, steps=run["steps"], batch=run["batch"], seq=run["seq"], lr=run["lr"],
                compress=compress, seed=0, device=device, model=model, log=lambda *_: None)
        out[compress] = {"history": hist, "keep": rec.keep, "zf": rec.zf, "bytes": rec.bytes,
                         "launches": {k: w.launches - before[k]
                                      for k, w in launch_counters().items()},
                         "peak": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0)}
        if compress == "bf16":
            t0 = time.perf_counter()
            torch.save(row_sample(dict(model.named_parameters())), path)
            torch.save(m1.m, tpt["yard_m1"])
            out["save_s"] = time.perf_counter() - t0 + m1.s
        del model, state, rec, m1
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def replicated_mismatches(params: dict, places: dict, mesh, chunk: int = 1 << 24) -> tuple:
    """Every leaf shard this rank shares with others (whole over ``data`` or
    ``model``) against theirs, bit for bit, gathered a chunk at a time over
    each such axis (every rank walks the leaves and axes in one order).
    Returns (leaf shards compared, names that differ)."""
    import torch
    from repro_torch.distributed.collectives import Wire
    from repro_torch.distributed.ctx import axis_of
    from repro_torch.distributed.sharding import mesh_shape, split_dim
    n, bad = 0, []
    for axis_name in ("data", "model"):
        if mesh_shape(mesh)[axis_name] == 1:
            continue
        wire = Wire(axis_of(mesh, axis_name))
        for name, t in params.items():
            if split_dim(places[name], mesh, axis_name) is not None:
                continue
            n += 1
            ints = t.detach().reshape(-1).view(torch.int32 if t.element_size() == 4
                                               else torch.int16)
            same = True
            for c in ints.split(chunk):
                got = wire.all_gather(c)
                same &= bool((got == c).all())
            if not same:
                bad.append(f"{name} over {axis_name}")
    return n, bad


def sampled_pairs(got: dict, path: str, places: dict, mesh):
    """(name, this rank's shard, the same shard of the one-process run's
    tensor) for each leaf of ``got``, on the rows the ``row_sample`` saved
    at ``path`` keeps."""
    import torch
    from repro_torch.distributed.sharding import local_shard
    saved = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    stride, strided = saved["stride"], set(saved["strided"])
    for name, t in got.items():
        if name in strided:
            check(t.shape[0] % stride == 0, f"{name}: {t.shape[0]} rows a rank, stride {stride}")
            t = t[::stride]
        yield name, t, local_shard(saved["t"][name], places[name], mesh)


def shard_gaps(got: dict, path: str, places: dict, mesh, device,
               chunk: int = 1 << 24) -> dict:
    """{leaf: (||got - want||², ||want||², max |got - want|)} of this rank's
    shards ``got`` against the same shards of the one-process run's saved
    at ``path`` (``sampled_pairs``), a chunk at a time on ``device``."""
    out = {}
    for name, t, want in sampled_pairs(got, path, places, mesh):
        d2 = w2 = top = 0.0
        for a, b in zip(t.reshape(-1).split(chunk), want.reshape(-1).split(chunk)):
            b = b.to(device).double()
            d = a.to(device).double() - b
            d2 += float(d.square().sum())
            w2 += float(b.square().sum())
            top = max(top, float(d.abs().max()))
            del b, d
        out[name] = (d2, w2, top)
    return out


def tpt_rank(rank: int, out_dir: str, tpt: dict) -> None:
    """One rank of phase 18 (spawned, in the joined world): ``launch.train.
    train_rank`` on the bf16 steps with its sites recorded, its first
    moment after step 1 and its master shards after the last step against
    the yardstick's, its shared leaves against the other ranks'; then the
    phase 18b (:func:`tpt_ckpt`), whose uninterrupted int8 run is phase
    18's int8 run. Rank 0 keeps its first step's ffn_hidden input maps for
    the kernel rows. Saves ``rank<r>.pt``."""
    import torch
    from repro_torch.core.engine import record_tp_sites, tp_sites_on_host
    from repro_torch.launch import train
    cfg = tpt_config(tpt)
    n_maps = cfg.n_layers * cfg.grad_accum if rank == 0 and not tpt.get("reduced") else 0
    with SiteKeeps(maps=n_maps) as maps, record_tp_sites(bitmaps=True) as sites, \
            FirstMoment() as m1:
        res = train.train_rank(train.parse_args(tpt_argv(tpt, "bf16", tpt["steps"])), cfg)
    rep = dict(res["report"], sites=tp_sites_on_host(sites))
    state, model, mesh = res["state"], res["model"], res["mesh"]
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.cuda.empty_cache()        # 4 ranks share the card
    t0 = time.perf_counter()
    rep["mom_gaps"] = shard_gaps(m1.m, tpt["yard_m1"], model.train_places, mesh, device)
    rep["mom_s"] = time.perf_counter() - t0 + m1.s
    del m1
    lr = tpt["lr"]
    worst, beyond, n = 0.0, 0, 0
    for name, p, want in sampled_pairs(state["params"], tpt["yard_params"],
                                       model.train_places, mesh):
        d = (p.detach().float() - want.to(device).float()).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > lr / 10).sum())
        n += d.numel()
    rep["param_cmp"] = {"max_abs": worst, "beyond_lr10": beyond, "n": n}
    rep["replicated"] = replicated_mismatches(state["params"], model.train_places, mesh)
    rep["maps"] = maps.maps
    del res, state, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep["ckpt"] = tpt_ckpt(tpt, out_dir)
    rep["ckpt_s"] = time.perf_counter() - t0
    rep["int8"] = rep["ckpt"].pop("report_u")
    torch.save(rep, f"{out_dir}/rank{rank}.pt")


def run_sharded_training(device, edge_errs=None, **over) -> list[dict]:
    """Phase 18: ``launch.train.train_rank`` in 4 spawned ranks on the card,
    (data 2, model 2) (``TPT``), held against the same training in one
    process: the losses within TPT_LOSS_TOL, grad_norm within
    TPT_GNORM_TOL, the zero fraction within TPT_ZF_TOL with the blocks
    that differ counted, every stream site in the Eq. 2/3 band, every
    parameter after the last step within TPT_PARAM_LR x lr, the shared
    leaves bit for bit alike, kernels 1-3 launched on every rank as often
    as in one process; then kernels 1-3 held against their plain versions
    on rank 0's maps and timed. ``over`` replaces entries of TPT
    (``reduced=True`` with the CPU rehearses the flow: no launch checks, no
    timing)."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import mesh as lm_mesh
    tpt = {**TPT, **over}
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zebra_tpt_")
    try:
        tpt["yard_params"] = os.path.join(tmp, "yard.pt")
        tpt["yard_m1"] = os.path.join(tmp, "yard_m1.pt")
        cfg = tpt_config(tpt)
        print(f"sharded training: {LM_ARCH} {cfg.n_layers} layers at full width"
              f"{' (reduced)' if tpt.get('reduced') else ''}, batch {tpt['batch']} x "
              f"{tpt['seq']} in {tpt['grad_accum']} microbatches, stream at T_obj "
              f"{tpt['t_obj']}, remat {cfg.remat}; {tpt['world']} ranks (data "
              f"{tpt['world'] // tpt['model']}, model {tpt['model']}) against one process")
        one = tpt_single(device, tpt, tpt["yard_params"])
        t1 = time.perf_counter()
        print(f"  launch.train.train_rank(parse_args({' '.join(tpt_argv(tpt, 'bf16', 2))}), "
              f"cfg with zebra_tnet=False, grad_accum={tpt['grad_accum']}) in {tpt['world']} "
              f"spawned ranks; int8: phase 18b's uninterrupted run, "
              f"{' '.join(tpt_argv(tpc_run(tpt), 'int8', TPC['steps']))}, layer pattern "
              f"{TPC['pattern']}")
        try:
            lm_mesh.spawn(tpt_rank, tpt["world"], (tmp, tpt), device=str(device))
        except Exception as e:     # a rank that raised: its traceback is in e
            raise SmokeFailure(f"phase 18: a rank failed:\n{e}") from None
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(tpt["world"])]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t2 = time.perf_counter()
    hold_sharded_training(ranks, one, tpt, cfg, device)
    hold_sharded_ckpt(ranks, tpt)
    rows = []
    if device.type == "cuda":
        r0 = ranks[0]
        lm = {"maps": [(h.to(device), None) for h in r0["maps"]], "t_obj": tpt["t_obj"],
              "launches": r0["launches"]}
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)
        print(f"sharded training kernel times per step ({len(lm['maps'])} ffn_hidden maps of "
              f"rank 0's step 1, {tuple(r0['maps'][0].shape)}):")
        rows = time_lm_stream_kernels(lm, flush, TPT_ROWS)
        del lm, flush
        torch.cuda.empty_cache()
    print(f"  phase 18 times: one process {t1 - t0:.1f} s (of it {one['save_s']:.1f} s "
          f"copying and saving the parameters and the first moment), {tpt['world']} ranks "
          f"{t2 - t1:.1f} s (spawn, build, 3 steps, checks; the first-moment copy and "
          f"comparison {max(r['mom_s'] for r in ranks):.1f} s at most a rank; phase 18b "
          f"{ranks[0]['ckpt_s']:.1f} s of it on rank 0), kernel timing "
          f"{time.perf_counter() - t2:.1f} s")
    return rows


def hold_sharded_training(ranks: list, one: dict, tpt: dict, cfg, device) -> None:
    import torch
    label = "sharded training"
    data = tpt["world"] // tpt["model"]
    check(sorted((r["data_index"], r["model_index"]) for r in ranks) ==
          [(d, m) for d in range(data) for m in range(tpt["model"])], f"{label}: mesh")
    # the first moment after step 1, leaf by leaf over every rank's shards
    gaps = {}
    for r in ranks:
        for name, (d2, w2, top) in r["mom_gaps"].items():
            g = gaps.setdefault(name, [0.0, 0.0, 0.0])
            g[0], g[1], g[2] = g[0] + d2, g[1] + w2, max(g[2], top)
    rel = {n: (d2 / w2 if w2 else d2) ** 0.5 for n, (d2, w2, _) in gaps.items()}
    order = sorted(rel, key=rel.get)
    print(f"  {label}: first moment after step 1 against one process's, ||Δ|| / ||m|| of "
          f"each of {len(rel)} leaves over the ranks' shards (the 2-D leaves on every "
          f"{TPT_STRIDE}th row): worst {rel[order[-1]]:.3e} "
          f"({order[-1]}), median {rel[order[len(order) // 2]]:.3e}, best "
          f"{rel[order[0]]:.3e} ({order[0]}); max |Δ| {max(g[2] for g in gaps.values()):.3e} "
          f"(bound {TPT_MOM_REL} on the worst); the five worst: "
          + ", ".join(f"{n} {rel[n]:.3e}" for n in order[-5:]))
    check(rel[order[-1]] <= TPT_MOM_REL, f"{label}: the first moment of {order[-1]} is "
                                         f"{rel[order[-1]]:.3e} off one process's")
    for run, hist_1 in (("bf16", one["bf16"]["history"]),
                        (f"int8 ({TPC['layers']} layers)", one["int8"]["history"])):
        hists = [r["history"] if run == "bf16" else r["int8"]["history"] for r in ranks]
        keys = ("loss", "ce", "zero_frac", "zebra_reg", "grad_norm", "measured_bytes")
        check(all([[h[k] for k in keys] for h in hs] == [[h[k] for k in keys] for h in hists[0]]
                  for hs in hists), f"{label} {run}: the ranks' metrics differ")
        for h, h1 in zip(hists[0], hist_1):
            dl, dg = abs(h["loss"] - h1["loss"]), abs(h["grad_norm"] / h1["grad_norm"] - 1)
            dz = abs(h["zero_frac"] - h1["zero_frac"])
            print(f"  {label} {run} step {h['step']}: loss {h['loss']:.6f} (one process "
                  f"{h1['loss']:.6f}), grad_norm {h['grad_norm']:.6f} ({h1['grad_norm']:.6f}), "
                  f"zero fraction {h['zero_frac']:.6f} ({h1['zero_frac']:.6f}), "
                  f"{h['measured_bytes']} B ({h1['measured_bytes']} B), {h['ms']:.1f} ms "
                  f"(one process {h1['ms']:.1f} ms; host clock, rank 0)")
            check(dl <= TPT_LOSS_TOL, f"{label} {run} step {h['step']}: loss off by {dl}")
            check(dg <= TPT_GNORM_TOL, f"{label} {run} step {h['step']}: grad_norm off by "
                                       f"{100 * dg:.3f} %")
            check(dz <= TPT_ZF_TOL, f"{label} {run} step {h['step']}: zero fraction off by {dz}")
    # the sites: per data rank its rows, gathered over the model axis
    by_data = {r["data_index"]: r["sites"] for r in ranks if r["model_index"] == 0}
    n_sites = len(one["bf16"]["keep"])
    check(all(len(s) == n_sites for s in by_data.values()),
          f"{label}: {[len(s) for s in by_data.values()]} sites a data rank, one process "
          f"{n_sites}")
    sites0 = by_data[0]
    from repro_torch.core.engine import tp_site_rule
    rule = tp_site_rule(cfg.d_ff // tpt["model"], True, tpt["model"], cfg.zebra_block_ch)
    rules = {(s["rule"], s["backend"]) for s in sites0}
    check(rules == {(rule, "stream")}, f"{label}: sites ran {rules}, want {rule}")
    band = check_token_band([((s["rows"], s["width"]), 2, None, s["zero_frac"],
                              s["measured_bytes"]) for s in sites0], f"{label} ffn_hidden")
    flips = total = 0
    for i in range(n_sites):
        keep = torch.cat([by_data[d][i]["keep"] for d in range(data)], dim=0)
        want = one["bf16"]["keep"][i]
        check(keep.shape == want.shape, f"{label} site {i}: keep {tuple(keep.shape)} vs "
                                        f"{tuple(want.shape)}")
        flips += int((keep != want).sum())
        total += want.numel()
    print(f"  {label}: {n_sites} forward ffn_hidden sites ({sites0[0]['rule']}), every one in "
          f"the Eq. 2/3 band (worst {band:.3f} B); {flips} of {total} blocks differ from one "
          f"process's")
    # the parameters after the last step, and the shared leaves
    lr = tpt["lr"]
    worst = max(r["param_cmp"]["max_abs"] for r in ranks)
    beyond = sum(r["param_cmp"]["beyond_lr10"] for r in ranks)
    n = sum(r["param_cmp"]["n"] for r in ranks)
    print(f"  {label}: parameters after step {tpt['steps']} (the 2-D leaves on every "
          f"{TPT_STRIDE}th row): max |Δ| {worst:.3e} against one process (a record: Adam's "
          f"first moving step cannot pass its bound {TPT_PARAM_LR} x lr {lr} = "
          f"{TPT_PARAM_LR * lr:.3e}); {beyond} of {n} shard elements beyond lr/10 "
          f"({100 * beyond / max(n, 1):.4f} %)")
    check(worst <= TPT_PARAM_LR * lr, f"{label}: a parameter {worst} off one process's")
    compared = [r["replicated"][0] for r in ranks]
    bad = [b for r in ranks for b in r["replicated"][1]]
    print(f"  {label}: shared leaf shards compared bit for bit across the ranks that hold "
          f"them: {compared} a rank, {len(bad)} differ")
    check(not bad and min(compared) > 0, f"{label}: shared leaves differ: {bad[:4]}")
    # launches, memory, collectives
    want_l = {k: one["bf16"]["launches"][k] for k in STREAM_KERNELS}
    for r in ranks:
        got = {k: r["launches"][k] for k in STREAM_KERNELS}
        if not tpt.get("reduced"):
            check(got == want_l and min(got.values()) > 0,
                  f"{label} rank {r['rank']}: launches {got}, one process {want_l}")
    print(f"  {label}: kernels 1-3 launched by rank "
          f"{[[r['launches'][k] for k in STREAM_KERNELS] for r in ranks]} (one process "
          f"{[want_l[k] for k in STREAM_KERNELS]}; forward and remat recompute)")
    print(f"  {label}: max_memory_allocated by rank "
          f"{[round(r['max_memory_allocated'] / 2 ** 30, 3) for r in ranks]} GiB (one process "
          f"{one['bf16']['peak'] / 2 ** 30:.3f} GiB); state by component, rank 0: "
          + ", ".join(f"{k} {v / 2 ** 30:.3f} GiB" for k, v in ranks[0]["state_bytes"].items())
          + f"; int8 adds its residual ({TPC['layers']} layers): "
          f"{ranks[0]['int8']['state_bytes']['compress'] / 2 ** 30:.3f} GiB")
    r0 = ranks[0]
    tp, dp = r0["tp_per_step"], r0["dp_per_step"]
    print(f"  {label}: collectives a step, rank 0 ({r0['wire']}): tensor-parallel forward "
          f"{tp['calls']:.0f} calls, {tp['bytes'] / 2 ** 20:.1f} MiB handed in; backward "
          f"{tp['bwd_calls']:.0f} calls, {tp['bwd_bytes'] / 2 ** 20:.1f} MiB; data-parallel "
          f"{dp['calls']:.0f} calls, {dp['bytes'] / 2 ** 20:.1f} MiB; rank 0's stages: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in r0["stage_s"].items()))


# ---------------------------------------------------------------------------
# Phase 18b: checkpoints of the sharded state
# ---------------------------------------------------------------------------

# in phase 18's world after its runs: gemma3-4b at full width cut to 2
# layers, the pattern's last local layer and its global one (0.87 B
# parameters, ~13.9 GB of float32 state a checkpoint with int8's
# residual), phase 18's site and remat, int8; a crash on every rank at
# call 3 of a 3-step run with a checkpoint every 2, against the same run
# uninterrupted; the final file restored at (data 1, model 4). Cut for the
# smoke's time from 4 steps to 3 (the crash still restores step 2); the
# batch stays phase 18's (a cut to 2 x 1024 did not shorten a step, whose
# time is the data-parallel reductions: PERF.md §6)
TPC = dict(layers=2, pattern=("local", "global"), steps=3, ckpt_every=2, crash_at=3,
           restore_model=4)


def tpc_run(tpt: dict) -> dict:
    """Phase 18's run parameters with phase 18b's depth and steps."""
    return {**tpt, **{k: TPC[k] for k in ("layers", "pattern", "steps")}}


class HostPeak:
    """The most resident bytes this process held inside the block:
    ``VmRSS`` read every 10 ms on a thread (the card's machine has no
    ``VmHWM``, and a spawned rank's ``ru_maxrss`` counts its parent's at
    the fork). ``peak`` stays 0 where ``/proc`` has no ``VmRSS``."""

    def __init__(self):
        import threading
        self.peak, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while True:
            for line in Path("/proc/self/status").read_text().splitlines():
                if line.startswith("VmRSS:"):
                    self.peak = max(self.peak, int(line.split()[1]) * 1024)
            if self._stop.wait(0.01):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def state_on_host(state) -> dict:
    """Every tensor leaf of a train state, by its flat name, on the host."""
    import torch
    from repro_torch.checkpoint.manager import _leaves
    return {k: v.detach().to("cpu", copy=True) for k, v in _leaves(state)
            if isinstance(v, torch.Tensor)}


def tpt_ckpt(tpt: dict, out_dir: str) -> dict:
    """Phase 18b on this rank (module docstring): ``train_rank`` with
    ``--compress int8`` uninterrupted, then under ``--ckpt`` with
    ``ft.crashing_step`` raising at call 3 on every rank after moving every
    tensor of the state (parameters, both moments, the residual), its
    shards held bit for bit against the first run's; the final file
    restored into a model built at (data 1, model 4), whose whole leaves,
    gathered back to rank 0, must have the manifest's CRCs. Returns the
    checks' readings and the times."""
    import os
    import shutil

    over = tpc_run(tpt)
    cfg = tpt_config(over)
    argv = tpt_argv(over, "int8", TPC["steps"])
    ckpt = os.path.join(out_dir, "ckpt")
    out = {"free": shutil.disk_usage(out_dir).free}
    with HostPeak() as peak:
        out.update(tpt_ckpt_runs(tpt, cfg, argv, ckpt))
    out["host_peak"] = peak.peak
    return out


def tpt_ckpt_runs(tpt: dict, cfg, argv: list, ckpt: str) -> dict:
    """:func:`tpt_ckpt`'s runs and checks on this rank."""
    import os

    import torch
    import torch.distributed as dist
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import ft
    from repro_torch.checkpoint.manager import _crc, _leaves
    from repro_torch.checkpoint.sharded import ShardedCheckpointManager, whole_leaves
    from repro_torch.distributed.sharding import build_sharded
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import init_train_state
    from repro_torch.optim import adamw, warmup_cosine

    rank0, out = dist.get_rank() == 0, {}
    t0 = time.perf_counter()
    res = train.train_rank(train.parse_args(argv), cfg)
    device = next(res["model"].parameters()).device
    want, hist_u = state_on_host(res["state"]), res["history"]
    out["report_u"] = res["report"]             # phase 18's int8 run
    out["launches_u"] = res["report"]["launches"]
    del res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    inner, seen = train.train_step, {}

    def recording(model, opt, state, *a, **kw):
        seen.update(model=model, state=state)
        return inner(model, opt, state, *a, **kw)

    def dirty():
        """The crash after a half-applied update: every parameter, both
        moments and the residual moved."""
        with torch.no_grad():
            for t in (*seen["model"].parameters(), *(v for _, v in _leaves(seen["state"])
                                                     if isinstance(v, torch.Tensor))):
                t.add_(1.0)
        return ft.TransientStep(f"injected crash at call {TPC['crash_at']}")
    train.train_step = ft.crashing_step(recording, TPC["crash_at"], exc=dirty)
    try:
        with CkptTimer(ShardedCheckpointManager) as timer:
            res = train.train_rank(train.parse_args(
                [*argv, "--ckpt", ckpt, "--ckpt-every", str(TPC["ckpt_every"])]), cfg)
    finally:
        train.train_step = inner
    got, hist = res["state"], res["history"]
    out.update(
        differ=[k for k, v in _leaves(got) if isinstance(v, torch.Tensor)
                and not same_bits(v.detach().cpu(), want[k])],
        leaves=len(want), step=got["step"], history=[h["step"] for h in hist],
        losses=[h["loss"] for h in hist], losses_u=[h["loss"] for h in hist_u],
        failures=[e["class"] for e in res["supervisor"].failure_log],
        launches=res["report"]["launches"], times=timer.times)
    final = os.path.join(ckpt, f"step_{TPC['steps']}")
    if rank0:
        man = json.loads(Path(final, "manifest.json").read_text())
        out.update(extra=man["extra"], bytes=os.path.getsize(os.path.join(final, "shard_0.npz")))
        want_crc = man["checksums"]
    del res, got, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    mesh = make_host_mesh(model=TPC["restore_model"], device=device)
    model = build_sharded(cfg, mesh, generator=torch.Generator(device=device).manual_seed(1),
                          device=device, train=True)
    state = init_train_state(model, adamw(warmup_cosine(tpt["lr"], 1, TPC["steps"])), "int8")
    t3 = time.perf_counter()
    step, state, extra = ShardedCheckpointManager(ckpt, model).restore(state)
    t4 = time.perf_counter()
    # the witness: the restored shards gathered back whole to rank 0, each
    # leaf's CRC32 the manifest's (the restore checked the file's bytes,
    # this checks what every rank holds)
    flat = whole_leaves(model, state)
    if rank0:
        with ThreadPoolExecutor(max_workers=4) as pool:
            sums = dict(zip(flat, pool.map(_crc, flat.values())))
        out.update(crc_bad=sorted(k for k in set(sums) | set(want_crc)
                                  if sums.get(k) != want_crc.get(k)), crc_checked=len(sums))
    del flat
    out.update(restored=(step, extra, state["step"]),
               layout={"data": mesh.size(0), "model": mesh.size(1)},
               s={"uninterrupted": t1 - t0, "crash and resume": t2 - t1,
                  "build at the new layout": t3 - t2, "restore at the new layout": t4 - t3,
                  "gather and CRCs at the new layout": time.perf_counter() - t4})
    del model, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def hold_sharded_ckpt(ranks: list, tpt: dict) -> None:
    """Phase 18b's checks and figures, from every rank's ``tpt_ckpt``."""
    label = "sharded checkpoints"
    steps, c = TPC["steps"], [r["ckpt"] for r in ranks]
    r0 = c[0]
    print(f"{label} (phase 18b): {LM_ARCH} at full width"
          f"{' (reduced)' if tpt.get('reduced') else ''}, {TPC['layers']} layers "
          f"{TPC['pattern']}, batch {tpt['batch']} x {tpt['seq']}, int8, "
          f"{tpt['world']} ranks (data {tpt['world'] // tpt['model']}, model {tpt['model']}), "
          f"{steps} steps under --ckpt-every {TPC['ckpt_every']}, a crash on every rank at "
          f"call {TPC['crash_at']}; {r0['free'] / 1e9:.1f} GB free for the checkpoints")
    for r, x in zip(ranks, c):
        check(not x["differ"], f"{label} rank {r['rank']}: the resumed run's shards differ "
                               f"from the uninterrupted run's: {x['differ'][:4]}")
        check(x["failures"] == ["TransientStep"], f"{label}: failure log {x['failures']}")
        check(x["history"] == list(range(1, steps + 1)), f"{label}: history {x['history']}")
        check(x["losses"] == x["losses_u"], f"{label}: losses {x['losses']} vs {x['losses_u']}")
        check(x["step"] == steps, f"{label}: step {x['step']}")
        check(x["restored"][0] == steps and x["restored"][2] == steps and
              x["restored"][1] == {"loader_step": steps}, f"{label}: restored {x['restored']}")
        if not tpt.get("reduced"):
            for run in ("launches_u", "launches"):
                got = [x[run][k] for k in STREAM_KERNELS]
                check(min(got) > 0, f"{label} rank {r['rank']}: kernels 1-3 launched {got}")
    check(r0["extra"] == {"loader_step": steps}, f"{label}: manifest extra {r0['extra']}")
    check(not r0["crc_bad"] and r0["crc_checked"] == r0["leaves"] + 1,
          f"{label}: at {r0['layout']} the restored state gathered whole differs from the "
          f"file: {r0['crc_bad'][:4]} ({r0['crc_checked']} leaves checked)")
    print(f"  crashed at call {TPC['crash_at']}, restored step {TPC['ckpt_every']}: every "
          f"rank's shards of the parameters, both AdamW moments and the int8 residual "
          f"({r0['leaves']} leaves), the step, the loader's step and the losses "
          f"{r0['losses']} == the uninterrupted run (bitwise); kernels 1-3 launched by rank "
          f"{[[x['launches'][k] for k in STREAM_KERNELS] for x in c]}")
    print(f"  the step-{steps} file restored at {r0['layout']}: every rank checked each whole "
          f"leaf's CRC32 against the manifest's as it read it; the restored shards gathered "
          f"back whole to rank 0: all {r0['crc_checked']} leaves' CRC32s the manifest's")
    t = r0["times"]
    for i, (blk, wr) in enumerate(zip(t["save"], t["_write"])):
        print(f"  save {i + 1}: blocks the loop {blk * 1e3:.1f} ms (the gather to rank 0); "
              f"write and CRCs {wr * 1e3:.1f} ms on rank 0's writer thread "
              f"({r0['bytes'] / wr / 1e6:.1f} MB/s); {r0['bytes']} B a checkpoint")
    print(f"  restore and verify after the crash, by rank: "
          f"{[round(x['times']['restore'][0], 3) for x in c]} s; at {r0['layout']}: "
          f"{[round(x['s']['restore at the new layout'], 3) for x in c]} s")
    peaks = [round(x["host_peak"] / 2 ** 30, 2) if x["host_peak"] else "not measured"
             for x in c]
    print(f"  host peak in phase 18b (VmRSS every 10 ms) by rank: {peaks} "
          f"GiB; rank 0's stages: " + ", ".join(f"{k} {v:.1f} s" for k, v in r0["s"].items()))


# ---------------------------------------------------------------------------
# Phase 19: tensor-parallel serving of the other layer kinds
# ---------------------------------------------------------------------------

# one spawned world of 4 ranks on the card (gloo, host copies) serves the
# five architectures in turn at full width, each against its own
# single-process run at the same depth: batch x prompt 256, 8 greedy tokens.
# Depths are cut for the phase's time (the smoke's 1200 s): granite at its
# 24, llama4 4 of 48 layers, mamba2 16 of 64, recurrentgemma 6 of 26 (two
# whole rglru/rglru/local patterns), whisper 6 + 6 of 24 + 24
TPL = dict(world=4, prompt=256, gen=8)
# per architecture: backend, model ranks (data = 4 / model), depths, batch,
# T_obj, the (rule, axis) each site kind runs by (and the count of sites
# that degenerate), the kernels its path launches, the kernel rows timed on
# rank 0's prefill maps, the bound on max |Δlogit| of the prefill against
# one process's (three times the sound reading of the first full run;
# mamba2's sits under its fault reading, bf16 split-K sums, 1.383) and the
# most of a site kind's blocks whose keep flag may differ from one
# process's, a flip the zero fraction cannot see when it is balanced (1.5
# times that run's sound share, at least 0.1 %; mamba2's sits under its
# fault reading, 0.52 %)
TPL_RUNS = {
    "granite-moe-1b-a400m": dict(
        backend="stream", model=2, layers=0, enc_layers=0, batch=4, t_obj=0.0064,
        rules={"ffn_hidden": ("blocks", "rows"), "kv_cache": ("blocks", "cols")},
        kernels=(*STREAM_KERNELS, "zebra_pack"),
        rows=("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_unpack_kernel"),
        logit_bound=0.1875, flip_share=0.033),
    "llama4-scout-17b-a16e": dict(
        backend="fused", model=4, layers=4, enc_layers=0, batch=2, t_obj=0.00038,
        rules={"ffn_hidden": ("blocks", "rows"), "kv_cache": ("blocks", "cols")},
        kernels=("zebra_mask_kernel", "zebra_pack", "zebra_unpack_kernel"),
        rows=("zebra_mask_kernel",), logit_bound=0.09375, flip_share=0.023),
    "mamba2-2.7b": dict(
        backend="stream", model=4, layers=16, enc_layers=0, batch=2, t_obj=5.0,
        rules={"layer_out": ("whole", "cols")},
        kernels=(*STREAM_KERNELS, "zebra_pack"), rows=(), logit_bound=0.8, flip_share=0.001),
    "recurrentgemma-2b": dict(
        backend="fused", model=4, layers=6, enc_layers=0, batch=2, t_obj=1.5,
        rules={"ffn_hidden": ("blocks", "cols"), "kv_cache": ("whole", "cols")},
        kernels=("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_spmm_cs_kernel",
                 "zebra_mask_kernel", "zebra_pack", "zebra_unpack_kernel"),
        rows=("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_spmm_cs_kernel"),
        logit_bound=0.7, flip_share=0.023),
    "whisper-medium": dict(
        backend="fused", model=4, layers=6, enc_layers=6, batch=2, t_obj=1.55, degenerate=6,
        rules={"ffn_hidden": ("blocks", "cols"), "kv_cache": ("blocks", "cols")},
        kernels=("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_spmm_cs_kernel",
                 "zebra_mask_kernel", "zebra_pack", "zebra_unpack_kernel"),
        rows=("zebra_bitmap_kernel", "zebra_pack_kernel", "zebra_spmm_cs_kernel"),
        logit_bound=0.75, flip_share=0.001),
}
TPL_SUFFIX = " ({} tensor-parallel prefill, a rank)"


def tpl_argv(arch: str, run: dict, tpl: dict) -> list:
    return ["--arch", arch, "--backend", run["backend"], "--batch", str(run["batch"]),
            "--prompt-len", str(tpl["prompt"]), "--gen", str(tpl["gen"]), "--t-obj",
            str(run["t_obj"]), "--layers", str(run["layers"]), "--encoder-layers",
            str(run["enc_layers"]),
            *(["--reduced", "--device", "cpu"] if tpl.get("reduced") else [])]


class SiteLog:
    """Every enabled token site of a one-process served run until its
    handoff (the prefill's, the encoder's included): kind, map shape, keep
    flags (int8) and zero fraction, kept on the card during the run (no
    host sync: the run's times stand) and copied by :meth:`on_host` after
    it. Adds no kernel launch."""

    def __init__(self):
        self.sites, self.on = [], True

    def __enter__(self):
        import repro_torch.core.engine as engine
        import repro_torch.models.lm.blocks as blocks
        import repro_torch.models.lm.ffn as ffn
        from repro_torch.launch import serve
        self._mods = (engine, blocks, ffn)
        self._inner = inner = engine.zebra_site
        self._serve, self._handoff = serve, serve.transport_state_compressed

        def site(x, cfg, **kw):
            import torch
            y, aux = inner(x, cfg, **kw)
            if self.on and cfg.enabled and aux.keep is not None:
                k = aux.keep
                self.sites.append((kw.get("site"), tuple(x.shape),
                                   k.reshape(-1, k.shape[-1]).to(torch.int8), aux.zero_frac))
            return y, aux

        def handoff(*a, **k):
            self.on = False
            return self._handoff(*a, **k)
        for m in self._mods:
            m.zebra_site = site
        serve.transport_state_compressed = handoff
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.zebra_site = self._inner
        self._serve.transport_state_compressed = self._handoff

    def on_host(self) -> list:
        return [(site, shape, k.cpu(), float(zf)) for site, shape, k, zf in self.sites]


def yard_sums():
    """The single-process runs that tensor-parallel ones are held against
    keep their GEMMs' sums in float32 as a rank does (``utils.
    float32_sums``), on the card that is there."""
    import torch
    from repro_torch.utils import float32_sums
    return float32_sums(torch.device("cuda" if torch.cuda.is_available() else "cpu"))


def tpl_yardstick(arch: str, run: dict, tpl: dict) -> dict:
    """``arch`` served in this process (``serve.main``) at the phase's
    depth: host copies of its tokens, the logits of every token, the
    handoff's records, every prefill site and the launches by phase."""
    import torch
    from repro_torch.launch import serve
    before = launch_counts()
    with SiteLog() as log, PhaseCounts(serve) as phases, yard_sums():
        out = serve.main(tpl_argv(arch, run, tpl))
    after = launch_counts()
    at = phases.at
    yard = {"tokens": out["tokens"].cpu(), "logits": out["logits"].float().cpu(),
            "step_logits": torch.stack([out["logits"].float().cpu()]
                                       + [x.float().cpu() for x in phases.logits]),
            "records": [(r.site, r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live)
                        for r in out["meter"].records],
            "sites": log.on_host(),
            "phases": {"prefill": diff_counts(at["prefill"], before),
                       "handoff": diff_counts(at["handoff"], at["prefill"]),
                       "decode": diff_counts(after, at["handoff"])},
            "prefill_ms": out["prefill_ms"], "decode_ms": out["decode_ms_per_token"]}
    del out, log, phases
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return yard


class RankMaps:
    """On one rank (``on``): a host copy of the input map of every
    ``ffn_hidden`` site the engine runs until the handoff, as its kernels
    get it (a rank's rows or columns, or the gathered whole), with the
    weight the site consumes (None for a masked map); block-divisible maps
    only (the encoder's degenerate ones launch nothing)."""

    def __init__(self, on: bool):
        self.on, self.maps = on, []

    def __enter__(self):
        import repro_torch.core.engine as engine
        from repro_torch.launch import serve
        self._engine, self._inner = engine, engine._site
        self._serve, self._handoff = serve, serve.transport_state_compressed
        if not self.on:
            return self

        def site(x, cfg, **kw):
            w = kw.get("w")
            if self.on and cfg.enabled and kw.get("site") == "ffn_hidden" and \
                    x.shape[-2] % cfg.block_seq == 0:
                self.maps.append((x.detach().reshape(-1, x.shape[-1]).cpu(),
                                  None if w is None else w.detach().cpu()))
            return self._inner(x, cfg, **kw)

        def handoff(*a, **k):
            self.on = False
            return self._handoff(*a, **k)
        engine._site, serve.transport_state_compressed = site, handoff
        return self

    def __exit__(self, *exc):
        self._engine._site = self._inner
        self._serve.transport_state_compressed = self._handoff


def tpl_rank(rank: int, out_dir: str, jobs: list, svtp_jobs: list | None = None) -> None:
    """One rank of phases 19 and 20 (spawned, in the joined world): each job
    ``(argv, model ranks, keep maps, training)`` served by
    ``launch.serve.main`` with ``--model-parallel``, which inside a joined
    world serves as this rank (``serve_rank``) and saves its report to
    ``<out_dir>/<job>/``; rank 0 also saves its ffn_hidden maps where the
    job keeps them. Then, where ``training`` is ``(arch, run, tptl)``, the
    same architecture trained sharded (phase 20, :func:`tptl_train`). Then
    phase 21's jobs, where given (:func:`svtp_rank`, under
    ``<out_dir>/svtp``)."""
    import os

    import torch
    from repro_torch.launch import serve
    for i, (argv, model, keep, training) in enumerate(jobs):
        d = os.path.join(out_dir, str(i))
        os.makedirs(d, exist_ok=True)
        with RankMaps(rank == 0 and keep) as maps:
            out = serve.main([*argv, "--model-parallel", str(model), "--record", "--save", d])
        if maps.maps:
            torch.save(maps.maps, os.path.join(d, "maps.pt"))
        del out, maps
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if training is not None:
            tptl_train(rank, *training, d)
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    if svtp_jobs:
        svtp_rank(rank, os.path.join(out_dir, "svtp"), svtp_jobs)


def tpl_keep(ranks: list, s_index: int, axis: str):
    """The whole map's keep flags of site ``s_index``: rank 0's for a map
    split by rows (every data rank holds it whole), else each data rank's
    rows (its model axis's first rank) in data order."""
    import torch
    if axis == "rows":
        return ranks[0]["sites"][s_index]["keep"]
    firsts = sorted((r for r in ranks if r["model_index"] == 0),
                    key=lambda r: r["data_index"])
    return torch.cat([r["sites"][s_index]["keep"] for r in firsts])


def hold_tpl_run(arch: str, run: dict, ranks: list, yard: dict, tpl: dict) -> None:
    """One architecture's tensor-parallel run (its ranks' reports) against
    its single-process yardstick: the mesh; every model rank's logits and
    tokens bit for bit like its data rank's first rank's; each site kind
    by its rule and axis, the sites alike on every rank, every site that
    reports stream bytes and every handoff leaf in the Eq. 2/3 band; the
    zero fraction per site kind within TP_ZF_TOL of one process's and the
    share of its blocks that differ at most the run's ``flip_share``; the
    prefill logits within its ``logit_bound``;
    the tokens equal but for near ties; on the card every rank's launches
    by phase equal to one process's, each kernel of the path launched.
    Prints times, memory and the collectives."""
    import torch
    m, world = run["model"], len(ranks)
    check(sorted((r["data_index"], r["model_index"]) for r in ranks)
          == [(d, i) for d in range(world // m) for i in range(m)], f"{arch}: mesh coordinates")
    firsts = sorted((r for r in ranks if r["model_index"] == 0), key=lambda r: r["data_index"])
    for r in ranks:
        f = firsts[r["data_index"]]
        check(same_bits(r["logits"], f["logits"]) and torch.equal(r["tokens"], f["tokens"]),
              f"{arch}: rank {r['rank']}'s logits or tokens differ from its data rank's")
    r0 = ranks[0]
    sites = r0["sites"]
    for r in ranks[1:]:
        check([{k: v for k, v in s.items() if k != "keep"} for s in r["sites"]] ==
              [{k: v for k, v in s.items() if k != "keep"} for s in sites],
              f"{arch}: rank {r['rank']}'s sites differ from rank 0's")
    # whisper's encoder: 1500 frames are no multiple of block_seq, so its
    # sites run reference(degenerate-rows), in one process as on a rank
    degenerate = {i for i, s in enumerate(sites) if s["backend"] == "reference(degenerate-rows)"}
    check(len(degenerate) == run.get("degenerate", 0), f"{arch}: {len(degenerate)} degenerate "
                                                       f"sites, want {run.get('degenerate', 0)}")
    for kind, (rule, axis) in run["rules"].items():
        got = {(s["rule"], s["split"], s["backend"]) for i, s in enumerate(sites)
               if s["site"] == kind and i not in degenerate}
        check(got == {(rule, axis, run["backend"])},
              f"{arch}: {kind} sites ran {got}, want {(rule, axis, run['backend'])}")
    check(len(sites) == len(yard["sites"]) and all(
        s["site"] == y[0] for s, y in zip(sites, yard["sites"])),
        f"{arch}: {len(sites)} sites against {len(yard['sites'])} in one process")
    banded = [s for s in sites if s["measured_bytes"] > 0]
    band = check_token_band([((s["rows"], s["width"]), 2, None, s["zero_frac"],
                              s["measured_bytes"]) for s in banded], f"{arch} sites")
    for kind in sorted({s["site"] for s in sites}):
        idx = [i for i, s in enumerate(sites) if s["site"] == kind]
        nb = [sites[i]["n_total"] for i in idx]
        zf_tp = sum(sites[i]["zero_frac"] * n for i, n in zip(idx, nb)) / sum(nb)
        zf_1 = sum(yard["sites"][i][3] * n for i, n in zip(idx, nb)) / sum(nb)
        flips = 0
        for i in idx:
            k_tp, k_1 = tpl_keep(ranks, i, sites[i]["split"]), yard["sites"][i][2]
            check(k_tp.shape == k_1.shape, f"{arch} {kind} site {i}: keep flags "
                                           f"{tuple(k_tp.shape)} vs {tuple(k_1.shape)}")
            flips += int((k_tp != k_1).sum())
        print(f"  {arch} {kind}: {len(idx)} sites ({sites[idx[-1]]['rule']}, "
              f"{sites[idx[-1]]['split']}), zero fraction {zf_tp:.6f} vs {zf_1:.6f} in one "
              f"process; {flips} of {sum(nb)} blocks differ (bound {run['flip_share']:.1%})")
        check(abs(zf_tp - zf_1) <= TP_ZF_TOL, f"{arch} {kind}: zero fraction {zf_tp} vs "
                                              f"{zf_1} beyond {TP_ZF_TOL}")
        check(flips <= run["flip_share"] * sum(nb), f"{arch} {kind}: {flips} of {sum(nb)} blocks "
                                                 f"differ from one process's")
    leaves = [x for x in r0["records"] if x["n_blocks"]]
    worst_leaf = max(x["payload_bytes"] + x["index_bytes"] - x["predicted"] for x in leaves)
    check(all(0 <= x["payload_bytes"] + x["index_bytes"] - x["predicted"] < 1 for x in leaves)
          and r0["reconcile"]["n_sites"] == len(leaves) > 0,
          f"{arch}: a handoff leaf outside the Eq. 2/3 band")
    moved = sum(x["payload_bytes"] + x["index_bytes"] for x in r0["records"])
    moved_1 = sum(p + i for _, p, i, *_ in yard["records"])
    print(f"  {arch} handoff: {len(leaves)} compressed of {len(r0['records'])} leaves, "
          f"{moved} B (one process {moved_1} B), every leaf in the Eq. 2/3 band (worst "
          f"{worst_leaf:.3f} B); {len(banded)} stream sites in the band (worst {band:.3f} B)")
    logits = torch.cat([f["logits"] for f in firsts])
    tokens = torch.cat([f["tokens"] for f in firsts])
    steps = torch.cat([f["step_logits"] for f in firsts], dim=1)
    err = float((logits - yard["logits"]).abs().max())
    print(f"  {arch} prefill logits: max |Δ| {err} against one process (bound "
          f"{run['logit_bound']}, max |logit| {float(yard['logits'].abs().max())})")
    check(err <= run["logit_bound"], f"{arch}: prefill logits {err} off one process's")
    for b in range(tokens.shape[0]):
        d = near_tie(f"{arch} lane {b}", (yard["tokens"][b].tolist(), yard["step_logits"][:, b]),
                     (tokens[b].tolist(), steps[:, b]))
        print(f"  {arch} lane {b}: tokens "
              + ("equal to one process's" if d is None else
                 f"part at token {d['token']} ({d['got']} for {d['yard']}), a near tie: "
                 f"gap {d['gap']} <= max |Δlogit| {d['delta']}"))
        check(d is None or d["gap"] <= run["logit_bound"],
              f"{arch} lane {b}: tokens part at a gap {d and d['gap']} over the logit bound")
    for r in ranks:
        for phase, want in yard["phases"].items():
            got = {k: v for k, v in r["phases"][phase].items()
                   if not k.startswith(("tp_", "dp_"))}
            check(got == want, f"{arch} rank {r['rank']} {phase}: launches {got}, one "
                               f"process {want}")
    total = {k: sum(r0["phases"][p][k] for p in r0["phases"]) for k in yard["phases"]["prefill"]}
    if not tpl.get("reduced"):       # the CPU's plain versions count nothing
        check(all(total[k] > 0 for k in run["kernels"]),
              f"{arch}: a kernel of the path never launched: {total}")
    print(f"  {arch} launches a rank, as in one process: " + "; ".join(
        f"{p} {dict((k, v) for k, v in c.items() if v)}" for p, c in yard["phases"].items()))
    ph = r0["phases"]
    steps_ = tpl["gen"] - 1
    print(f"  {arch}: prefill {r0['prefill_ms']:.3f} ms (one process {yard['prefill_ms']:.3f}),"
          f" decode {r0['decode_ms_per_token']:.3f} ms a token (one process "
          f"{yard['decode_ms']:.3f}); host clock, rank 0, {r0['wire']}")
    print(f"  {arch}: max_memory_allocated by rank "
          f"{[round(r['max_memory_allocated'] / 2 ** 30, 3) for r in ranks]} GiB serving, "
          f"{[round(r['build_peak_memory'] / 2 ** 30, 3) for r in ranks]} GiB building; "
          f"rank 0's stages: " + ", ".join(f"{k} {v:.1f} s" for k, v in r0["stage_s"].items()))
    print(f"  {arch}: tensor-parallel collectives a rank: prefill {ph['prefill']['tp_calls']} "
          f"calls, {ph['prefill']['tp_bytes']} B handed in; handoff "
          f"{ph['handoff']['tp_calls']} calls, {ph['handoff']['tp_bytes']} B; decode "
          f"{ph['decode']['tp_calls'] / steps_:.1f} calls, {ph['decode']['tp_bytes'] / steps_:.0f}"
          f" B a token")


def time_tpl_kernels(arch: str, run: dict, maps: list, launches: dict, t_obj: float,
                     edge_errs: dict, device) -> list[dict]:
    """The kernel rows of one architecture's phase 19 run on rank 0's
    prefill maps: the stream kernels held bit for bit against their plain
    versions and timed; the payload GEMM against its plain version on the
    rank's rows of ``w_down``, beside ``torch.matmul``."""
    import torch
    suffix = TPL_SUFFIX.format(arch)
    stream = {f"{k}{suffix}": (k, "ffn") for k in run["rows"] if k in KERNELS}
    lm = {"arch": arch, "t_obj": t_obj, "launches": launches, "replay_launches": {},
          "maps": [(x.to(device), None if w is None else w.to(device)) for x, w in maps]}
    print(f"{arch} tensor-parallel kernel times per prefill, a rank ({len(maps)} ffn_hidden "
          f"maps {tuple(maps[0][0].shape)}):")
    if "zebra_spmm_cs_kernel" in run["rows"]:
        rows = time_lm_kernels(lm, edge_errs, device, gemms=("zebra_spmm_cs_kernel",),
                               codec=False, stream_rows=stream, suffix=suffix)
    else:
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)
        rows = time_lm_stream_kernels(lm, flush, stream)
        del flush
    del lm
    torch.cuda.empty_cache()
    return rows


def run_tp_layers(device, edge_errs: dict, runs=None, train_runs=None, train_over=None,
                  g3_yard: dict | None = None, svtp_over: dict | None = None,
                  **over) -> list[dict]:
    """Phases 19 and 20: the MoE (expert parallelism), Mamba-2,
    recurrentgemma and whisper served tensor-parallel at full width, each
    through ``launch.serve.main --model-parallel`` in one world of 4 ranks
    spawned on the card (``TPL_RUNS``), held against its own
    single-process run at the same depth by :func:`hold_tpl_run`; in the
    same world, after each is served, the architectures of ``TPTL_RUNS``
    trained sharded (``launch.train.train_rank``) and held against their
    own one-process training by :func:`hold_tptl_run`; then the kernel rows
    on rank 0's prefill maps and training maps. ``runs`` replaces TPL_RUNS,
    ``train_runs`` TPTL_RUNS, ``over`` entries of TPL and ``train_over``
    entries of TPTL (``reduced=True`` in both with the CPU rehearses the
    flow on the reduced configs: no launch checks, no timing). With
    ``g3_yard`` (phase 15's run) the same world then serves phase 21
    (:func:`svtp_prepare` before it with ``svtp_over``, :func:`svtp_finish`
    after the checks of phases 19 and 20)."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import mesh as lm_mesh
    tpl, runs = {**TPL, **over}, TPL_RUNS if runs is None else runs
    tptl = {**TPTL, **(train_over or {})}
    train_runs = TPTL_RUNS if train_runs is None else train_runs
    t0 = time.perf_counter()
    print(f"tensor-parallel serving of the other layer kinds: {tpl['world']} ranks on the "
          f"{'card' if device.type == 'cuda' else 'CPU'}, prompt {tpl['prompt']}, "
          f"{tpl['gen']} greedy tokens, each against its own single-process run")
    tmp = tempfile.mkdtemp(prefix="zebra_tpl_")
    try:
        yards, tyards = {}, {}
        for i, (arch, run) in enumerate(runs.items()):
            os.makedirs(os.path.join(tmp, str(i)))
            with torch.inference_mode():
                yards[arch] = tpl_yardstick(arch, run, tpl)
        t1 = time.perf_counter()
        for i, (arch, run) in enumerate(runs.items()):
            if arch in train_runs:
                trun = train_runs[arch]
                tyards[arch] = tptl_yardstick(arch, trun, tptl, device,
                                              os.path.join(tmp, str(i), "yard_m1.pt"))
        prep = None if g3_yard is None else svtp_prepare(device, g3_yard, **(svtp_over or {}))
        t2 = time.perf_counter()
        jobs = [(tpl_argv(arch, run, tpl), run["model"], bool(run["rows"]),
                 (arch, train_runs[arch], tptl) if arch in train_runs else None)
                for arch, run in runs.items()]
        for argv, m, _, training in jobs:
            print(f"  python -m repro_torch.launch.serve {' '.join(argv)} --model-parallel {m}")
            if training is not None:
                print(f"  then launch.train.train_rank(parse_args("
                      f"{' '.join(tptl_argv(*training))}), cfg with zebra_tnet=False, "
                      f"grad_accum=1{', encoder 1 layer, 1504 seeded frames' if 'whisper' in training[0] else ''})")
        try:
            lm_mesh.spawn(tpl_rank, tpl["world"],
                          (tmp, jobs, None if prep is None else prep["jobs"]), device=str(device))
        except Exception as e:     # a rank that raised: its traceback is in e
            raise SmokeFailure(f"phase 19/20/21: a rank failed:\n{e}") from None
        svtp_got = None if prep is None else svtp_load(os.path.join(tmp, "svtp"), prep["jobs"])
        reports, maps, treports = {}, {}, {}
        for i, arch in enumerate(runs):
            d = os.path.join(tmp, str(i))
            reports[arch] = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                             for r in range(tpl["world"])]
            if os.path.exists(os.path.join(d, "maps.pt")):
                maps[arch] = torch.load(os.path.join(d, "maps.pt"), weights_only=False)
            if arch in train_runs:
                treports[arch] = [torch.load(os.path.join(d, f"train_rank{r}.pt"),
                                             weights_only=False) for r in range(tpl["world"])]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t3 = time.perf_counter()
    for arch, run in runs.items():
        hold_tpl_run(arch, run, reports[arch], yards[arch], tpl)
    print(f"sharded training of the other layer kinds (phase 20): one whole layer pattern "
          f"each at full width, {tptl['steps']} bf16 steps, each against its own one-process "
          f"training")
    for arch, trun in train_runs.items():
        hold_tptl_run(arch, trun, treports[arch], tyards[arch], tptl)
    t4 = time.perf_counter()
    rows = []
    if device.type == "cuda":
        for arch, run in runs.items():
            if run["rows"]:
                rows += time_tpl_kernels(arch, run, maps[arch],
                                         reports[arch][0]["phases"]["prefill"], run["t_obj"],
                                         edge_errs, device)
        for arch, trun in train_runs.items():
            r0 = treports[arch][0]
            rows += time_tptl_kernels(arch, trun, r0["maps"], r0["launches"], device)
    print(f"  phase 19 and 20 times: single-process serving {t1 - t0:.1f} s, single-process "
          f"training and phase 21's yardstick {t2 - t1:.1f} s, {tpl['world']} ranks "
          f"{t3 - t2:.1f} s (spawn, build, serve five architectures and train "
          f"{len(train_runs)}{', then phase 21' if prep else ''}), checks {t4 - t3:.1f} s, "
          f"kernel timing {time.perf_counter() - t4:.1f} s; the ranks' training stages (rank "
          f"0): " + ", ".join(f"{a} {sum(r[0]['stage_s'].values()):.1f} s"
                             for a, r in treports.items()))
    if prep is not None:
        rows += svtp_finish(device, prep, svtp_got, edge_errs)
    return rows


# ---------------------------------------------------------------------------
# Phase 20: the sharded train step of the other layer kinds
# ---------------------------------------------------------------------------

# inside phase 19's world, after each architecture is served: one whole
# layer pattern of each at full width, trained 2 bf16 steps (step 1 at lr 0)
# by ``launch.train.train_rank`` at phase 19's split, constant T_obj, the
# config's remat, each against the same training in one process (run in
# the parent first, then freed). ``fused`` does not train (it degrades to
# reference), so the architectures phase 19 serves on it train on
# ``pallas``. llama4 at one layer: its one-process yardstick peaks at ~58 GiB
# (~3.1 B parameters at 16 B of float32 state each, and the step). whisper trains on 1504 seeded frames ~ N(0, 1) (a multiple of
# block_seq: its encoder's sites launch the masking kernel). Bounds
# written in PERF.md before the phase first ran: phase 18's.
TPTL = dict(steps=2, lr=3e-4, loss_tol=TPT_LOSS_TOL, gnorm_tol=TPT_GNORM_TOL,
            zf_tol=TPT_ZF_TOL, mom_rel=TPT_MOM_REL)
TPTL_RUNS = {
    "granite-moe-1b-a400m": dict(backend="stream", model=2, layers=1, batch=2, seq=1024,
                                 t_obj=0.0064, site="ffn_hidden", kernels=STREAM_KERNELS),
    "llama4-scout-17b-a16e": dict(backend="pallas", model=4, layers=1, batch=1, seq=1024,
                                  t_obj=0.00038, site="ffn_hidden",
                                  kernels=("zebra_mask_kernel",)),
    "mamba2-2.7b": dict(backend="stream", model=4, layers=1, batch=1, seq=1024, t_obj=5.0,
                        site="layer_out", kernels=STREAM_KERNELS),
    "recurrentgemma-2b": dict(backend="pallas", model=4, layers=3, batch=1, seq=1024,
                              t_obj=1.5, site="ffn_hidden", kernels=("zebra_mask_kernel",)),
    "whisper-medium": dict(backend="pallas", model=4, layers=1, enc_layers=1, enc_seq=1504,
                           batch=1, seq=448, t_obj=1.55, site="ffn_hidden",
                           kernels=("zebra_mask_kernel",)),
}
TPTL_SUFFIX = " ({} tensor-parallel training, a rank)"


def tptl_config(arch: str, run: dict, reduced: bool = False):
    """The training config of one architecture's phase 20 run."""
    from repro_torch.launch import train
    cfg = train.build_config(arch, reduced=reduced, t_obj=run["t_obj"],
                             backend=run["backend"], n_layers=run["layers"])
    cfg = cfg.replace(zebra_tnet=False, grad_accum=1)
    if cfg.encoder_layers:
        cfg = cfg.replace(encoder_layers=run.get("enc_layers", cfg.encoder_layers),
                          enc_seq=run.get("enc_seq", cfg.enc_seq))
    return cfg


def tptl_argv(arch: str, run: dict, tptl: dict) -> list:
    return ["--arch", arch, "--layers", str(run["layers"]), "--batch", str(run["batch"]),
            "--seq", str(run["seq"]), "--steps", str(tptl["steps"]), "--lr", str(tptl["lr"]),
            "--compress", "bf16", "--t-obj", str(run["t_obj"]), "--backend", run["backend"],
            "--model-parallel", str(run["model"]),
            *(["--reduced", "--device", "cpu"] if tptl.get("reduced") else [])]


class TrainFrames:
    """whisper's frames for each loader step: (batch, enc_seq, d) ~ N(0, 1)
    in float32 from a generator seeded 11 + step on the device, the same in
    one process and on every rank (a rank keeps its rows)."""

    def __init__(self, cfg, batch: int, device):
        self.shape, self.device = (batch, cfg.enc_seq, cfg.d_model), device

    def __call__(self, step: int):
        import torch
        g = torch.Generator(device=self.device).manual_seed(11 + step)
        return torch.randn(self.shape, generator=g, device=self.device)


class TrainMaps:
    """The input maps of the first ``n`` forward sites of kind ``site`` the
    engine runs (a recompute inside the backward is skipped), host copies
    as its kernels get them (a rank's shard, or the gathered whole)."""

    def __init__(self, site: str, n: int):
        self.site, self.n, self.maps = site, n, []

    def __enter__(self):
        import torch
        import repro_torch.core.engine as engine
        self._engine, self._inner = engine, engine._site

        def site(x, cfg, **kw):
            if len(self.maps) < self.n and cfg.enabled and kw.get("site") == self.site and \
                    x.shape[-2] % cfg.block_seq == 0 and \
                    torch._C._current_graph_task_id() == -1:
                self.maps.append(x.detach().reshape(-1, x.shape[-1]).cpu())
            return self._inner(x, cfg, **kw)
        engine._site = site
        return self

    def __exit__(self, *exc):
        self._engine._site = self._inner


def tptl_yardstick(arch: str, run: dict, tptl: dict, device, path: str) -> dict:
    """``arch`` trained in this process at the phase's depth and batch: the
    history, the launches, the first moment after step 1 saved to
    ``path`` (``row_sample``), the peak memory."""
    import torch
    from repro_torch.kernels import launch_counters
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    cfg = tptl_config(arch, run, tptl.get("reduced", False))
    model = LM(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    frames = TrainFrames(cfg, run["batch"], device) if cfg.encoder_layers else None
    before = {k: w.launches for k, w in launch_counters().items()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with FirstMoment(copy=row_sample) as m1, yard_sums():
        model, state, hist, _ = train.train_lm(
            cfg, steps=tptl["steps"], batch=run["batch"], seq=run["seq"], lr=tptl["lr"],
            compress="bf16", seed=0, device=device, model=model, log=lambda *_: None,
            enc_feats=frames)
    torch.save(m1.m, path)
    out = {"history": hist, "launches": {k: w.launches - before[k]
                                         for k, w in launch_counters().items()},
           "peak": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0}
    del model, state, m1
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tptl_train(rank: int, arch: str, run: dict, tptl: dict, d: str) -> None:
    """One rank of one architecture's phase 20 run, in phase 19's world:
    ``launch.train.train_rank`` (frames for whisper), the first moment
    after step 1 against the yardstick's (``shard_gaps``), the shared leaf
    shards against the other ranks' (``replicated_mismatches``); rank 0
    keeps its step-1 maps of the site kind. Saves ``train_rank<r>.pt``."""
    import os

    import torch
    from repro_torch.launch import train
    from repro_torch.utils import resolve_device
    cfg = tptl_config(arch, run, tptl.get("reduced", False))
    device = resolve_device("cpu" if tptl.get("reduced") else None)
    frames = TrainFrames(cfg, run["batch"], device) if cfg.encoder_layers else None
    n_maps = cfg.n_layers + cfg.encoder_layers if rank == 0 else 0     # step 1's forward
    with TrainMaps(run["site"], n_maps) as maps, FirstMoment() as m1:
        res = train.train_rank(train.parse_args(tptl_argv(arch, run, tptl)), cfg,
                               enc_feats=frames)
    rep = dict(res["report"])
    state, model, mesh = res["state"], res["model"], res["mesh"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep["mom_gaps"] = shard_gaps(m1.m, os.path.join(d, "yard_m1.pt"), model.train_places,
                                 mesh, device)
    rep["mom_s"] = time.perf_counter() - t0 + m1.s
    rep["replicated"] = replicated_mismatches(state["params"], model.train_places, mesh)
    rep["maps"] = maps.maps
    del res, state, model, m1
    torch.save(rep, os.path.join(d, f"train_rank{rank}.pt"))


def hold_tptl_run(arch: str, run: dict, ranks: list, yard: dict, tptl: dict) -> None:
    """One architecture's sharded training against its one-process run:
    the mesh, the ranks' metrics alike, the losses within ``loss_tol``,
    ``grad_norm`` within ``gnorm_tol``, the zero fraction (its one site
    kind) within ``zf_tol``, the first moment after step 1 per leaf within
    ``mom_rel`` (||Δ|| / ||m|| over every rank's shards), the shared leaf
    shards bit for bit alike, and on the card every rank's launches equal
    to one process's, each kernel of the path launched. Every reading is
    printed before the first check that fails raises (a fault reading
    shows each)."""
    label = f"{arch} sharded training"
    failed = []

    def later(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)
    m = run["model"]
    data = len(ranks) // m
    check(sorted((r["data_index"], r["model_index"]) for r in ranks) ==
          [(d, i) for d in range(data) for i in range(m)], f"{label}: mesh")
    keys = ("loss", "ce", "zero_frac", "zebra_reg", "router_aux", "grad_norm", "measured_bytes")
    hists = [r["history"] for r in ranks]
    check(all([[h[k] for k in keys] for h in hs] == [[h[k] for k in keys] for h in hists[0]]
              for hs in hists), f"{label}: the ranks' metrics differ")
    for h, h1 in zip(hists[0], yard["history"]):
        dl, dg = abs(h["loss"] - h1["loss"]), abs(h["grad_norm"] / h1["grad_norm"] - 1)
        dz = abs(h["zero_frac"] - h1["zero_frac"])
        print(f"  {label} step {h['step']}: loss {h['loss']:.6f} (one process "
              f"{h1['loss']:.6f}), grad_norm {h['grad_norm']:.6f} ({h1['grad_norm']:.6f}), "
              f"{run['site']} zero fraction {h['zero_frac']:.6f} ({h1['zero_frac']:.6f}), "
              f"router_aux {h['router_aux']:.6f} ({h1['router_aux']:.6f}), "
              f"{h['measured_bytes']} B ({h1['measured_bytes']} B), {h['ms']:.1f} ms (one "
              f"process {h1['ms']:.1f} ms; host clock, rank 0)")
        later(dl <= tptl["loss_tol"], f"{label} step {h['step']}: loss off by {dl}")
        later(dg <= tptl["gnorm_tol"], f"{label} step {h['step']}: grad_norm off by "
                                       f"{100 * dg:.3f} %")
        later(dz <= tptl["zf_tol"], f"{label} step {h['step']}: zero fraction off by {dz}")
    gaps = {}
    for r in ranks:
        for name, (d2, w2, top) in r["mom_gaps"].items():
            g = gaps.setdefault(name, [0.0, 0.0, 0.0])
            g[0], g[1], g[2] = g[0] + d2, g[1] + w2, max(g[2], top)
    rel = {n: (d2 / w2 if w2 else d2) ** 0.5 for n, (d2, w2, _) in gaps.items()}
    order = sorted(rel, key=rel.get)
    print(f"  {label}: first moment after step 1 against one process's, ||Δ|| / ||m|| of "
          f"each of {len(rel)} leaves: worst {rel[order[-1]]:.3e} ({order[-1]}), median "
          f"{rel[order[len(order) // 2]]:.3e} (bound {tptl['mom_rel']} on the worst); the "
          f"five worst: " + ", ".join(f"{n} {rel[n]:.3e}" for n in order[-5:]))
    later(rel[order[-1]] <= tptl["mom_rel"], f"{label}: the first moment of {order[-1]} is "
                                             f"{rel[order[-1]]:.3e} off one process's")
    compared = [r["replicated"][0] for r in ranks]
    bad = [b for r in ranks for b in r["replicated"][1]]
    print(f"  {label}: shared leaf shards compared bit for bit: {compared} a rank, "
          f"{len(bad)} differ")
    later(not bad and min(compared) > 0, f"{label}: shared leaves differ: {bad[:4]}")
    want = {k: yard["launches"][k] for k in run["kernels"]}
    for r in ranks:
        got = {k: r["launches"][k] for k in run["kernels"]}
        if not tptl.get("reduced"):
            later(got == want and min(got.values()) > 0,
                  f"{label} rank {r['rank']}: launches {got}, one process {want}")
    r0 = ranks[0]
    tp, dp = r0["tp_per_step"], r0["dp_per_step"]
    print(f"  {label}: launches by rank {[[r['launches'][k] for k in run['kernels']] for r in ranks]}"
          f" (one process {list(want.values())}; forward and remat recompute); "
          f"max_memory_allocated by rank "
          f"{[round(r['max_memory_allocated'] / 2 ** 30, 3) for r in ranks]} GiB (one process "
          f"{yard['peak'] / 2 ** 30:.3f} GiB); collectives a step, rank 0: tensor-parallel "
          f"forward {tp['calls']:.0f} calls, {tp['bytes'] / 2 ** 20:.1f} MiB, backward "
          f"{tp['bwd_calls']:.0f} calls, {tp['bwd_bytes'] / 2 ** 20:.1f} MiB; data-parallel "
          f"{dp['calls']:.0f} calls, {dp['bytes'] / 2 ** 20:.1f} MiB; rank 0's stages: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in r0["stage_s"].items()))
    check(not failed, "; ".join(failed))


def time_tptl_kernels(arch: str, run: dict, maps: list, launches: dict, device) -> list[dict]:
    """The kernel rows of one architecture's phase 20 run: its kernels held
    bit for bit against their plain versions on rank 0's step-1 maps (a
    step's forward sites) and timed."""
    import torch
    lm = {"maps": [(x.to(device), None) for x in maps], "t_obj": run["t_obj"],
          "launches": launches}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)
    print(f"{arch} sharded training kernel times per step, a rank ({len(maps)} {run['site']} "
          f"maps of rank 0's step 1, {tuple(maps[0].shape)} first):")
    rows = time_lm_stream_kernels(lm, flush, {f"{k}{TPTL_SUFFIX.format(arch)}": (k, "ffn")
                                              for k in run["kernels"]})
    del lm, flush
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 21: continuous serving under tensor parallelism
# ---------------------------------------------------------------------------

# one world of 4 ranks at (data 1, model 4); granite's job of SVTP_DATA's
# tag again at (data 2, model 2), the decode lanes split over ``data``
SVTP = dict(world=4, model=4)
SVTP_DATA = dict(tag="granite_d2", model=2)
# the counters of a continuous run that depend on the requests' lengths
# alone: every rank's must equal one process's
SVTP_COUNTERS = ("n_requests", "n_rejected", "n_shed", "deadline_misses", "steps", "evictions",
                 "kv_pages", "pages_recovered", "crash_recoveries", "decode_shapes",
                 "prefill_shapes")
# granite at phase 15's trace shape and 2 of its 24 layers on ``stream``
# (a tick over 4 ranks costs ~9 ms a collective, two a layer), (data 1,
# model 4): its 8 KV heads of 64 split two a rank, on the 128-wide block
# edges. Pages of 256: a stack without local layers has its cache floor at
# the page, and both engines need a prefill bucket (up to 256 here) inside
# the floor (ROADMAP.md, section 3)
SVTP_GRANITE = dict(arch="granite-moe-1b-a400m", layers=2, backend="stream", t_obj=0.0064,
                    page_tokens=256)
SVTP_ZF_TOL = 1e-3
SVTP_SUFFIX = " ({} tensor-parallel continuous{}, a rank)"


def engine_yardstick(argv: list, eng, rep: dict, rec, launches: dict) -> dict:
    """A one-process continuous run on the host, as phase 21 holds the
    ranks against it: the CLI arguments, every request's status, shed
    reason and tokens, the logits rows the tokens were chosen from
    (``StepRecorder``), the report, the launches and the pool's
    counters."""
    from repro_torch.launch.serve import POOL_COUNTERS
    return {"argv": list(argv),
            "requests": {r.rid: (r.status, r.shed_reason, list(r.out))
                         for r in eng.scheduler.completed},
            "rows": {rid: [x[0].cpu() for x in rows] for rid, rows in rec.rows.items()},
            "report": {k: v for k, v in rep.items() if not isinstance(v, (dict, list))},
            "launches": dict(launches),
            "pool": {k: getattr(eng.pool, k) for k in POOL_COUNTERS}}


class BucketMaps:
    """On one rank (``on``): a host copy of the ``ffn_hidden`` maps its
    kernels get (a rank's columns on block edges, a rank's experts' rows,
    or the gathered whole), with the weight the site consumes (None for a
    masked map), ``n`` sites each: ``maps`` those of the first prefill of
    each row count, ``decode`` those of the first decode step at each
    batch bucket."""

    def __init__(self, on: bool, n: int):
        self.on, self.n, self.maps, self.decode = on, n, {}, {}

    def __enter__(self):
        import repro_torch.core.engine as engine
        import repro_torch.serve.engine as serve_engine
        self._engine, self._inner = engine, engine._site
        self._serve, self._step = serve_engine.ServeEngine, serve_engine.ServeEngine._step
        if not self.on:
            return self
        at = {}

        def step(eng, now):
            at["Bb"] = eng._Bb
            try:
                return self._step(eng, now)
            finally:
                del at["Bb"]

        def site(x, cfg, **kw):
            w = kw.get("w")
            rows = x.shape[-2]
            got = (self.decode.setdefault(at["Bb"], []) if "Bb" in at
                   else self.maps.setdefault(rows, []))
            if cfg.enabled and kw.get("site") == "ffn_hidden" and rows % cfg.block_seq == 0 \
                    and len(got) < self.n:
                got.append((x.detach().reshape(-1, x.shape[-1]).cpu(),
                            None if w is None else w.detach().cpu()))
            return self._inner(x, cfg, **kw)
        engine._site, self._serve._step = site, step
        return self

    def __exit__(self, *exc):
        self._engine._site = self._inner
        self._serve._step = self._step


def svtp_rank(rank: int, out_dir: str, jobs: list) -> None:
    """One rank of phase 21 (spawned, in the joined world): each job
    ``(tag, argv, keep, model ranks)`` served by ``launch.serve.main`` with
    ``--requests`` and ``--model-parallel``, which inside the world serves
    as this rank (``serve_rank``; at 2 model ranks of 4, data 2) and saves
    its report to
    ``<out_dir>/<tag>/``; rank 0 also saves the logits rows its tokens
    were chosen from and, where ``keep`` ("maps" or "lanes"), its
    ffn_hidden maps of one prefill a row count and one decode step a
    bucket, and every rank, where ``keep`` is "lanes", its heads of lane 0
    of the hot set at the end (the pages its pool packed)."""
    import os

    import torch
    from repro_torch.launch import serve
    for tag, argv, keep, model in jobs:
        d = os.path.join(out_dir, tag)
        os.makedirs(d, exist_ok=True)
        layers = int(argv[argv.index("--layers") + 1])
        with StepRecorder() as rec, BucketMaps(rank == 0 and bool(keep), layers) as maps:
            out = serve.main([*argv, "--model-parallel", str(model), "--save", d])
        if rank == 0:
            torch.save({"rows": {rid: [x[0].cpu() for x in rows]
                                 for rid, rows in rec.rows.items()},
                        "maps": maps.maps, "decode": maps.decode}, os.path.join(d, "rows.pt"))
        if keep == "lanes":
            lane = [x.cpu() for x in _tensors(out["engine"]._take_lane(0))]
            torch.save(lane, os.path.join(d, f"lane{rank}.pt"))
        del out, rec, maps
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def check_page_band(records, label: str) -> None:
    """Every compressed page's bytes inside the Eq. 2/3 band, in exact
    rationals: its payload the live share of its dense bytes, its index
    within one byte above a bit a block."""
    from fractions import Fraction
    for site, payload, index, dense, live, nb in records:
        if nb == 0:
            continue
        check(Fraction(payload) == Fraction(dense * live, nb)
              and 0 <= index - Fraction(nb, 8) < 1,
              f"{label}: page {site}: {payload} + {index} B vs Eq. 2/3 at {live} of {nb} "
              f"blocks")


def hold_svtp_run(label: str, ranks: list, rows0: dict, yard: dict,
                  launch_checks: bool = True) -> dict:
    """Phase 21's checks of one run: every rank's requests, tokens,
    counters, meter records and launches alike; the tokens against one
    process's under the near-tie rule; the length-only counters equal to
    one process's; every page in the Eq. 2/3 band; the zero fraction
    within SVTP_ZF_TOL of one process's; every kernel launched on each
    rank as often as in one process (kernel 5 once a compressed page out,
    3 once a page in beside the prefills' and decode's expansions).
    Returns the run's figures."""
    from repro_torch.kernels import launch_counters
    r0 = ranks[0]
    names = set(launch_counters())
    for r in ranks:
        who = f"{label} rank {r['rank']}"
        check(r["requests"] == r0["requests"], f"{who}: requests or tokens differ from rank 0's")
        check(r["records"] == r0["records"], f"{who}: meter records differ from rank 0's")
        check({k: r["report"][k] for k in SVTP_COUNTERS + ("zero_frac", "kv_bytes_measured")}
              == {k: r0["report"][k] for k in SVTP_COUNTERS + ("zero_frac",
                                                               "kv_bytes_measured")},
              f"{who}: counters differ from rank 0's")
        check_page_band(r["records"], who)
        if not launch_checks:
            continue
        got = {k: v for k, v in r["phases"]["serve"].items() if k in names}
        pool = r["pool"]
        check(got.get("zebra_pack", 0) == pool["n_pages_out"],
              f"{who}: kernel 5 launched {got.get('zebra_pack', 0)} times for "
              f"{pool['n_pages_out']} compressed pages out")
        want = {k: v for k, v in yard["launches"].items() if k in names}
        check(got == want, f"{who}: launches {got} != one process's {want}")
    for k in SVTP_COUNTERS:
        check(r0["report"][k] == yard["report"][k],
              f"{label}: {k} {r0['report'][k]} != one process's {yard['report'][k]}")
    dzf = abs(r0["report"]["zero_frac"] - yard["report"]["zero_frac"])
    check(dzf <= SVTP_ZF_TOL, f"{label}: zero fraction {r0['report']['zero_frac']} vs one "
                              f"process's {yard['report']['zero_frac']}")
    div = []
    check(set(r0["requests"]) == set(yard["requests"]), f"{label}: other requests completed")
    for rid, (status, reason, toks) in sorted(r0["requests"].items()):
        ys, yr, ytoks = yard["requests"][rid]
        check((status, reason) == (ys, yr), f"{label}: request {rid} {status} vs {ys}")
        d = near_tie(f"{label} request {rid}", (ytoks, yard["rows"].get(rid, [])),
                     (toks, rows0.get(rid, [])))
        if d is not None:
            div.append(dict(d, rid=rid))
    n_tok = sum(len(t) for _, _, t in r0["requests"].values())
    rep = r0["report"]
    steps = max(rep["steps"], 1)
    fig = {"tokens": n_tok, "divergences": div, "zero_frac_delta": dzf,
           "tokens_per_s": rep["tokens_per_s"], "p50_token_ms": rep["p50_token_ms"],
           "p95_token_ms": rep["p95_token_ms"], "wall_s": rep["wall_s"],
           "one_process_wall_s": yard["report"]["wall_s"],
           "page_out_us": [1e6 * r["pool"]["seconds_out"] / max(r["pool"]["n_pages_out"], 1)
                           for r in ranks],
           "page_in_us": [1e6 * r["pool"]["seconds_in"] / max(r["pool"]["n_pages_in"], 1)
                          for r in ranks],
           "one_process_page_out_us": 1e6 * yard["pool"]["seconds_out"]
           / max(yard["pool"]["n_pages_out"], 1),
           "one_process_page_in_us": 1e6 * yard["pool"]["seconds_in"]
           / max(yard["pool"]["n_pages_in"], 1),
           "tp_calls_per_tick": r0["phases"]["serve"]["tp_calls"] / steps,
           "tp_bytes_per_tick": r0["phases"]["serve"]["tp_bytes"] / steps,
           "peak_gib": [r["max_memory_allocated"] / 2 ** 30 for r in ranks],
           "build_peak_gib": [r["build_peak_memory"] / 2 ** 30 for r in ranks]}
    print(f"  {label}: {rep['n_requests']} requests, {n_tok} tokens, {rep['steps']} ticks, "
          f"{rep['evictions']} evictions, {rep['kv_pages']} pages "
          f"({r0['pool']['n_pages_out']} compressed out, {r0['pool']['n_pages_in']} in a "
          f"rank), zero fraction {rep['zero_frac']:.6f} (one process "
          f"{yard['report']['zero_frac']:.6f}), {rep['kv_bytes_measured']} B; every rank alike "
          f"and the counters equal to one process's; {len(div)} requests diverged, each a "
          f"near tie{': ' + str(div) if div else ''}")
    print(f"    wall {rep['wall_s']:.3f} s (one process {yard['report']['wall_s']:.3f} s): "
          f"{rep['tokens_per_s']:.2f} tokens/s, p50 {rep['p50_token_ms']:.3f} ms, p95 "
          f"{rep['p95_token_ms']:.3f} ms a token (host clock); host µs a page out "
          f"{[round(x, 1) for x in fig['page_out_us']]}, in "
          f"{[round(x, 1) for x in fig['page_in_us']]} by rank (one process "
          f"{fig['one_process_page_out_us']:.1f} / {fig['one_process_page_in_us']:.1f}); "
          f"{fig['tp_calls_per_tick']:.1f} tensor-parallel collectives a tick "
          f"({fig['tp_bytes_per_tick'] / 1e6:.3f} MB a rank); peak memory "
          f"{[round(x, 2) for x in fig['peak_gib']]} GiB by rank (build "
          f"{[round(x, 2) for x in fig['build_peak_gib']]})")
    return fig


def time_svtp_kernels(arch: str, rows0: dict, lanes: list, launches: dict, t_obj: float,
                      edge_errs: dict, device) -> list[dict]:
    """Phase 21's kernel rows: kernels 1, 2 and 7 on rank 0's ffn_hidden
    maps of one prefill at the largest bucket (its d_ff columns with its
    rows of ``w_down``), per prefill; kernels 5 and 3 on the pages a rank
    packs (the K/V heads gathered: every rank's heads of lane 0, whole),
    per page, each held bit for bit against its plain version and timed."""
    import torch
    from repro_torch.serve import PagedKVPool
    pb = max(k for k, v in rows0["maps"].items() if v)
    maps = rows0["maps"][pb]
    suffix = SVTP_SUFFIX.format(arch, f" prefill {pb}")
    lm = {"arch": arch, "t_obj": t_obj, "launches": launches, "replay_launches": {},
          "maps": [(x.to(device), None if w is None else w.to(device)) for x, w in maps]}
    print(f"{arch} tensor-parallel continuous kernel times, a rank ({len(maps)} ffn_hidden "
          f"maps {tuple(maps[0][0].shape)} of a {pb}-token prefill):")
    rows = time_lm_kernels(lm, edge_errs, device, gemms=("zebra_spmm_cs_kernel",),
                           codec=False, suffix=suffix,
                           stream_rows={f"{k}{suffix}": (k, "ffn") for k in
                                        ("zebra_bitmap_kernel", "zebra_pack_kernel")})
    del lm
    lane = [torch.cat(parts, dim=-2).to(device) for parts in zip(*lanes)]
    pool = PagedKVPool(page_tokens=SV["page_tokens"], validation="structural")
    pool.page_out("lane", lane)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    page_rows, n = time_page_kernels(pool, lane, flush)
    for k, r in page_rows.items():
        rows.append({"name": f"{k}{SVTP_SUFFIX.format(arch, ', per page')}", "route": "cuda",
                     "source": SOURCE, "replaces": {**LM_KERNELS, **KERNELS}[k],
                     "launches": launches[k], **{f: v / n for f, v in r.items()},
                     "bound_by": "bytes", "library_ms": None, "pages_timed": n})
    del flush, pool, lane
    torch.cuda.empty_cache()
    return rows


def time_svtp_data_kernels(arch: str, rows0: dict, launches: dict, t_obj: float,
                           device) -> list[dict]:
    """The (data 2, model 2) job's kernel rows: kernels 1-3 held bit for bit
    against their plain versions on rank 0's ffn_hidden maps (its experts'
    dispatch rows at 2 model ranks) and timed, summed per prefill at the
    largest row count and per decode step at the largest bucket the lanes
    split over ``data``."""
    import torch
    bb = max(b for b, v in rows0["decode"].items() if v and b % 2 == 0)
    pb = max(k for k, v in rows0["maps"].items() if v)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=device)   # 256 MB
    rows = []
    for maps, what in ((rows0["maps"][pb], f"prefill of {pb} dispatch rows"),
                       (rows0["decode"][bb], f"decode step at {bb} lanes, {bb // 2} a rank")):
        lm = {"maps": [(x.to(device), None) for x, _ in maps], "t_obj": t_obj,
              "launches": launches}
        suffix = SVTP_SUFFIX.format(arch, f" at (data 2, model 2), {what}")
        print(f"{arch} at (data 2, model 2) kernel times, a rank ({len(maps)} ffn_hidden maps "
              f"{tuple(maps[0][0].shape)} of a {what}):")
        rows += time_lm_stream_kernels(lm, flush, {f"{k}{suffix}": (k, "ffn")
                                                   for k in STREAM_KERNELS})
        del lm
    del flush
    torch.cuda.empty_cache()
    return rows


def svtp_prepare(device, g3_yard: dict, granite=SVTP_GRANITE, **over) -> dict:
    """Phase 21 before its ranks: granite-moe-1b-a400m served in this
    process at phase 15's trace shape (its yardstick) and the jobs the
    ranks serve (:func:`svtp_rank`): gemma3-4b with phase 15's arguments
    (``g3_yard``, :func:`engine_yardstick`), then granite at (data 1,
    model 4) and again at (data 2, model 2) (``SVTP_DATA``), both held
    against the same yardstick. ``over``
    replaces the granite run's prompt, gen, requests, T_obj, pages and
    depth and, with ``reduced=True`` on the CPU, rehearses the flow on the
    reduced configs."""
    import torch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    g = dict(granite)
    tail = ["--reduced", "--device", "cpu"] if over.get("reduced") else []
    gv = ["--arch", g["arch"], "--backend", g["backend"], "--requests",
          str(over.get("requests", SV["requests"])), "--slots", str(SV["slots"]),
          "--prompt-len", str(over.get("prompt", SV["prompt"])), "--gen",
          str(over.get("gen", SV["gen"])), "--t-obj", str(over.get("t_obj", g["t_obj"])),
          "--preempt-after", str(SV["preempt_after"]), "--page-tokens",
          str(over.get("page_tokens", g["page_tokens"])), "--layers",
          str(over.get("layers", g["layers"])), *tail]
    print(f"tensor-parallel continuous serving (phase 21): {SVTP['world']} ranks on the "
          f"{'card' if device.type == 'cuda' else 'CPU'} at (data 1, model {SVTP['model']}), "
          f"{g['arch']} again at (data {SVTP['world'] // SVTP_DATA['model']}, model "
          f"{SVTP_DATA['model']})")
    print(f"  {g['arch']} in one process: python -m repro_torch.launch.serve {' '.join(gv)}")
    with StepRecorder() as rec, yard_sums():
        reset_launch_counts()
        out = serve.main(gv)
        launches = launch_counts()
    g_yard = engine_yardstick(gv, out["engine"], out["report"], rec, launches)
    del out, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    card = device.type == "cuda"
    jobs = [("gemma3", g3_yard["argv"], "lanes" if card else "", SVTP["model"]),
            ("granite", gv, "", SVTP["model"]),
            (SVTP_DATA["tag"], gv, "maps", SVTP_DATA["model"])]
    for _, argv, _, model in jobs:
        print(f"  python -m repro_torch.launch.serve {' '.join(argv)} --model-parallel {model}")
    return {"jobs": jobs, "yards": {"gemma3": g3_yard, "granite": g_yard,
                                    SVTP_DATA["tag"]: g_yard},
            "yard_s": time.perf_counter() - t0}


def hold_svtp_lanes(label: str, ranks: list) -> list[dict]:
    """The (data 2, model 2) job's lanes: each rank held ``Bb / 2`` lanes
    of a hot set of ``Bb`` where 2 divides it and all ``Bb`` elsewhere,
    and some bucket was split. Prints each rank's lanes by bucket, rank
    0's launches, its stages' seconds, every rank's peak memory and the
    traffic over ``data``; returns the lanes by rank."""
    lanes = [r["hot_lanes"] for r in ranks]
    for r in ranks:
        who = f"{label} rank {r['rank']}"
        want = {b: b // 2 if b % 2 == 0 else b for b in r["hot_lanes"]}
        check(r["hot_lanes"] == want, f"{who}: lanes {r['hot_lanes']} by bucket, not {want}")
        check(any(b % 2 == 0 for b in r["hot_lanes"]), f"{who}: no bucket split over data")
    print(f"  {label}: lanes a rank by batch bucket " + "; ".join(
        f"rank {r['rank']} (data {r['data_index']}, model {r['model_index']}) "
        f"{r['hot_lanes']}" for r in ranks))
    from repro_torch.kernels import launch_counters
    r0 = ranks[0]
    steps = max(r0["report"]["steps"], 1)
    serve = r0["phases"]["serve"]
    names = set(launch_counters())
    print(f"    launches a rank (rank 0; the same on each, as in one process): "
          f"{ {k: v for k, v in serve.items() if k in names and v} }")
    print(f"    the job's seconds on rank 0: " + " / ".join(
        f"{k} {v:.1f} s" for k, v in r0["stage_s"].items())
        + f" ({sum(r0['stage_s'].values()):.1f} s); peak memory a rank "
        f"{[r['max_memory_allocated'] for r in ranks]} B; over data a rank "
        f"{serve['dp_calls'] / steps:.2f} collectives, {serve['dp_bytes'] / steps:.0f} B a "
        f"tick (the port's own: the tokens gathered, the lanes broadcast); broadcasts of "
        f"lanes from their holder "
        f"{[r['lane_broadcasts'] for r in ranks]}, host ms each "
        f"{[round(1e3 * r['seconds_broadcast'] / max(r['lane_broadcasts'], 1), 3) for r in ranks]}")
    return lanes


def svtp_load(out_dir: str, jobs: list) -> dict:
    """The ranks' phase 21 results on the host, by job."""
    import os

    import torch
    got = {}
    for tag, _, keep, _ in jobs:
        d = os.path.join(out_dir, tag)
        got[tag] = {"ranks": [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                              for r in range(SVTP["world"])],
                    "rows0": torch.load(os.path.join(d, "rows.pt"), weights_only=False),
                    "lanes": [torch.load(os.path.join(d, f"lane{r}.pt"))
                              for r in range(SVTP["world"])] if keep == "lanes" else None}
    return got


def svtp_finish(device, prep: dict, got: dict, edge_errs: dict) -> list[dict]:
    """Phase 21 after its ranks: each run held by :func:`hold_svtp_run`,
    then the kernel rows on rank 0's maps and a rank's pages."""
    t0 = time.perf_counter()
    figs = {}
    for tag, yard in prep["yards"].items():
        arch = yard["argv"][yard["argv"].index("--arch") + 1]
        ranks = got[tag]["ranks"]
        at = "" if tag != SVTP_DATA["tag"] else " at (data 2, model 2)"
        figs[tag] = hold_svtp_run(f"{arch} tensor-parallel continuous{at}", ranks,
                                  got[tag]["rows0"]["rows"], yard,
                                  launch_checks=device.type == "cuda")
        if at:
            figs[tag]["hot_lanes"] = hold_svtp_lanes(f"{arch}{at}", ranks)
    t1 = time.perf_counter()
    rows = []
    if device.type == "cuda":
        g3 = got["gemma3"]
        rows = time_svtp_kernels(LM_ARCH, g3["rows0"], g3["lanes"],
                                 g3["ranks"][0]["phases"]["serve"], SV["t_obj"], edge_errs,
                                 device)
        gd = got[SVTP_DATA["tag"]]
        yard = prep["yards"][SVTP_DATA["tag"]]["argv"]
        rows += time_svtp_data_kernels(yard[yard.index("--arch") + 1], gd["rows0"],
                                       gd["ranks"][0]["phases"]["serve"],
                                       float(yard[yard.index("--t-obj") + 1]), device)
    print(f"  phase 21 times: granite in one process {prep['yard_s']:.1f} s, checks "
          f"{t1 - t0:.1f} s, kernel timing {time.perf_counter() - t1:.1f} s; the ranks' "
          f"stages (rank 0): " + ", ".join(
              f"{tag} " + " / ".join(f"{k} {v:.1f} s" for k, v in
                                     got[tag]["ranks"][0]["stage_s"].items())
              for tag in got))
    print(f"  phase 21 figures: {json.dumps(figs)}")
    return rows


def _tensors(tree) -> list:
    from repro_torch.utils import map_tree
    out = []
    map_tree(lambda _, leaf: out.append(leaf), tree)
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"card: {card}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        # bitwise stream-vs-reference logits need one convolution algorithm
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.load_library()
        print(f"build: {time.perf_counter() - t0:.1f} s into {build.build_dir()}")
        for log in sorted(build.build_dir().glob("*.log")):
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  ptxas: {line.strip()}")

        print("kernels vs plain versions on the card:")
        t0 = time.perf_counter()
        edge_cases(device)
        with torch.inference_mode():
            lm_errs = lm_edge_cases(device)
        t1 = time.perf_counter()
        trained, train_launches, mask_maps = run_training(device)
        launches, maps = run_slice(device, trained)
        kernels = time_kernels(
            [(STREAM_KERNELS, maps, launches),
             (("zebra_mask_kernel",), mask_maps, train_launches)],
            device)
        del mask_maps, maps
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        for name in ZOO:
            kernels += run_zoo(device, name)
            torch.cuda.empty_cache()
        t3 = time.perf_counter()
        with torch.inference_mode():
            lm = run_lm(device)
            kernels += time_lm_kernels(lm, lm_errs, device)
            tp_yard = tp_yardstick(lm)      # phase 17's yardstick, on the host
        off_tokens = lm["tokens"]
        del lm
        torch.cuda.empty_cache()
        t4 = time.perf_counter()
        with torch.inference_mode():
            lm = run_lm(device, **SC2)
            kernels += time_lm_kernels(lm, lm_errs, device, gemms=("zebra_spmm_cs_kernel",),
                                       codec=False, stream_rows=SC2_STREAM_ROWS)
            del lm
            torch.cuda.empty_cache()
            t5 = time.perf_counter()
            for arch, field in ARCH_RUNS.items():
                print(f"{arch}: the 2-layer run that exercises {field}")
                lm = run_lm(device, arch, zf_band=None, profile=False, **ARCH_RUN)
                print(f"  {arch} ({field}): 2 payload GEMM launches per prefill; greedy "
                      f"tokens {lm['agree']} of {lm['tokens'].numel()} == reference; warm "
                      f"prefill {lm['warm_ms'][0]:.3f} ms, decode {lm['warm_ms'][1]:.3f} "
                      f"ms/token")
                del lm
                torch.cuda.empty_cache()
        t6 = time.perf_counter()
        with torch.inference_mode():
            run_validated_slice(device, trained)
            run_detection(device)
            run_lm_validated(device, off_tokens)
        torch.cuda.empty_cache()
        t7 = time.perf_counter()
        kernels += run_lm_training(device)
        torch.cuda.empty_cache()
        t8 = time.perf_counter()
        run_lm_depth(device)
        torch.cuda.empty_cache()
        kernels += run_lm_ckpt(device)
        # no reference cycle holds device memory: a full collection frees
        # nothing (llama4's 18 layers need all but 4.4 GiB of the card)
        held = torch.cuda.memory_allocated(device)
        gc.collect()
        check(torch.cuda.memory_allocated(device) == held,
              f"gc.collect() freed {held - torch.cuda.memory_allocated(device)} B of device "
              f"memory held in reference cycles")
        torch.cuda.empty_cache()
        print(f"memory allocated before the MoE phases: {held / 2 ** 30:.2f} GiB, none of "
              f"it in reference cycles; phases 12-13 on {card_line()}")
        t9 = time.perf_counter()
        with torch.inference_mode():
            kernels += run_moe_serve(device, **GRANITE, zf_band=(0.5, 0.8), validated=True)
            kernels += run_moe_serve(device, **LLAMA4, backend="fused")
        kernels += run_moe_training(device)
        torch.cuda.empty_cache()
        t10 = time.perf_counter()
        with torch.inference_mode():
            kernels += run_whisper_serve(device, lm_errs)
        run_whisper_training(device)
        torch.cuda.empty_cache()
        print(f"the scanned local attention: {LM_ARCH} at full width, {SCAN['layers']} "
              f"layers, batch {SCAN['batch']} x {SCAN['seq']} in {SCAN['grad_accum']} "
              f"microbatches, reference, no remat")
        run_scanned(device)
        torch.cuda.empty_cache()
        t11 = time.perf_counter()
        kernels += run_recurrent(device, lm_errs)
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        g3_yard = {}                        # phase 21's one-process yardstick
        with torch.inference_mode(), yard_sums():
            kernels += run_continuous(device, lm_errs, layers=SV_LAYERS, yard=g3_yard)
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        kernels += run_collectives(device)
        torch.cuda.empty_cache()
        t14 = time.perf_counter()
        with torch.inference_mode():
            kernels += run_tensor_parallel(device, tp_yard, lm_errs)
        del tp_yard
        torch.cuda.empty_cache()
        t15 = time.perf_counter()
        kernels += run_sharded_training(device)
        torch.cuda.empty_cache()
        t16 = time.perf_counter()
        kernels += run_tp_layers(device, lm_errs, g3_yard=g3_yard)    # and phase 21
        del g3_yard
        torch.cuda.empty_cache()
        t17 = time.perf_counter()
        print(f"phase times: edge cases {t1 - t0:.1f} s, CNN {t2 - t1:.1f} s, "
              f"CNN zoo {t3 - t2:.1f} s, LM {t4 - t3:.1f} s, starcoder2-15b {t5 - t4:.1f} s, "
              f"arch runs {t6 - t5:.1f} s, validated {t7 - t6:.1f} s, "
              f"LM training {t8 - t7:.1f} s, remat and checkpoints {t9 - t8:.1f} s, "
              f"MoE {t10 - t9:.1f} s, whisper and scanned {t11 - t10:.1f} s, "
              f"mamba2 and recurrentgemma {t12 - t11:.1f} s, continuous serving "
              f"{t13 - t12:.1f} s, collectives {t14 - t13:.1f} s, tensor-parallel "
              f"serving {t15 - t14:.1f} s, sharded training {t16 - t15:.1f} s, "
              f"tensor-parallel layer kinds, served and trained, and continuous "
              f"tensor-parallel serving {t17 - t16:.1f} s")
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
