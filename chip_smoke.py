#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --engine-only [RUNS]
    python3 chip_smoke.py --fleet-only [RUNS]
    python3 chip_smoke.py --disagg-only [RUNS]
    python3 chip_smoke.py --hier-only
    python3 chip_smoke.py --tp-only
    python3 chip_smoke.py --tp-fleet-only
    python3 chip_smoke.py --sp-only
    python3 chip_smoke.py --ep-only
    python3 chip_smoke.py --job-only
    python3 chip_smoke.py --elastic-only
    python3 chip_smoke.py --loop-only
    python3 chip_smoke.py --autotune-only
    python3 chip_smoke.py --zoo-only
    python3 chip_smoke.py --harness-only
    python3 chip_smoke.py --examples-only

Phases, each fatal on failure (exit code 1, no result line):

1. device: torch/CUDA versions and the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build: every kernel source of the port, one ``nvcc`` per source, all
   started together;
3. kernels: K4 (paged decode, a split-K kernel and a merge kernel)
   against its plain PyTorch version over a sweep of head dims, page
   sizes and lengths on the edges of its row chunks, bit for bit the
   same on a second launch, then at the serving path's shapes and at a
   long-context geometry (32 slots of up to 2048 keys), float32 and
   bfloat16, with all 12 heads and with a tensor-parallel rank's 6 and 3
   (tp = 2 and 4), with its time, its kernels' profiled device time, the
   plain version's time, a library yardstick's and the least time the
   card could take (bytes over the HBM peak or operations over the peak
   rate, whichever is larger);
4. flash: K1-K3 (flash forward, dQ, dK/dV) against their plain versions
   over a sweep (causal and not, square and rectangular, offset causal,
   lengths off the 64- and 128-row tiles, head dims 8-128, f32 and bf16,
   strided views), then at the training slice's shapes (B=8, L=2048,
   H=12, D=64, causal, bf16), with the same four times each;
5. conv_bn: K5 (fused 1x1 conv + BatchNorm statistics) against its
   plain version over a sweep (rows off the tile, K 8-2048, prologue on
   and off with positive shifts, strided NHWC views, f32 and bf16), then
   at ResNet-50's 16 1x1 shapes (batch 64, 224^2, bf16) and Inception
   V3's 19 (batch 64, 299^2, bf16), with the four times each and their
   sums over one training step's 36 and 40 launches;
6. training: the bench lane's data-parallel step at GPT-2-small width
   (12 layers, d_model 768, 12 heads, vocab 32000, seq 2048, batch 8,
   bf16 compute, random weights from a seed) on flash attention, Adam
   1e-4 under ``DistributedOptimizer``, an NCCL world of one, a few
   steps on one fixed batch: the losses are finite and fall, K1 ran 12
   times per forward pass and K2/K3 12 times per backward pass, the
   NCCL bucket collectives equal the bucket plan times the steps (the
   buckets start from gradient hooks during the backward pass), and
   one step with dense attention at batch 2 matches flash's loss and
   gradient norm; then, from the same weights: the fused cross-entropy
   (``fused_ce``, no [B, L, vocab] logits) matches the unfused loss and
   gradient norm, with both peak memories; a ``remat`` + ``fused_ce``
   step runs K1 24 times (each block's forward again in the backward)
   and K2/K3 12 times; three hook-mode steps equal three steps with
   overlap off bit for bit, with the plan's collectives each step; and
   three ZeRO-1 steps equal them, with two collectives a dtype group a
   step;
7. resnet: the image bench lane's step, ResNet-50 at full width with the
   JAX lane's defaults (224^2 synthetic images, 64 per card, 1000
   classes, bf16, SGD 0.01 momentum 0.9 under ``DistributedOptimizer``)
   with ``fused_bn``, an NCCL world of one, a few steps on one fixed
   batch: the losses are finite and fall, K5 ran 36 times per step (16
   with the prologue), the bucket collectives equal the plan times the
   steps, and one step from the same weights with unfused BatchNorm
   (cuDNN 1x1 convs, statistics as a separate pass) matches the fused
   loss, running means and gradient norm;
8. window: the training lanes as multi-step windows
   (``distributed.window``: one captured step replayed as a CUDA graph),
   two windows of 2 steps against 4 eager steps from the same weights,
   bit for bit (window means, parameters, buffers): the LM above at 2
   of its 12 layers with ``capturable`` Adam under hook-driven
   ``DistributedOptimizer``, with
   ZeRO-1, and with ``fused_ce`` + ``remat``; ResNet-50 ``--fused-bn``
   (cuDNN pinned to its deterministic algorithms for this A/B). The
   wrappers launch K1-K3 / K5 and the collectives are issued for the
   warm-up step and the capture only; one replayed window under
   ``torch.profiler`` traces K1 2 (4 with remat), K2/K3 2 and K5 36
   kernels a step, and as many NCCL kernels as an eager window; step ms,
   idle share and peak memory eager against windowed, capture time;
9. engine: the continuous-batching ``ServeEngine`` at full GPT-2-small
   width and 4 of its 12 layers (``ENGINE_LAYERS``, the phase's depth
   cut, which pays toward phases 21 and 22) serving 8 staggered
   requests with ``attention="paged"`` and ``"gather"``, each with the
   decode lane captured (the default) and eager (``capture=False``):
   every request finishes, the greedy streams are identical across the
   four runs and equal ``lm_decode``'s;
   eager, K4 ran once per layer per step with a live decode slot;
   captured, the wrapper launched it for the warm-up step and the
   capture only, the lane was captured once and replayed once a live
   decode step, and a profiled captured run traces K4's two kernels 4
   times a live decode step; a weight swap captures the lane again and
   serves ``lm_decode``'s stream over the new weights; then with
   speculative decoding (k = 4, the draft the first 2 layers; paged
   captured and eager, gather captured, and a full-depth draft): the
   streams equal the plain engine's, eager paged runs K4 8 times a live
   tick and the captured lane only for its warm-up and capture, a
   profiled captured run traces 8 of each K4 kernel a live tick, the
   full-depth draft accepts every proposal, the draft's device-side hash
   equals the host's and sampled streams are the same captured and
   eager; and with the prefix cache on and off over 8 requests sharing a
   128-token system prompt: 7 hits of 128 tokens, no copy-on-write copy,
   the streams unchanged and equal ``lm_decode``'s;
10. fleet: ``ServeFleet`` at the engine phase's geometry and width and
   2 of its 12 layers (paged, captured, the waves, seed 0's weights at
   that depth, against the single engine's run at that depth, which
   phases 11, 13 and 13b share). Two in-process
   replicas sharing one copy of the weights: the streams equal the
   single engine's and ``lm_decode``'s, each replica's K4 wrapper
   launched only for its warm-up step and capture (the card's reserved
   memory logged at every capture) and a profiled replayed tick traces
   12 of each K4 kernel per live replica; the same submissions with
   ``kill:replica=1`` armed mid-decode give the same streams (one
   ``crashed`` incident, a redispatch, a relaunch, no token emitted
   twice); rolling updates to versions 2 and 3 (copies of the same
   weights) mid-run keep the streams, every replica captures again over
   the new weights, and the reserved memory after the second roll is
   within one lane graph's pool of the first's. Then two worker
   processes sharing the card (``--device cuda``): the weights arrive
   over the wire (the pushed sha256 is the fleet's artifact's), the
   card's memory outside this process grows by at least each worker's
   weights (``nvidia-smi --query-compute-apps`` logged beside it), the
   streams equal the in-process fleet's, clean and with a real SIGKILL
   of worker 1 mid-decode (relaunched within the budget), each worker
   incarnation's own K4 wrapper count is its warm-up step and capture
   with replays after it, every worker is reaped after ``close()`` and
   its memory freed, and each incarnation's spawn-to-first-step
   seconds;
11. disagg: disaggregated prefill/decode pools
   (``FleetConfig(pools={"prefill": 1, "decode": 1})``) at the same
   geometry, width, weights and waves. In process: every request is
   admitted on replica 0 and finishes on replica 1, its stream equal to
   the colocated fleet's, the single engine's and (requests 0 and 1)
   ``lm_decode``'s; 8 transfers, no failure, nothing parked, the bytes
   and chunks shipped equal to what the geometry gives (92 pages of
   1,179,648 bytes of tiles plus 8 headers, 108 chunks of 1 MiB); the
   decode replica's K4 wrapper launched for its warm-up step and capture
   only, the prefill replica's never (its lane is never captured), and
   a profiled replayed decode-pool tick traces 12 of each K4 kernel;
   one transfer's export, codec and import timed apart. Then one
   transfer torn on each side: the streams unchanged, a decode-side
   tear re-exports the parked request's identical bytes with no
   redispatch, a prefill-side tear redispatches at most once with its
   recomputed tokens counted. Then a prefill worker and a decode worker
   sharing the card: the streams unchanged, the bytes shipped equal to
   the in-process run's, the decode worker's own K4 count its warm-up
   step and capture with replays after it, the prefill worker's lane
   never captured, the card's memory outside this process up by both
   workers' weights and back after ``close()``;
12. hier: the hierarchical gradient exchange. The int8/fp8 codecs'
   ``quantize``/``dequantize`` and dequantized sum on the card equal
   the same calls on the CPU bit for bit (a 2^20 shard, an all-zero
   shard, values at and past the caps). Then a world of 8 ranks, each a
   process of this script (``--hier-rank``): its own card over NCCL
   where the machine has 8, else all on the one card over gloo with
   every tensor on the card. Each rank probes the ladder's collectives
   (reduce-scatter, all-gather, all-to-all, all-reduce, on the world and
   on the inner and outer groups of inner 4 and 2) on CUDA tensors; runs
   integer-valued ``fused_reduce`` buckets through the ladder at inner 4
   and 2 against the flat exchange (bit for bit, average on and off,
   overlap on and off); then the LM at the training phase's width, 2
   layers deep (one sequence of 2048 tokens a rank) under
   ``DistributedOptimizer(Adam)``:
   a warm-up and one timed step with the flat exchange, the ladder at
   inner 4, int8 on it (2 hosts: the all-gather exchange) and fp8 at
   inner 2 (4 hosts: the two-stage all-to-all exchange). Every rank's
   parameters equal rank 0's bit for bit, each loss is within its
   tolerance of the flat run's, the residuals are non-zero with
   ``ef_residual_specs``'s shapes, and K1-K3 ran 4 times a step on
   every rank. Were a collective refused on CUDA tensors, the line would
   say so with the error (``"ladder_on_card": false``), a world of one
   would hold ``hierarchical="on"`` to ``"off"`` on the card, and the
   exact ladder would run on CPU tensors, labelled so: nothing stages
   through the host to get round it;
13. tp: tensor parallelism. A world of 4 ranks, each a process of this
   script (``--tp-rank``): its own card over NCCL where the machine has
   4, else all on the one card over gloo with every tensor on the card.
   The LM is the serving width, 2 of its 12 layers deep (the depth cut
   of phases 10, 11, 13 and 13b, shared with the zoo's, the harness's
   and the examples' budgets), and its
   references are the single card's captured paged engine at that depth,
   run in the parent before phase 10, under the weights of numpy seed 0
   and seed 1.
   Rank 0 serves the engine phase's requests and waves through
   ``ServeEngine(..., attention="paged", mesh="dp=1,tp=4",
   capture=False)`` (heads, MLP features and vocab sharded; each rank's
   pages ``[num_pages, 16, 3, 64]``, a tensor of their own) and the
   others follow: every request finishes, every greedy stream equals the
   single-card paged engine's (else the first diverging position and
   the top-2 logit gap there), every rank launches K4 6 times a live
   decode tick over its 3 heads, and ``kv_bytes_per_chip`` is at most a
   quarter of the single card's. The controller then swaps to the
   weights of numpy seed 1 (``update_params``: the dense weights
   broadcast, every rank cuts its shard) and serves the same requests
   again: every stream equals the single-card paged engine's under those
   weights. Then the HVKV
   round trip: request 0 parked on the TP engine and exported (the ranks'
   head shards gathered) has the single card's framing bytes and its
   tiles within 1e-5 (atol = rtol; float32 summation order), imports
   into a tp=1 cache and exports from it to the same bytes, and admitted
   back into the TP engine it exports to the same bytes again (every
   rank wrote its heads bit for bit) and decodes the single card's
   stream. Over NCCL (4 cards) a second engine serves the requests with
   ``capture=True``: every rank captures its lane and replays it, the
   streams equal the eager ones, a replayed tick's trace holds K4's two
   kernels 6 times each, and after a swap to the seed-1 weights every
   rank captures again (K4 24 wrapper calls each: a warm-up step and a
   capture before and after) and request 0 decodes the single card's
   stream under them; over gloo the record says why that lane
   did not run (gloo collectives cannot be captured; the engine refuses
   ``capture=True`` there). Then each rank takes one TP training step at
   the same width (``lm_apply(tp)``, the vocab-parallel fused loss,
   ``reduce_grads``; batch 2 x 256): its loss within 1e-5 relative of
   the dense step's on the same weights and each gradient shard within
   1e-4 (of the leaf's largest entry) of the dense gradient's slice;
13b. tp_fleet: tensor-parallel replicas in disaggregated pools. A
   ``FleetConfig(pools={"prefill": 1, "decode": 1})`` fleet over the
   ``process`` transport with ``mesh="dp=1,tp=2"``: each replica a worker
   (the controller) and one follower it starts, all four ranks on the
   one card over gloo (replica i takes cards (2i + r) % cards: NCCL on 4
   cards), the LM phase 13's (2 layers deep). The engine phase's requests
   prefill on replica 0, ship their pages (gathered from both ranks) and
   decode on replica 1 (each rank writing its heads): every stream
   equals phase 13's single-card reference, every request finishes on
   replica 1, the pools transfer one
   blob a request, and by the ranks' own counters (``rank_counters``,
   read before and after the run) both decode ranks run the same live
   ticks with K4 6 times each and the prefill ranks decode nothing.
   A rolling ``update_params`` (the seed-1 weights pushed to each
   controller, which fans them out) and a second wave: every stream
   equals the single card's under the new weights. After ``close()``
   no worker or follower is left. Prints one ``{"tp_fleet"}`` line:
   transfers and their ms, tokens/s of the card with the gloo caveat,
   TTFT and per-token p50/p99, the roll's seconds and the phase's;
14. sp: sequence and pipeline parallelism. First K1-K3 alone at the
   Ulysses step's shape and dtype (``[1, 8192, 3, 64]`` float32, causal)
   against their plain versions at 1e-5, in this process: the dense
   Ulysses reference runs the same kernels, so only this check sees a
   kernel's fault over 8192 keys. Then a world of 4 ranks, each a
   process of this script (``--sp-rank``): its own card over NCCL where
   the machine has 4, else all on the one card over gloo with every
   tensor on the card; float32, no TF32, each variant against the dense
   step on the same weights, taken in this process before the world
   starts. The Ulysses and ring models are 2 layers deep at the full
   width (4 before PR 20, which cut them to pay for phase 13b). Ulysses: the bench lane's ``TransformerLM`` at the training
   width with ``attn_fn`` a ``ulysses_attention`` on the flash kernels
   and ``pos_offset``, one sequence of 8192 tokens (2048 a rank), a
   warm-up and a timed forward and backward step: the sp-aware loss
   within 1e-5 relative of the dense model's (``attn_fn`` the flash
   attention over the whole sequence), the gradients summed over ``sp``
   within 1e-4 of each leaf's largest entry, and K1, K2 and K3 launched
   2 times each in the timed step on every rank, over ``[1, 8192, 3,
   64]``. Ring: ``lm_apply(sp=)``, ``next_token_nll_fused(sp=)`` and
   ``reduce_grads(sp=)`` on one sequence of 4096 tokens, held the same
   way against the dense ``lm_apply`` step, with the dead blocks the
   causal ring skipped (2 x (3 - rank) a forward: 6 of 16 block-steps
   a layer). ``sp=2,tp=2``: one forward of ``lm_apply(sp=, tp=)`` and its
   loss on the ring's weights and tokens against the dense loss.
   Pipeline: ``lm_apply_pp`` with 4 stages of one block (8 x 512 tokens,
   4 microbatches), ``remat`` off and on: the loss within 1e-5 relative
   of the dense 4-layer step's, each stage's gradients and the
   ``pp_reduce_rest_grads`` ones within 1e-4;
15. ep: expert parallelism and the SPMD harness, in a world of 4 ranks,
   each a process of this script (``--ep-rank``), as the sp phase's.
   First every collective of ``horovod_tpu_torch.distributed`` through
   ``spmd_run`` on CUDA tensors against the closed form of its
   tests/test_collectives.py case (sum, average, min and max; fp16 and
   bf16 compression; allgather and allgatherv; broadcast from roots 0
   and 3, and of bools; alltoall, reducescatter and grouped_allreduce
   over mixed dtypes; allreduce_sparse, gathered and dense; the gradient
   of allreduce, ``4 * (r + 1)``; ``rank()`` inside the region 0..3).
   Then the Switch-MoE LM at Switch-base-8's widths (4 of its 12 layers,
   the phase's depth cut; d_model 768, 12 heads, d_ff 3072, 8 experts,
   2 a rank, vocab 32000), one sequence of 1024 tokens a rank,
   float32, no TF32, runs no kernel of the port (its attention is
   dense, as in the JAX package). The dense
   reference, ``lm_apply_moe(ep=None)`` over all 4096 tokens at the
   drop-free capacity factor 8.0 with its loss and gradients, runs in
   this process before the world starts. Drop-free: the ep step's loss
   (averaged over ep) within 1e-5 relative of the dense one, its logits
   within 1e-5 of their largest entry, and every gradient after
   ``moe_reduce_grads`` within 1e-4 of the leaf's largest entry; a
   forward's ``all_to_all_single`` calls two a layer of ``E x C x D x
   4`` bytes. Dropping: at Switch's capacity factor 1.25 against the
   dense function over the rank's own tokens (the same capacity rule),
   the routing equal and the logits within 1e-5, with the share of
   tokens dropped. Training: three steps of SGD 0.05 on nll + 0.01 x the
   ep-mean aux through ``spmd_run``: the loss falls on every rank;
16. job: the Horovod job through the port's launcher
   (``horovod_tpu_torch.run``). ``run(job_task, np=2)`` starts two rank
   processes (``task_exec``, the driver's authenticated RPC; the task
   is this module's function, imported as ``chip_smoke``): each joins
   the world from the launcher's environment (its own card over NCCL
   where there are two, else a gloo group on the one card) and calls
   ``hvd.init(device=...)``; GPT-2-small at the training width, 2 of
   its 12 layers deep (the phase's depth cut), on the flash
   kernels, each rank with weights of its own seed until
   ``broadcast_parameters`` gives it rank 0's, and its own 4 sequences
   of 2048; three steps of ``hvd.value_and_grad`` over
   ``torch.func.functional_call``, ``allreduce_gradients_transform``
   and Adam 1e-4: the losses are finite and fall on every rank, the
   parameters are bit-identical across the ranks after the broadcast
   and after every step (SHA-256 of their bytes), step 1's averaged
   gradient equals the mean of both ranks' local gradients computed on
   rank 0 with no collective within one bf16 ulp of each leaf's largest
   entry, K1 ran 2 times a forward pass and K2/K3 2 times a backward
   pass on every rank, and the bucket collectives are two exchanges of
   the plan's a step (the gradient's and the transform's). Then the CLI
   (``python -m horovod_tpu_torch.run``, the ``hvdrun-torch`` entry):
   ``-np 2 --restarts 1`` over a command that fails on its first
   attempt exits 0 after one relaunch, a job whose rank 1 exits 1 while
   rank 0 sleeps is torn down with ``JobResult.trigger.rank == 1``,
   category ``crashed``, a malformed ``--fault-plan`` exits 2 and
   ``--elastic`` over ``true`` exits 0. Then
   ``hvd.init(comm=[0, 2])`` in a 4-rank gloo world on the card started
   by ``launch_job`` (``--comm-rank``): ranks 0 and 2 see size 2 and an
   allreduce of ones on the card gives 2, ranks 1 and 3 raise
   ``InvalidArgumentError`` and leave cleanly;
17. elastic: preemption-tolerant training through ``hvdrun-torch
   --elastic`` (``horovod_tpu_torch.elastic``), every rank a process of
   this script (``--elastic-rank``) running ``run_elastic`` over
   GPT-2-small at the training width, 2 of its 12 layers deep (the
   phase's depth cut), on K1-K3 (flash,
   ``bwd_impl="kernel"``): a functional step (``hvd.value_and_grad``
   over ``torch.func.functional_call``, ``allreduce_gradients_transform``,
   Adam 1e-4 on dicts) over the state ``{"params", "m", "v", "step"}``
   (bf16), 4 steps, a snapshot every 2, each spilled through a
   ``CheckpointManager`` of the rank's own. (a) 2 ranks (gloo on the
   card when they share it), 2 sequences each a step, with
   ``--max-restarts 1 --fault-plan kill:rank=1,step=3`` beside the same
   job without the plan: the faulted job exits 0 after one relaunch of
   a ``crashed`` incident, rank 1 resumed from step 2, each rank's
   SHA-256 over every state leaf and its last-write-wins loss
   trajectory (``repr``) equal the clean job's, and K1-K3 launch 2 a
   step on every rank and attempt. (b) 1 rank, 8 sequences, windows of
   2 captured steps, ``--max-restarts 0 --fault-plan
   preempt:rank=0,step=2``: one free relaunch classified
   ``preempted``, the relaunch resumed from the manifest of step 2,
   each attempt captured one step after one eager warm-up, and the
   final digest equals an eager run of the same 4 steps in this
   process. (c) in this process: a sync snapshot at a window boundary
   is hashed, ``take()`` runs async (staging copy on the card, then a
   pinned host copy on a side stream), one more captured window
   overwrites the state's buffers, and ``latest`` still hashes to the
   step's digest; the take's host ms, the commit wait, the sync
   snapshot's ms, bytes and GB/s (beside the card's device copy rate),
   and a spill and a restore are timed. (d) the CLI checks of phase
   16. Prints one ``{"elastic"}`` line;
18. loop: the training loop (``horovod_tpu_torch.training``) over
   GPT-2-small at the training width, 2 of its 12 layers deep (the
   phase's depth cut), on K1-K3 (weights drawn on the
   card, 8 sequences of 2048 a step), Adam 1e-4 with ``capturable=True``
   and the LR a tensor on the card, ``create_distributed_optimizer`` in
   an NCCL world of one, a live ``TrainState`` and ``apply_gradients``
   after ``backward()``. Run A: a ``TrainLoop`` of 2 epochs of 2 windows of 2
   captured steps, with ``BroadcastGlobalVariablesCallback``,
   ``MetricAverageCallback``, ``LearningRateScheduleCallback(0.5 **
   epoch, staircase=False)`` (a new LR every window),
   ``CheckpointCallback`` over a numpy ``CheckpointManager`` and
   ``ElasticSnapshotCallback`` (a snapshot every 2 steps, every second
   one spilled); run B the same windows eager; run C as A with the
   multiplier 1. A's SHA-256 over every state leaf equals B's and
   differs from C's, the LR tensor (the optimizer's own) holds the
   schedule's closed form at every window, the state reads step 8, and
   one profiler session over A's last two windows (4 replayed steps,
   after a traced and dropped replayed warm-up window) holds K1-K3 6
   times a step; A's
   state through ``save_model``/``load_model`` into a fresh model's
   ``TrainState``, the checkpoint's last step and the last snapshot
   restores to its digest; a further fit of the loaded copy, preempted
   at step 9, exits 75 with the manifest at 9, and one more step of A
   gives its loss, equal by ``repr``. Prints one ``{"loop"}`` line with
   the LRs, step ms captured (C) and eager (B), ``save_model`` ms, bytes
   and MB/s, ``load_model`` ms, the checkpoint's save and restore ms,
   the snapshots taken and the peak memory;
19. autotune: ``HOROVOD_AUTOTUNE=1`` over the same LM (2 layers deep,
   weights drawn on the card, 8 sequences of 2048 a step cycling over 4
   batches), Adam
   1e-4 ``capturable=True`` under ``DistributedOptimizer`` in an NCCL
   world of one, the tuner's window 2 dispatches over the 9 flat
   thresholds (one host cannot ladder), 6 probes by expected
   improvement. Run A: eager steps, the tuner made by ``init`` from the
   env knob, until past convergence: its log holds a warm-up and a
   sample a probe and ends ``converged``, the optimizer then runs
   ``plan_buckets`` at the winner, and K1-K3 launch 6 times a step.
   Run B: the same steps untuned, its parameters equal A's bit for bit
   after each of A's moves and at the end (a world of one with
   ``Compression.none``: no plan changes a value). Run C: windows of 4
   captured steps (one dispatch each) under a new tuner: one capture a
   move plus one, each replacing the last graph (the card's reserved
   memory after each capture, the allocator's cache emptied, stays
   within 1 GiB of the first's), K1-K3 6 wrapper calls a warm-up and
   a capture, and A's final parameters bit for bit. Prints one
   ``{"autotune"}`` line with each probed threshold's steps/s, the
   winners, probes, captures, the memory, the runs' seconds and the
   phase's, beside the card's name and power limit;
20. zoo: the rest of the model zoo through the image bench lane's step
   (SGD 0.01 momentum 0.9 under ``DistributedOptimizer``, bf16, 64
   images, 1000 classes, an NCCL world of one, random weights from a
   seed, published widths): Inception V3 at 299^2, one step fused (K5)
   against unfused from the same weights (loss, gradient norm and the 94
   layers' new running means), then 3 fused steps on one batch: the loss
   falls, K5 ran 40 times a step and never with the prologue, the bucket
   collectives are the plan's each step; VGG-16 and ViT-B/16 at 224^2,
   3 steps each (the loss falls, the plan's collectives); MNISTNet, one
   step and one ``make_eval_step`` call; then cross-replica BatchNorm:
   ResNet-50 with ``axis_name="hvd"`` on 2 ``--syncbn-rank`` processes
   of 16 images (gloo on one card, NCCL on 2) against one rank of all
   32, float32: the summed loss, every layer's new running mean and the
   summed gradients. Prints one ``{"zoo"}`` line with each model's
   parameters, bucket plan, losses, step times, median step, img/s a card, peak
   memory and launches, the parity and the sync-BN errors and the
   phase's seconds, beside the card's name and power limit;
21. harness: the bench's harness and ``--bf16-momentum`` (an NCCL
   world of one): ``python -m horovod_tpu_torch.bench --probe-only``
   supervised (one record, the card's bf16 matmul TFLOP/s, its name and
   power limit) while a lane that fails deterministically runs beside it
   (one attempt, one record, rc 0); ResNet-50 ``--fused-bn`` at batch 64,
   4 steps with the SGD momentum in bfloat16 against float32 from the
   same weights (losses within rtol 0.1, the momentum's bytes halved, K5
   36 times a step; each step's update replayed on the lane's own
   gradients within 1e-4 of optax's, two wrong updates beyond it), then
   the bfloat16 lane's window of 2 against eager
   steps bit for bit; the LM on flash at ``WINDOW_LAYERS`` depth with
   Adam's first moment in bfloat16 (its bytes half the second
   moment's), under hooks and under ZeRO, windows against eager steps
   bit for bit with K1-K3's launches; a captured dropout step whose
   replays draw fresh masks, equal to eager draws from the same seed,
   and whose unregistered twin raises naming the module; then VGG-16 at
   224^2 (dropout 0.5 in its classifier) in windows of 2 against eager
   steps bit for bit. Prints one ``{"harness"}`` line;
22. examples: the seven examples of ``horovod_tpu_torch/examples/`` at
   their smoke sizes, started a second apart (the multi-rank ones under
   ``python -m horovod_tpu_torch.run``: NCCL with a card a rank, else
   gloo ranks sharing one card), each passing its own assertions, the
   ring attention example's Ulysses check launching K1-K3; the ResNet-50
   callback example and the ZeRO example run again as soon as their
   first runs end, and resume. The phase runs in a thread beside phase
   20 and phase 21 after its supervised CLI (the examples are bound by
   process starts). Prints one ``{"examples"}`` line with each one's
   seconds;
23. (``--profile`` only) two training steps of each lane and the
   engine's workload again (captured and eager) under
   ``torch.profiler``: device busy time, idle share, top kernels.

``--fleet-only [RUNS]`` runs phases 1 and 2, one captured paged engine
run for comparison and the fleet phase RUNS times (default 1), and
prints one ``{"fleet_runs": [...]}`` line and no kernels or ok line.

``--disagg-only [RUNS]`` runs phases 1 and 2, one captured paged engine
run, and the disagg phase RUNS times (default 1) with a colocated
in-process fleet run inside each (no colocated worker run: the
``{"disagg"}`` line says "not measured" there), and prints one
``{"disagg_runs": [...]}`` line and no kernels or ok line.

``--hier-only`` runs phases 1, 2 and 12 and prints the ``{"hier"}``
line and no kernels or ok line.

``--tp-only`` runs phases 1 and 2, one captured paged engine run for the
reference streams and phase 13, and prints the ``{"tp"}`` line and no
kernels or ok line.

``--tp-fleet-only`` runs phases 1 and 2, the captured paged engine runs
for the reference streams (the engine phase's weights and seed 1's)
and phase 13b, and prints the ``{"tp_fleet"}`` line and no kernels or
ok line.

``--sp-only`` runs phases 1, 2 and 14 and prints the ``{"sp"}`` line and
no kernels or ok line.

``--ep-only`` runs phases 1, 2 and 15 and prints the ``{"ep"}`` line and
no kernels or ok line.

``--job-only`` runs phases 1, 2 and 16 and prints the ``{"job"}`` line
and no kernels or ok line.

``--elastic-only`` runs phases 1, 2 and 17 (with its own CLI checks)
and prints the ``{"elastic"}`` line and no kernels or ok line.

``--loop-only`` runs phases 1, 2 and 18 and prints the ``{"loop"}``
line and no kernels or ok line.

``--autotune-only`` runs phases 1, 2 and 19 and prints the
``{"autotune"}`` line and no kernels or ok line.

``--zoo-only`` runs phases 1, 2 and 20 and prints the ``{"zoo"}`` line
and no kernels or ok line.

``--harness-only`` and ``--examples-only`` run phases 1, 2 and 21 or
22 and print the ``{"harness"}`` or ``{"examples"}`` line and no
kernels or ok line.

``--engine-only`` runs phases 1 and 9 alone (and 12's engine half with
``--profile``), the engine phase RUNS times (default 3) with all its
checks, and prints one ``{"engine_runs": [...]}``
line of each run's tokens/s, TTFT and per-token p50/p99 per mode,
captured and eager, and no kernels or ok line: copied into another
checkout, it serves that checkout's package with the same script, to
compare two commits' serving on one card.

Each kernel's launch count is set to 0 just before the phase that drives
its path and read just after; launches made to compare or time a kernel
do not count. A CUDA graph replay runs no Python, so under replay the
counts come from the profiler's trace (``replay_launches``).

Before the last two lines, a ``{"window": {...}}`` line holds the eager
against captured numbers beside the card's name and power limit, and a
``{"fleet": {...}}`` line the fleet's tokens/s of the card (every
replica shares it) and per replica, TTFT and per-token p50/p99, clean
and faulted, in process and as workers, beside the single engine's and
the card's name and power limit, and a ``{"disagg": {...}}`` line the
pools' tokens/s of the card, TTFT and per-token p50/p99 against the
colocated fleet's on the same workload (in process and as workers),
the KV transfer's p50/p99 ms, bytes and chunks, the torn runs and the
phase's seconds, and a ``{"hier": {...}}`` line each exchange
variant's backend, ranks, cards, inner size, host count m, step ms,
intra- and inter-host MB of its wire, the inter-host dtype and ratio,
the largest cross-rank parameter difference and the loss against the
flat run, beside the card's name and power limit and the caveat that on
one shared card the step times measure host copies, and a ``{"tp":
...}`` line the degree, backend and cards, the streams compared and
equal, the tokens/s of the card against the single engine's, TTFT and
per-token p50/p99, ``kv_bytes_per_chip`` against the single card's, K4's
launches and live ticks on every rank, the weight swap's seconds and
streams, the HVKV round trip's bytes, error and milliseconds, the
captured lane's record (or why it did not run), the training step's
losses and gradient errors and the phase's seconds, with the same
caveat, and a ``{"tp_fleet": ...}`` line (phase 13b), and an
``{"sp": ...}`` line the backend and cards, the collective each path
rides, and for each variant (Ulysses, ring, sp=2,tp=2, the pipeline
stored and rematerialised) its step milliseconds on every rank, tokens/s
a card, loss against the dense one and largest gradient error, K1-K3's
launches on every rank, the ring's dead blocks skipped, the pipeline's
ticks and bubble share, the phase's seconds and the card's name and
power limit, with the same caveat, and an ``{"ep": ...}`` line the
backend and cards, each collective checked with its error, the MoE
configuration, the drop-free step's loss, logits and gradient errors,
step milliseconds on every rank, tokens/s a card, peak memory a rank and
all-to-all bytes a layer, the dropping forward's routing check, logits
error and dropped share, the training losses and step milliseconds, the
phase's seconds and the card's name and power limit, with the same
caveat, and a ``{"job": ...}`` line the backend and cards, the losses
and step milliseconds of every rank, tokens/s a card, the gradient
check's error and tolerance, K1-K3's launches and the collectives of
every rank, the spawn-to-task seconds, the relaunch, the fail-fast
teardown seconds, the comm subset's results and the phase's seconds,
beside the card's name and power limit. The
second-to-last line is the ``{"kernels": [...]}`` record (K1-K5) and
the last line ``{"ok": true, "device": {...}}``. The script imports nothing of
JAX and needs the checkout beside it: alone in a directory, or without a
CUDA device, it fails.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import signal
import subprocess
import sys
import time

# Published peaks of an H100 SXM (NVIDIA's data sheet, dense, at the
# full 700 W): float32 outside the tensor cores, bfloat16, and HBM3.
# ``bound_ms`` is taken against these; the script also reports the
# device-to-device copy rate it reaches, for comparison.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_PEAK_BYTES_S = 3.35e12

# The serving geometry: tools/serve_bench.py's defaults at GPT-2-small
# width (Lmax 384, page_size 16, 8 decode slots, prefill_chunk 64,
# num_pages = (8 + 1) * 24 + 1).
LAYERS, D_MODEL, HEADS, VOCAB, FFN = 12, 768, 12, 32000, 3072
LMAX, PAGE, SLOTS, CHUNK = 384, 16, 8, 64
PPS = LMAX // PAGE
NUM_PAGES = (SLOTS + 1) * PPS + 1
HEAD_DIM = D_MODEL // HEADS
# Kernel against plain version, atol = rtol. float32: the same float32
# arithmetic summed in another order (errors of a few 1e-7 relative on
# the sweep's sums). bfloat16: both round their outputs (one bf16 ulp is
# 2^-8 relative) and the softmax weights / dS to bf16 inside, where a
# last-bit difference in the float32 value before the rounding moves one
# term by an ulp.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------- phase 1


def device_phase(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")
    return card


# ------------------------------------------------------------- phase 2


def _kernel_name(line):
    """The kernel of a ptxas "Function properties for <mangled>" line:
    the name whose length prefix fits and ends in "kernel", with its
    template arguments (``flash_bwd_dq_tc_kernelILi64``)."""
    for m in re.finditer(r"\d+(?=[a-z_])", line):
        for i in range(len(m.group())):          # "N_122name": 1 | 22
            end = m.end() + int(m.group()[i:])
            if line[m.end():end].endswith("kernel"):
                rest = line[end:]
                return line[m.end():end] + (rest.split("EE")[0]
                                            if rest.startswith("I") else "")
    return line.split()[-1][:60]


def build_phase():
    from horovod_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for name, b in built.items():
        fn = ""
        for line in b.log.splitlines():
            if "Function properties for" in line:
                fn = _kernel_name(line)
            elif ("registers" in line or "spill" in line
                  or "warning" in line.lower() or "Performance" in line):
                log(f"  ptxas {name} {fn}: {line.strip()}")
                ptxas.setdefault(name, {}).setdefault(fn, []).append(
                    line.strip())
    return ptxas


# ------------------------------------------------------------- phase 3


def _kernel_sweep(torch, np):
    """K4 against its plain version: every template instance (16-byte
    loads by 4, 8, 16 or 32 lanes a row, one load a lane or two; the
    element path at D = 100 in bf16 and at a base off the 16-byte grid)
    at odd page sizes, lengths 0, 1, a page, a page + 1 and
    the full table; then tables of 4 chunks or more with lengths on the
    chunk edges (R - 1, R, R + 1, 2R, 3R + 1). NaN null page, 1e30 stale
    rows, shuffled pages. A second launch must give the same bits."""
    from horovod_tpu_torch.ops import paged_attention as pa

    R = pa.CHUNK_ROWS
    cases = [(D, ps, 6, [0, 1, ps, ps + 1, ps * 6], False)
             for D in (8, 32, 48, 100, 128, 256) for ps in (1, 5, 16)]
    for D in (64, 100, 256):
        for ps in (5, 16):
            pps = -(-(3 * R + 8) // ps)
            cases.append((D, ps, pps, [0, 1, R - 1, R, R + 1, 2 * R,
                                       3 * R + 1, ps * pps], False))
    cases.append((64, 16, 16, [0, 1, R - 1, R + 1, 3 * R + 1], True))
    n = 0
    for i, (D, ps, pps, lens, offset) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            args = list(pa.decode_inputs(lens, 3, D, ps, pps, dtype, seed=i))
            if offset:                # contiguous, 2 or 4 bytes off 16
                for j in (1, 2):
                    buf = torch.empty(args[j].numel() + 1, dtype=dtype,
                                      device="cuda")
                    args[j] = buf[1:].view(args[j].shape).copy_(args[j])
            out = pa.paged_attention_decode(*args)
            again = pa.paged_attention_decode(*args)
            ref = pa.paged_attention_decode_reference(*args).float()
            tol = TOL[str(dtype).split(".")[1]]
            what = (f"kernel sweep D={D} ps={ps} pps={pps} lengths {lens} "
                    f"{dtype}{' off 16 bytes' if offset else ''}")
            check(torch.equal(out, again), f"{what}: a second launch "
                                           "changed an output bit")
            out = out.float()
            check(bool(torch.isfinite(out).all())
                  and bool((out[0] == 0).all())
                  and torch.allclose(out, ref, atol=tol, rtol=tol),
                  f"{what}: max_abs_err {float((out - ref).abs().max())}")
            n += 1
    torch.cuda.synchronize()
    log(f"kernel sweep: {n} cases (D 8..256, page sizes 1/5/16, up to "
        f"{max(-(-c[1] * c[2] // R) for c in cases)} chunks of {R} rows, "
        "f32 + bf16) agree with the plain version and repeat bit for bit")


def _copy_rate(torch):
    """Measured device-to-device copy rate in bytes/s (read + write)."""
    n = 1 << 28                                   # 1 GiB of float32
    a = torch.empty(n, device="cuda")
    b = torch.empty_like(a)
    for _ in range(3):
        b.copy_(a)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        b.copy_(a)
    e1.record()
    e1.synchronize()
    rate = 2 * a.numel() * a.element_size() * 10 / (e0.elapsed_time(e1)
                                                    / 1e3)
    del a, b
    return rate


#: K4's timed shapes: (result key, geometry, heads). The tp phase's
#: shards run it over 12 / tp heads: 6 at tp = 2, 3 at tp = 4.
K4_SHAPES = (("serving", "serving", HEADS), ("long", "long", HEADS),
             ("serving_h6", "serving", HEADS // 2),
             ("serving_h3", "serving", HEADS // 4),
             ("long_h6", "long", HEADS // 2), ("long_h3", "long", HEADS // 4))


def kernel_phase(torch, np):
    """K4 at the serving shapes and at the long-context geometry, f32 and
    bf16, with all 12 heads and with a tensor-parallel rank's 6 and 3:
    agreement with the plain version, then the cold-L2 time of the call
    (``ms``), its two kernels' profiled time (``device_ms``), the plain
    version's and the library yardstick's times, and the bound."""
    import torch.nn.functional as F

    from horovod_tpu_torch._timing import (device_ms, flush_buffer,
                                           time_cold_ms)
    from horovod_tpu_torch.ops import paged_attention as pa

    _kernel_sweep(torch, np)
    rate = _copy_rate(torch)
    log(f"device copy rate: {rate / 1e9:.1f} GB/s")
    flush = flush_buffer()
    results = {}
    for key, geom, heads in K4_SHAPES:
        g = pa.geometry(geom)
        g["H"] = heads
        lens = g["lengths"]
        S, H, D, ps = len(lens), g["H"], g["D"], g["ps"]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, kp, vp, tables, lengths = args = pa.decode_inputs(
                dtype=dtype, seed=7, **g)
            scale = 1.0 / math.sqrt(D)
            out = pa.paged_attention_decode(*args, scale)
            ref = pa.paged_attention_decode_reference(*args, scale)
            torch.cuda.synchronize()
            what = f"{key} {dname}"
            check(bool(torch.isfinite(out).all()),
                  f"{what}: NaN/inf in the kernel's output (null page or "
                  "stale rows read)")
            check(bool((out[lengths == 0] == 0).all()),
                  f"{what}: idle lane not zero")
            err = float((out.float() - ref.float()).abs().max())
            tol = TOL[dname]
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            log(f"kernel paged_attention_decode[{what}]: max_abs_err "
                f"{err:.3e} (atol=rtol={tol})")
            check(ok, f"{what}: kernel disagrees with its plain version "
                      f"(max_abs_err {err})")

            # The yardstick: the same function as one gather + one
            # scaled_dot_product_attention call with a length mask.
            P = kp.shape[0]
            lmax = g["pps"] * ps
            rows = (tables.long()[:, :, None] * ps
                    + torch.arange(ps, device="cuda")).reshape(S, -1)
            mask = (torch.arange(lmax, device="cuda")[None, :]
                    < lengths.long()[:, None])[:, None, None, :]

            def library():
                kg = kp.reshape(P * ps, H, D)[rows].transpose(1, 2)
                vg = vp.reshape(P * ps, H, D)[rows].transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q[:, :, None, :], kg, vg, attn_mask=mask, scale=scale)

            call = lambda: pa.paged_attention_decode(*args, scale)  # noqa
            ms = time_cold_ms(call, flush)
            dev_ms = device_ms(call, flush, pa.KERNEL_NAMES)
            plain_ms = time_cold_ms(
                lambda: pa.paged_attention_decode_reference(*args, scale),
                flush, iters=20, warmup=2)
            library_ms = time_cold_ms(library, flush, iters=20, warmup=2)
            # Least work this run's data needs (pa.decode_work): bytes
            # over the HBM peak, operations over the peak for the type.
            nbytes, flops = pa.decode_work(lens, H, D, ps, kp.element_size())
            t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            results.setdefault(key, {"shape": {
                "S": S, "H": H, "D": D, "page_size": ps,
                "pages_per_seq": g["pps"], "num_pages": P,
                "lengths": lens}})[dname] = {
                "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
            }
            log(f"  ms {ms:.4f}  device_ms {dev_ms:.4f}  plain_ms "
                f"{plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms "
                f"{max(t_bytes, t_ops):.6f} ({nbytes} bytes at "
                f"{HBM_PEAK_BYTES_S / 1e9:.0f} GB/s peak)")
            del args, q, kp, vp, tables, lengths, out, ref, rows, mask
        torch.cuda.empty_cache()
    del flush
    return results, rate


# ------------------------------------------------------------- phase 4

# The training slice's attention shapes: bench defaults, batch 8 of seq
# 2048, 12 heads of 64, causal, bfloat16.
FLASH_B, FLASH_L = 8, 2048
# Sweep geometries: (Lq, Lk, causal, q_offset, k_offset). Lengths that
# are not multiples of the 64-row tiles or of the bf16 K1's 128-row query
# tile and K3's 128-row key tile (129, 136, 200, 255, 264, 320),
# rectangular shapes, offset causal masks, and causal keys past every
# query (K3 loops over nothing for them and must write zeros).
FLASH_GEOMS = [(200, 200, True, 0, 0), (128, 128, False, 0, 0),
               (64, 136, False, 0, 0), (72, 200, True, 128, 0),
               (128, 128, True, 40, 8), (64, 192, True, 0, 0),
               (136, 136, True, 0, 0), (320, 320, True, 0, 0),
               (64, 264, True, 200, 0), (192, 320, False, 0, 0),
               (129, 129, True, 0, 0), (255, 300, True, 45, 0)]
FLASH_HEAD_DIMS = (8, 32, 64, 100, 128)


def _strided(torch, x, pad):
    """``x`` [B, L, H, D] as a view with a head stride of ``D + pad``, as
    the model hands q/k/v over (views into one projection)."""
    B, L, H, D = x.shape
    buf = torch.zeros((B, L, H, D + pad), dtype=x.dtype, device=x.device)
    buf[..., :D] = x
    return buf[..., :D]


def _flash_case(torch, np, rng, B, H, D, Lq, Lk, dtype, pad=None):
    """q, k, v, dO: contiguous, or views padded by ``pad`` elements."""
    mk = (lambda *s: torch.tensor(rng.standard_normal(s, dtype=np.float32),
                                  device="cuda").to(dtype))
    q, do = mk(B, Lq, H, D), mk(B, Lq, H, D)
    k, v = mk(B, Lk, H, D), mk(B, Lk, H, D)
    if pad is not None:
        q, k, v, do = (_strided(torch, t, pad) for t in (q, k, v, do))
    return q, k, v, do


def _flash_check(torch, fa, q, k, v, do, causal, qo, ko, tol, what):
    """Each of K1-K3 against its plain version on the same inputs; the
    backward kernels get the plain forward's lse and D, so each kernel
    is held alone. Returns the largest absolute error."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = fa.flash_forward(q, k, v, causal, scale, qo, ko)
    r_out, r_lse = fa.flash_forward_reference(q, k, v, causal, scale, qo, ko)
    d = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, r_lse, d, causal, scale, qo, ko)
    r_dq = fa.flash_bwd_dq_reference(q, k, v, do, r_lse, d, causal, scale,
                                     qo, ko)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, r_lse, d, causal, scale, qo, ko)
    r_dk, r_dv = fa.flash_bwd_dkv_reference(q, k, v, do, r_lse, d, causal,
                                            scale, qo, ko)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("out", out, r_out), ("lse", lse, r_lse),
                           ("dq", dq, r_dq), ("dk", dk, r_dk),
                           ("dv", dv, r_dv)):
        got, ref = got.float(), ref.float()
        errs[name] = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all())
              and torch.allclose(got, ref, atol=tol, rtol=tol),
              f"flash {what}: {name} disagrees with its plain version "
              f"(max_abs_err {errs[name]:.3e}, atol=rtol={tol})")
    return errs


def _flash_sweep(torch, np):
    from horovod_tpu_torch.ops import attention as fa

    rng = np.random.default_rng(11)
    cases = 0
    worst = {}
    for D in FLASH_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for i, (Lq, Lk, causal, qo, ko) in enumerate(FLASH_GEOMS):
                # Every other geometry pads the head stride to an odd
                # count, which takes the bf16 K2/K3 off their 16-byte
                # copies onto element loads at every head dim.
                q, k, v, do = _flash_case(torch, np, rng, 2, 3, D, Lq, Lk,
                                          dtype, pad=D + i % 2)
                errs = _flash_check(
                    torch, fa, q, k, v, do, causal, qo, ko, TOL[dname],
                    f"sweep D={D} {dname} Lq={Lq} Lk={Lk} causal={causal} "
                    f"offsets=({qo},{ko})")
                worst[dname] = max(worst.get(dname, 0.0), *errs.values())
                cases += 1
    log(f"flash sweep: {cases} cases (D {FLASH_HEAD_DIMS}, "
        f"{len(FLASH_GEOMS)} geometries, f32 + bf16, strided views, even "
        f"and odd head strides) agree with the plain versions; max_abs_err "
        f"{worst}")


def _flash_bounds(B, H, L, D, elt):
    """Least work of K1-K3 at a causal square shape: operations over the
    bf16 tensor-core peak and bytes over the HBM peak, counting only the
    live (query, key) pairs and each input read and output written once.
    K1: q.k and p.v, 4 flops per live pair and head-dim element; K2 adds
    dO.v and dS.k and drops p.v (6); K3 recomputes q.k and dO.v and does
    P^T.dO and dS^T.q (8)."""
    pairs = B * H * L * (L + 1) // 2
    tile = B * L * H * D * elt               # one [B, L, H, D] tensor
    stat = B * H * L * 4                     # one float32 [B, H, L]
    work = {
        "flash_forward": (4 * D * pairs, 3 * tile + tile + stat),
        "flash_bwd_dq": (6 * D * pairs, 4 * tile + 2 * stat + tile),
        "flash_bwd_dkv": (8 * D * pairs, 4 * tile + 2 * stat + 2 * tile),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": ("operations" if t_ops >= t_bytes
                                  else "bytes")}
    return out


def flash_phase(torch, np):
    """K1-K3 over the sweep, then at the slice shapes in bf16: agreement,
    then the cold-L2 time of each kernel, of its plain version and of
    the library yardstick (``scaled_dot_product_attention``; its backward
    through autograd stands for K2 and K3 together)."""
    import torch.nn.functional as F

    from horovod_tpu_torch._timing import flush_buffer, time_cold_ms
    from horovod_tpu_torch.ops import attention as fa

    _flash_sweep(torch, np)
    B, L, H, D = FLASH_B, FLASH_L, HEADS, HEAD_DIM
    rng = np.random.default_rng(12)
    q, k, v, do = _flash_case(torch, np, rng, B, H, D, L, L, torch.bfloat16)
    errs = _flash_check(torch, fa, q, k, v, do, True, 0, 0, TOL["bfloat16"],
                        f"slice B={B} L={L} H={H} D={D} bf16 causal")
    log(f"flash slice shapes: K1-K3 agree with the plain versions in bf16 "
        f"(max_abs_err {errs})")
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.flash_forward(q, k, v, True, scale)
    d = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    # No atomics anywhere: a second launch repeats every output bit.
    again = (fa.flash_forward(q, k, v, True, scale),
             (fa.flash_bwd_dq(q, k, v, do, lse, d, True, scale),),
             fa.flash_bwd_dkv(q, k, v, do, lse, d, True, scale))
    first = (fa.flash_forward(q, k, v, True, scale),
             (fa.flash_bwd_dq(q, k, v, do, lse, d, True, scale),),
             fa.flash_bwd_dkv(q, k, v, do, lse, d, True, scale))
    check(all(torch.equal(a, b) for x, y in zip(first, again)
              for a, b in zip(x, y)),
          "flash slice shapes: a second launch changed an output bit")
    log("flash slice shapes: K1-K3 repeat bit for bit")
    flush = flush_buffer()
    runs = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, True, scale),
            lambda: fa.flash_forward_reference(q, k, v, True, scale)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, d, True, scale),
            lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, d, True,
                                              scale)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, d, True, scale),
            lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, d, True,
                                               scale)),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library = {
        "flash_forward": time_cold_ms(
            lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), is_causal=True),
            flush, iters=20, warmup=3),
        "flash_bwd": time_cold_ms(
            lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True),
            flush, iters=20, warmup=3),
    }
    bounds = _flash_bounds(B, H, L, D, q.element_size())
    results = {}
    for name, (kern, plain) in runs.items():
        ms = time_cold_ms(kern, flush, iters=20, warmup=3)
        plain_ms = time_cold_ms(plain, flush, iters=5, warmup=1)
        lib = library["flash_forward" if name == "flash_forward"
                      else "flash_bwd"]
        results[name] = {"max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib, **bounds[name]}
        log(f"  {name}: ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{lib:.4f}  bound_ms {bounds[name]['bound_ms']:.4f} "
            f"({bounds[name]['bound_by']}: {bounds[name]['flops']} flops, "
            f"{bounds[name]['bytes']} bytes)")
    del flush
    return results


# ------------------------------------------------------------- phase 5

# The image lane's defaults (batch 64, 224^2, 1000 classes); its 16 1x1
# ConvBN shapes are horovod_tpu_torch.models.resnet.RESNET50_K5.
IMG_B, IMG_SIZE, CLASSES = 64, 224, 1000
# Sweep: (B, H, W, K, N, stride, prologue). Rows off the 128- and 64-row
# tiles (M = 1, 100, 129, 257, 300, 429, 450, 2000, 39999: more M tiles
# than the card holds blocks at once), K from 8 to 2048 (off the
# 8-channel vector width: 12, 100; off the bf16 kernel's 64-deep slices:
# 72, 100, 136, 1000, 1088 with a ring that wraps), N off the 64/128-column
# tiles and off 256 (3, 72, 130, 136, 200, 300, 520), strided views, odd
# sides, the prologue with positive shifts.
K5_SWEEP = [
    (1, 1, 1, 8, 8, 1, False), (1, 10, 10, 100, 40, 1, True),
    (3, 43, 1, 24, 130, 1, False), (2, 15, 10, 12, 64, 1, True),
    (2, 16, 16, 256, 200, 2, False), (2, 15, 15, 64, 72, 2, True),
    (1, 12, 25, 2048, 96, 1, True), (4, 9, 9, 512, 1024, 2, False),
    (2, 8, 8, 1000, 3, 1, False), (1, 257, 1, 72, 300, 1, True),
    (2, 20, 20, 136, 256, 2, True), (3, 11, 13, 192, 520, 1, False),
    (1, 1, 2000, 1088, 64, 1, True), (2, 30, 30, 64, 136, 2, False),
    (1, 199, 201, 64, 256, 1, True),
]


def _k5_inputs(torch, np, rng, B, H, W, K, N, stride, prologue, dtype):
    """x as the model hands it over (an NHWC view of a channels-last
    activation, subsampled for a strided 1x1), w as the [K, N] view of an
    OIHW 1x1 weight, a/b float32 with positive shifts (so a row off the
    tile that escaped the mask would show in the statistics)."""
    x = torch.tensor(rng.standard_normal((B, H, W, K), dtype=np.float32),
                     device="cuda").to(dtype)
    x = x[:, ::stride, ::stride, :]
    wt = torch.tensor(rng.standard_normal((N, K), dtype=np.float32)
                      / np.sqrt(K), device="cuda").to(dtype)
    a = b = None
    if prologue:
        a = torch.tensor(rng.uniform(0.5, 1.5, K).astype(np.float32),
                         device="cuda")
        b = torch.tensor(rng.uniform(0.1, 0.6, K).astype(np.float32),
                         device="cuda")
    return x, wt.t(), a, b


def _k5_check(torch, cb, x, w, a, b, dname, what):
    """The kernel against its plain version: y elementwise; s1 against the
    column sums of |y| (s1 is a sum of both signs), s2 relatively."""
    y, s1, s2 = cb.bn_stats_forward(x, w, a, b)
    x2 = x.reshape(-1, x.shape[-1])
    if a is None:
        ry, r1, r2 = cb.matmul_bn_stats_reference(x2, w)
    else:
        ry, r1, r2 = cb.matmul_prologue_bn_stats_reference(x2, a, b, w)
    torch.cuda.synchronize()
    tol, stol = TOL[dname], K5_STATS_TOL[dname]
    err = float((y.float() - ry.float()).abs().max())
    scale = ry.float().abs().sum(0)
    e1 = float(((s1 - r1).abs() / scale.clamp_min(1e-30)).max())
    e2 = float(((s2 - r2).abs() / r2.abs().clamp_min(1e-30)).max())
    check(bool(torch.isfinite(y.float()).all())
          and torch.allclose(y.float(), ry.float(), atol=tol, rtol=tol)
          and e1 <= stol and e2 <= stol,
          f"conv_bn {what}: kernel disagrees with its plain version (y "
          f"max_abs_err {err:.3e} tol {tol}; s1 {e1:.3e}, s2 {e2:.3e} "
          f"relative, tol {stol})")
    return err, max(e1, e2)


# Statistics against the plain version, relative (s1 to the column sums
# of |y|, s2 to itself): float32 sums of the same values in another order
# (float32: a few 1e-7 relative); bfloat16: the rare y that rounds one
# bf16 ulp (2^-8) the other way moves a sum by far less than 1e-3.
K5_STATS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _k5_bound(M, K, N, prologue, elt):
    """Least work of one launch: x and w read once, y written once (plus
    a/b and the float32 statistics); 2*M*K*N flops over the bf16 (or f32)
    peak. Bytes over the HBM peak."""
    nbytes = (M * K + K * N + M * N) * elt + 2 * N * 4 \
        + (2 * K * elt if prologue else 0)
    return nbytes, 2 * M * K * N


def _k5_table(torch, np, cb, rng, flush, model, table):
    """K5 at one model's 1x1 shapes (``table`` rows ``(side, K, N, stride,
    prologue, launches a step)``) in bf16 at batch ``IMG_B``: agreement,
    bit-for-bit repetition, and per shape the cold-L2 time of the kernel,
    its device time, the plain version's and the library yardstick's
    (``torch.matmul`` + the two column reductions, behind the prologue's
    elementwise pass), with the bound; their sums over one training
    step's launches."""
    from horovod_tpu_torch._timing import device_ms, time_cold_ms

    shapes = []
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "t_bytes": 0.0, "t_ops": 0.0, "bytes": 0, "flops": 0,
           "launches": 0, "max_abs_err": 0.0}
    for side, K, N, s, pro, count in table:
        x, w, a, b = _k5_inputs(torch, np, rng, IMG_B, side, side, K, N, s,
                                pro, torch.bfloat16)
        what = f"{model} M={x.shape[0] * x.shape[1] * x.shape[2]} " \
               f"{K}->{N} stride {s} prologue {pro}"
        err, serr = _k5_check(torch, cb, x, w, a, b, "bfloat16", what)
        first = cb.bn_stats_forward(x, w, a, b)
        again = cb.bn_stats_forward(x, w, a, b)
        check(all(torch.equal(p, q) for p, q in zip(first, again)),
              f"conv_bn {what}: a second launch changed an output bit")
        x2 = x.reshape(-1, K)
        if a is None:
            plain = lambda: cb.matmul_bn_stats_reference(x2, w)  # noqa
        else:
            plain = lambda: cb.matmul_prologue_bn_stats_reference(  # noqa
                x2, a, b, w)

        def library():
            h = x.reshape(-1, K)
            if a is not None:
                h = torch.relu(h * a.to(h.dtype) + b.to(h.dtype))
            y = torch.matmul(h, w)
            yf = y.float()
            return y, yf.sum(0), yf.square().sum(0)

        ms = time_cold_ms(lambda: cb.bn_stats_forward(x, w, a, b),
                          flush, iters=20, warmup=3)
        dev_ms = device_ms(lambda: cb.bn_stats_forward(x, w, a, b), flush,
                           cb.KERNEL_NAMES)
        plain_ms = time_cold_ms(plain, flush, iters=5, warmup=1)
        library_ms = time_cold_ms(library, flush, iters=20, warmup=3)
        M = x.shape[0] * x.shape[1] * x.shape[2]
        nbytes, flops = _k5_bound(M, K, N, pro, 2)
        t_bytes = nbytes / HBM_PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        row = {"M": M, "K": K, "N": N, "stride": s, "prologue": pro,
               "launches_per_step": count, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err, "stats_rel_err": serr}
        shapes.append(row)
        for key, v in (("ms", ms), ("device_ms", dev_ms),
                       ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("t_bytes", t_bytes),
                       ("t_ops", t_ops), ("bytes", nbytes),
                       ("flops", flops), ("launches", 1)):
            tot[key] += count * v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        log(f"  conv_bn {what} x{count}: ms {ms:.4f}  device_ms "
            f"{dev_ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}), max_abs_err "
            f"{err:.3e}")
        del x, w, a, b, x2
    step = {k: tot[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                "bytes", "flops", "max_abs_err",
                                "launches")}
    step["bound_ms"] = max(tot["t_bytes"], tot["t_ops"])
    step["bound_by"] = ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                        else "operations")
    log(f"conv_bn: one {model} step's {step['launches']} launches: ms "
        f"{step['ms']:.4f}  device_ms {step['device_ms']:.4f}  plain_ms "
        f"{step['plain_ms']:.4f}  library_ms "
        f"{step['library_ms']:.4f}  bound_ms {step['bound_ms']:.4f} "
        f"({step['bound_by']}: {step['bytes']} bytes, {step['flops']} "
        f"flops)")
    return {"step": step, "shapes": shapes}


def conv_bn_phase(torch, np):
    """K5 over the sweep (f32 and bf16), then at the 16 ResNet-50 shapes
    and the 19 Inception V3 shapes (299^2) in bf16: agreement,
    bit-for-bit repetition, the times and the bound per shape and summed
    over one training step's 36 (ResNet-50) and 40 (Inception V3)
    launches (:func:`_k5_table`)."""
    from horovod_tpu_torch._timing import flush_buffer
    from horovod_tpu_torch.models.inception import INCEPTION_V3_K5
    from horovod_tpu_torch.models.resnet import RESNET50_K5
    from horovod_tpu_torch.ops import conv_bn as cb

    rng = np.random.default_rng(21)
    worst = {}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for B, H, W, K, N, s, pro in K5_SWEEP:
            x, w, a, b = _k5_inputs(torch, np, rng, B, H, W, K, N, s, pro,
                                    dtype)
            errs = _k5_check(torch, cb, x, w, a, b, dname,
                             f"sweep {dname} x {tuple(x.shape)} "
                             f"stride {s} N {N} prologue {pro}")
            worst[dname] = max(worst.get(dname, (0, 0)), errs)
            cases += 1
    log(f"conv_bn sweep: {cases} cases (M 1..39999, K 8..2048, N 3..1024, "
        f"prologue on/off, strided views, f32 + bf16) agree with the plain "
        f"version; worst (y abs, stats rel) {worst}")

    flush = flush_buffer()
    res = _k5_table(torch, np, cb, rng, flush, "ResNet-50", RESNET50_K5)
    inc = _k5_table(torch, np, cb, rng, flush, "Inception-V3", [
        (side, K, N, 1, False, count)
        for side, K, N, count in INCEPTION_V3_K5])
    del flush
    torch.cuda.empty_cache()
    check(res["step"]["launches"] == 36, f"the ResNet-50 table holds "
          f"{res['step']['launches']} launches, not 36")
    check(inc["step"]["launches"] == 40, f"the Inception V3 table holds "
          f"{inc['step']['launches']} launches, not 40")
    res.update(sweep_worst=worst, inception_v3=inc)
    return res


# ------------------------------------------------------------- phase 6

TRAIN_STEPS = 3
# The dense-attention cross-check runs one step at this batch (dense
# attention keeps [B, H, L, L] scores per layer for the backward).
PARITY_BATCH = 2
# Flash against dense attention, same weights and tokens, bf16 compute:
# dense rounds the scores to bf16 before its float32 softmax (its
# einsum runs in the input dtype), flash keeps them in float32, so the
# two differ by bf16 rounding of the scores; averaged over 2 x 2047
# next-token losses that moves the loss by far less than 0.5%, and the
# gradients' global norm by less than 5%. A wrong kernel moves both by
# far more (the loss of a broken attention is off by whole units).
PARITY_RTOL = {"loss": 5e-3, "grad_norm": 5e-2}
# The fused cross-entropy against the logits-then-log-softmax loss, same
# weights and tokens: both run the float32 head in full float32 and
# differ only in the order of the float32 sums (the chunked products and
# logsumexp against one [B, L, V] product), a few 1e-7 relative on the
# loss; the hidden states' gradient carries that difference into the
# bf16 blocks, where it can flip the last bit of a bf16 value, and the
# global norm of the gradients moves by far less than 1e-3. A wrong
# chunk, pad or target moves the loss by whole units.
FUSED_CE_RTOL = {"loss": 1e-5, "grad_norm": 1e-3}
# Three ZeRO-1 steps against three DistributedOptimizer steps with
# overlap off in a world of one: the same Adam arithmetic on a flat vector
# instead of per parameter, and the same gradients (the step's kernels
# are deterministic), so the parameters agree to float32 rounding; 1e-6
# absolute is 3% of one Adam step (lr 1e-4), so a missed or doubled
# update fails.
ZERO_ATOL = 1e-6
COMPARE_STEPS = 3


def _lm(torch, attn_fn, remat=False, layers=LAYERS):
    from horovod_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(vocab_size=VOCAB, num_layers=layers,
                         num_heads=HEADS, embed_dim=D_MODEL,
                         max_len=FLASH_L, dtype=torch.bfloat16,
                         attn_fn=attn_fn, remat=remat, seed=0,
                         device="cuda")


def _grad_norm(torch, model):
    return float(torch.sqrt(sum(p.grad.float().pow(2).sum()
                                for p in model.parameters())))


def _fused_ce_parity(torch, flash, tokens):
    """One forward + backward of the same weights with the logits loss
    and with the fused cross-entropy: loss, gradient norm and the peak
    memory of each."""
    from horovod_tpu_torch.models.train import (fused_next_token_loss,
                                                next_token_loss)

    model = _lm(torch, flash)
    out = {}
    for name in ("unfused", "fused"):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if name == "fused":
            loss = fused_next_token_loss(model, tokens)
        else:
            loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = {"loss": float(loss.detach()),
                     "grad_norm": _grad_norm(torch, model),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del loss
    for key, rtol in FUSED_CE_RTOL.items():
        f, u = out["fused"][key], out["unfused"][key]
        rel = abs(f - u) / abs(u)
        out[f"{key}_rel_diff"] = rel
        check(math.isfinite(f) and rel <= rtol,
              f"training: fused and unfused cross-entropy {key} differ by "
              f"{rel:.3e} (fused {f}, unfused {u}; rtol {rtol})")
    del model
    torch.cuda.empty_cache()
    return out


def _compare_steps(torch, flash, tokens):
    """``COMPARE_STEPS`` steps each, from the same weights: hook-driven
    overlap, overlap off and ZeRO-1, with their collectives; the
    parameters of each at the end."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.distributed.zero import (
        shard_info, sharded_distributed_optimizer)
    from horovod_tpu_torch.models.train import make_train_step

    out, params = {}, {}
    for mode in ("hooks", "off", "zero"):
        model = _lm(torch, flash)
        adam = torch.optim.Adam(model.parameters(), lr=1e-4)
        if mode == "zero":
            opt = sharded_distributed_optimizer(adam)
            groups = len(shard_info(opt))
        else:
            opt = hvd.DistributedOptimizer(
                adam, overlap="on" if mode == "hooks" else "off")
            check((opt._hvd_exchange is not None) == (mode == "hooks"),
                  f"training: {mode} optimizer hooks "
                  f"{opt._hvd_exchange is not None}")
        step = make_train_step(model, opt)
        fused_reduce.collectives = 0
        sharded_distributed_optimizer.collectives = 0
        losses = [float(step(tokens)) for _ in range(COMPARE_STEPS)]
        torch.cuda.synchronize()
        out[mode] = {"losses": losses,
                     "collectives": fused_reduce.collectives,
                     "zero_collectives":
                         sharded_distributed_optimizer.collectives}
        if mode == "zero":
            out[mode]["shard_info"] = shard_info(opt)
            check(out[mode]["zero_collectives"]
                  == 2 * groups * COMPARE_STEPS
                  and out[mode]["collectives"] == 0,
                  f"training: ZeRO ran {out[mode]} collectives, expected "
                  f"2 x {groups} dtype groups x {COMPARE_STEPS} steps")
        else:
            n_plan = len(hvd.plan_buckets(list(model.parameters()),
                                          basics.config().fusion_threshold))
            check(out[mode]["collectives"] == n_plan * COMPARE_STEPS,
                  f"training: {mode} ran {out[mode]['collectives']} "
                  f"collectives, expected {n_plan} buckets x "
                  f"{COMPARE_STEPS} steps")
        params[mode] = [p.detach().clone() for p in model.parameters()]
        del model, opt, step, adam
        torch.cuda.empty_cache()
    ref = params["off"]
    check(all(torch.equal(a, b) for a, b in zip(params["hooks"], ref)),
          "training: hook-mode parameters differ from overlap off's")
    diff = max(float((a - b).abs().max())
               for a, b in zip(params["zero"], ref))
    out["zero_max_abs_diff"] = diff
    check(diff <= ZERO_ATOL,
          f"training: ZeRO parameters differ from DistributedOptimizer's "
          f"by {diff:.3e} after {COMPARE_STEPS} steps (atol {ZERO_ATOL})")
    return out


def _remat_step(torch, flash, tokens, kernels):
    """One ``remat`` + ``fused_ce`` training step: the kernels' launches
    and the loss (the weights are the other models')."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models.train import make_train_step

    model = _lm(torch, flash, remat=True)
    step = make_train_step(model, hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-4)), fused_ce=True)
    for k in kernels:
        k.launches = 0
    loss = float(step(tokens))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    check(launches["flash_forward"] == 2 * LAYERS
          and launches["flash_bwd_dq"] == LAYERS
          and launches["flash_bwd_dkv"] == LAYERS,
          f"training: a remat step launched {launches}, expected K1 "
          f"{2 * LAYERS} (forward + recompute) and K2/K3 {LAYERS}")
    del model, step
    torch.cuda.empty_cache()
    return {"loss": loss, "launches": launches}


def _attention_parity(torch, flash, tokens):
    """One forward + backward of the same weights with flash and with the
    port's dense attention: loss and gradient global norm."""
    from horovod_tpu_torch.models.train import next_token_loss

    out = {}
    for name, fn in (("flash", flash), ("dense", None)):
        model = _lm(torch, fn)
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                              for p in model.parameters()))
        out[name] = {"loss": float(loss.detach()),
                     "grad_norm": float(norm)}
        del model, loss
        torch.cuda.empty_cache()
    for key, rtol in PARITY_RTOL.items():
        f, d = out["flash"][key], out["dense"][key]
        rel = abs(f - d) / abs(d)
        out[f"{key}_rel_diff"] = rel
        check(math.isfinite(f) and math.isfinite(d) and rel <= rtol,
              f"training: flash and dense {key} differ by {rel:.3e} "
              f"(flash {f}, dense {d}; rtol {rtol})")
    return out


def training_phase(torch, np, profile):
    """The bench lane's data-parallel step at GPT-2-small width and the
    lane's defaults (seq 2048, batch 8, bf16, flash attention, Adam 1e-4
    under DistributedOptimizer, NCCL world of one) on one fixed batch."""
    import functools

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.models.train import (create_train_state,
                                                make_train_step)
    from horovod_tpu_torch.ops import attention as fa

    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"training: expected an NCCL world of one, got "
          f"{dist.get_backend()} x {hvd.size()}")
    # bwd_impl pinned: K2/K3 stay on the path whatever "auto" resolves
    # to at this length.
    flash = functools.partial(fa.flash_attention, causal=True,
                              bwd_impl="kernel")
    rng = np.random.default_rng(5)
    tokens = torch.tensor(rng.integers(0, VOCAB, (FLASH_B, FLASH_L)),
                          device="cuda")
    parity = _attention_parity(torch, flash, tokens[:PARITY_BATCH])
    log(f"training: flash vs dense at batch {PARITY_BATCH}: loss "
        f"{parity['flash']['loss']:.6f} vs {parity['dense']['loss']:.6f} "
        f"(rel {parity['loss_rel_diff']:.2e}), grad norm "
        f"{parity['flash']['grad_norm']:.6f} vs "
        f"{parity['dense']['grad_norm']:.6f} "
        f"(rel {parity['grad_norm_rel_diff']:.2e})")

    model = _lm(torch, flash)
    n_params = sum(p.numel() for p in model.parameters())
    opt = create_train_state(model, torch.optim.Adam(model.parameters(),
                                                     lr=1e-4),
                             device="cuda")
    step = make_train_step(model, opt)
    plan = hvd.plan_buckets(list(model.parameters()),
                            basics.config().fusion_threshold)
    summary = hvd.plan_summary(plan)
    log(f"training: {n_params} parameters, bucket plan {summary}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = 0
    fused_reduce.collectives = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    collectives = fused_reduce.collectives
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"training: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"training: the loss did not fall on a fixed batch: {losses}")
    for name, n in launches.items():
        check(n == LAYERS * TRAIN_STEPS,
              f"training: {name} launched {n} times, expected {LAYERS} "
              f"layers x {TRAIN_STEPS} passes")
    check(collectives == len(plan) * TRAIN_STEPS,
          f"training: {collectives} bucket collectives, expected "
          f"{len(plan)} buckets x {TRAIN_STEPS} steps")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    result = {
        "losses": losses, "step_s": times, "median_step_s": step_s,
        "tokens_per_s": FLASH_B * FLASH_L / step_s,
        "peak_memory_bytes": peak, "launches": launches,
        "collectives": collectives, "plan": summary, "parity": parity,
        "params": n_params,
    }
    log(f"training: {TRAIN_STEPS} steps, losses {losses}, step s "
        f"{[round(t, 4) for t in times]}, median (steps 2-{TRAIN_STEPS}) "
        f"{step_s:.4f} s = {result['tokens_per_s']:.1f} tokens/s per card, "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}, "
        f"{collectives} NCCL bucket collectives")
    if profile:
        result["profile"] = _profile_steps(torch, step, tokens)
    del model, opt, step
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fce = _fused_ce_parity(torch, flash, tokens)
    log(f"training: fused vs unfused cross-entropy: loss "
        f"{fce['fused']['loss']:.7f} vs {fce['unfused']['loss']:.7f} "
        f"(rel {fce['loss_rel_diff']:.2e}), grad norm "
        f"{fce['fused']['grad_norm']:.6f} vs "
        f"{fce['unfused']['grad_norm']:.6f} "
        f"(rel {fce['grad_norm_rel_diff']:.2e}), peak memory "
        f"{fce['fused']['peak_memory_bytes'] / 2**30:.2f} vs "
        f"{fce['unfused']['peak_memory_bytes'] / 2**30:.2f} GiB")
    remat = _remat_step(torch, flash, tokens, kernels)
    rel = abs(remat["loss"] - fce["fused"]["loss"]) / fce["fused"]["loss"]
    check(rel <= 1e-6,
          f"training: the remat + fused_ce step's loss {remat['loss']} is "
          f"not the fused loss {fce['fused']['loss']} of the same weights "
          f"(rel {rel:.2e}; rtol 1e-6: remat recomputes the same "
          f"forward)")
    log(f"training: remat + fused_ce step: loss {remat['loss']:.7f}, "
        f"launches {remat['launches']}")
    cmp = _compare_steps(torch, flash, tokens)
    log(f"training: {COMPARE_STEPS} steps each: hooks == overlap off "
        f"bit for bit ({cmp['hooks']['collectives']} and "
        f"{cmp['off']['collectives']} bucket collectives); ZeRO "
        f"{cmp['zero']['zero_collectives']} collectives, "
        f"{cmp['zero']['shard_info']}, max abs diff "
        f"{cmp['zero_max_abs_diff']:.3e}; losses "
        f"{json.dumps({m: cmp[m]['losses'] for m in ('hooks', 'zero')})}; "
        f"{time.perf_counter() - t0:.1f} s")
    result.update({"fused_ce": fce, "remat": remat, "compare": cmp})
    if profile:
        model = _lm(torch, flash)
        fstep = make_train_step(model, create_train_state(
            model, torch.optim.Adam(model.parameters(), lr=1e-4),
            device="cuda"), fused_ce=True)
        result["profile_fused_ce"] = _profile_steps(
            torch, fstep, tokens, name="training_fused_ce")
        del model, fstep
        torch.cuda.empty_cache()
    hvd.shutdown()
    return result


def _on_device(events):
    """The kernels, copies and memsets among ``events``. A user
    annotation (``Optimizer.step#SGD.step``) also shows on the device
    timeline, spanning the kernels it encloses and the gaps between
    them, so it is left out: it would count that time twice."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _device_averages(prof):
    """A trace's device events summed by name (``--profile``'s tables)."""
    return _on_device(prof.key_averages())


def _device_events(prof):
    """A trace's device events, one a launch: read from the trace's
    events, not ``key_averages()``, which also sums every CPU op of the
    trace (most of the seconds a profiled serving run costs)."""
    return _on_device(prof.events())


def _profile_steps(torch, step, batch, name="training", steps=2):
    """``--profile``: training steps under ``torch.profiler``: device busy
    time, idle share of the wall, and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_averages(prof)
    busy_us = sum(e.self_device_time_total for e in dev)
    check(busy_us > 0, f"profile[{name}]: no device events traced")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    out = {"wall_s": wall, "steps": steps, "device_busy_s": busy_us / 1e6,
           "idle_share": 1 - busy_us / 1e6 / wall,
           "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                   for e in top]}
    log(f"profile[{name}]: {json.dumps(out)}")
    return out


# ------------------------------------------------------------- phase 7

RESNET_STEPS = 3
# Fused (K5) against unfused (cuDNN convs, statistics as a separate pass)
# BatchNorm, same weights and batch, one bf16 forward + backward: both
# round every conv output to bf16 from float32 sums taken in another
# order, so a y now and then rounds one bf16 ulp (2^-8) the other way,
# and 53 layers carry that along (the fused backward's products are
# cuBLAS's, the unfused cuDNN's, summed in other orders again). That
# moves the cross-entropy over 64 images and each layer's new running
# mean (0.1 of its batch mean, over 3136-200704 rows) by far less than
# 1e-3 (of the layer's largest), the gradients' global norm by less than
# 1e-2. Wrong statistics or a wrong prologue move a layer's running mean
# by its whole scale.
RESNET_PARITY_TOL = {"loss": 1e-3, "running_mean": 1e-3, "grad_norm": 1e-2}


def _resnet(torch, fused):
    from horovod_tpu_torch.models import resnet

    return resnet.build("resnet50", num_classes=CLASSES, fused_bn=fused,
                        seed=0, device="cuda")


def _resnet_parity(torch, batch):
    """One forward + backward of the same weights with fused and with
    unfused BatchNorm: loss, gradient global norm, new running means."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models.train import cross_entropy_loss

    out = {}
    for fused in (True, False):
        model = _resnet(torch, fused)
        loss = cross_entropy_loss(model(batch["image"]), batch["label"])
        loss.backward()
        norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                              for p in model.parameters()))
        means = [m.mean.clone() for m in model.modules()
                 if isinstance(m, resnet.ConvBN)]
        out[fused] = {"loss": float(loss.detach()), "grad_norm": float(norm),
                      "means": means}
        del model, loss
        torch.cuda.empty_cache()
    res = {}
    for key in ("loss", "grad_norm"):
        f, u = out[True][key], out[False][key]
        rel = abs(f - u) / abs(u)
        res[key] = {"fused": f, "unfused": u, "rel_diff": rel}
        check(math.isfinite(f) and math.isfinite(u)
              and rel <= RESNET_PARITY_TOL[key],
              f"resnet: fused and unfused {key} differ by {rel:.3e} (fused "
              f"{f}, unfused {u}; rtol {RESNET_PARITY_TOL[key]})")
    worst = 0.0
    for f, u in zip(out[True]["means"], out[False]["means"]):
        rel = float((f - u).abs().max() / u.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    res["running_mean"] = {"layers": len(out[True]["means"]),
                           "worst_rel_diff": worst}
    check(worst <= RESNET_PARITY_TOL["running_mean"],
          f"resnet: fused and unfused running means differ by {worst:.3e} "
          f"of a layer's largest (tol {RESNET_PARITY_TOL['running_mean']})")
    return res


def resnet_phase(torch, np, profile):
    """The image bench lane's step: ResNet-50 at full width with the JAX
    lane's defaults (224^2 synthetic images, 64 per card, 1000 classes,
    bf16 compute, SGD 0.01 momentum 0.9 under DistributedOptimizer,
    average_loss=False), ``--fused-bn``, an NCCL world of one, a few
    steps on one fixed batch."""
    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.models.train import (create_train_state,
                                                make_image_train_step)
    from horovod_tpu_torch.ops import conv_bn as cb

    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"resnet: expected an NCCL world of one, got "
          f"{dist.get_backend()} x {hvd.size()}")
    rng = np.random.default_rng(6)
    batch = {"image": torch.tensor(rng.standard_normal(
                 (IMG_B, IMG_SIZE, IMG_SIZE, 3), dtype=np.float32),
                 device="cuda"),
             "label": torch.tensor(rng.integers(0, CLASSES, IMG_B),
                                   device="cuda")}
    parity = _resnet_parity(torch, batch)
    log(f"resnet: fused vs unfused BatchNorm, one step at batch {IMG_B}: "
        f"{json.dumps(parity)}")

    model = _resnet(torch, True)
    n_params = sum(p.numel() for p in model.parameters())
    opt = create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        device="cuda")
    step = make_image_train_step(model, opt, average_loss=False)
    plan = hvd.plan_buckets(list(model.parameters()),
                            basics.config().fusion_threshold)
    summary = hvd.plan_summary(plan)
    log(f"resnet: {n_params} parameters, bucket plan {summary}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.bn_stats_forward.launches = 0
    cb.bn_stats_forward.prologue_launches = 0
    fused_reduce.collectives = 0
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = cb.bn_stats_forward.launches
    prologue = cb.bn_stats_forward.prologue_launches
    collectives = fused_reduce.collectives
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"resnet: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"resnet: the loss did not fall on a fixed batch: {losses}")
    check(launches == 36 * RESNET_STEPS and prologue == 16 * RESNET_STEPS,
          f"resnet: K5 launched {launches} times ({prologue} with the "
          f"prologue), expected 36 x {RESNET_STEPS} (16 x {RESNET_STEPS})")
    check(collectives == len(plan) * RESNET_STEPS,
          f"resnet: {collectives} bucket collectives, expected "
          f"{len(plan)} buckets x {RESNET_STEPS} steps")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    result = {
        "losses": losses, "step_s": times, "median_step_s": step_s,
        "img_per_s": IMG_B / step_s, "peak_memory_bytes": peak,
        "launches": launches, "prologue_launches": prologue,
        "collectives": collectives, "plan": summary, "parity": parity,
        "params": n_params,
    }
    log(f"resnet: {RESNET_STEPS} steps, losses {losses}, step s "
        f"{[round(t, 4) for t in times]}, median (steps 2-{RESNET_STEPS}) "
        f"{step_s:.4f} s = {result['img_per_s']:.1f} img/s per card, peak "
        f"memory {peak / 2**30:.2f} GiB, K5 launches {launches} "
        f"({prologue} with the prologue), {collectives} NCCL bucket "
        "collectives")
    if profile:
        result["profile"] = {"fused": _profile_steps(torch, step, batch,
                                                     "resnet fused")}
        del model, opt, step
        torch.cuda.empty_cache()
        model = _resnet(torch, False)
        opt = create_train_state(
            model, torch.optim.SGD(model.parameters(), lr=0.01,
                                   momentum=0.9), device="cuda")
        step = make_image_train_step(model, opt, average_loss=False)
        for _ in range(3):                       # cuDNN's first calls
            step(batch)
        result["profile"]["unfused"] = _profile_steps(
            torch, step, batch, "resnet unfused")
    hvd.shutdown()
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- phase 8

# Two windows of K steps against 2K eager steps from the same weights
# with the same optimizer (Adam with capturable=True, which a capture
# needs, in both). A window's first step is an eager warm-up step, then
# the capture (which runs nothing), then replays; a replay runs the same
# kernels in the same order on the same buffers as an eager step, so the
# window means, the parameters and the BatchNorm statistics must be
# equal bit for bit. cuDNN is pinned to its deterministic algorithms for
# the ResNet A/B (a non-deterministic weight-gradient algorithm would
# make two eager runs differ as well). The NCCL kernels of a replayed
# window are held to an eager window's: over one rank NCCL launches no
# kernel for an in-place all-reduce (0 in both traces, NVIDIA H100,
# torch 2.11), so on one card the wrapper's issue count (the plan, for
# each of the warm-up and the capture) is the check that bites.
# Windows of 2 (they were 3 before the hier phase, which they pay
# toward): the first window still holds a warm-up, the capture and a
# replay, and the second only replays.
WINDOW_K, WINDOWS = 2, 2
# The LM lanes' depth: 2 of GPT-2-small's 12 layers (the phase's depth
# cut, which pays toward phases 20 to 22; every check is kept, at this
# depth).
WINDOW_LAYERS = 2


def _window_mean(torch, outs):
    """The means of per-step metrics as ``distributed.window`` accumulates
    them: the first cloned, the rest added in order, divided by the
    count."""
    if isinstance(outs[0], dict):
        return {k: _window_mean(torch, [o[k] for o in outs]) for k in outs[0]}
    total = outs[0].detach().clone()
    for o in outs[1:]:
        total = torch.add(total, o)
    return total / len(outs)


def _trace_counts(events, names):
    """Device ``events`` whose name holds each of ``names``
    (case-insensitive), counted."""
    return {n: sum(1 for e in events if n.lower() in e.key.lower())
            for n in names}


def _profile_run(torch, fn, names, warmup=None):
    """``fn`` once under ``torch.profiler``: wall, device busy time, idle
    share, and the trace's counts of the named kernels. With ``warmup``,
    the profiler first traces ``warmup()`` as its warm-up step and drops
    its events, so the tracer is running before ``fn`` starts: a trace
    that begins with a graph replay can lose the replay's first kernels
    (one layer's pair of K4 kernels of a fleet tick, on the card)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=(None if warmup is None else
                           schedule(wait=0, warmup=1, active=1,
                                    repeat=1))) as prof:
        if warmup is not None:
            warmup()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if warmup is not None:
            prof.step()
    events = _device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "counts": _trace_counts(events, names)}


def _state_of(torch, model):
    return ([p.detach().clone() for p in model.parameters()]
            + [b.detach().clone() for b in model.buffers()])


def _bit_diff(torch, a, b):
    """The largest absolute difference between two lists of tensors: 0.0
    only when they are equal bit for bit."""
    worst = 0.0
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            worst = max(worst, float((x.double() - y.double()).abs().max()),
                        1e-300)
    return worst


def _window_ab(torch, name, build, batch, kernels, profile_names):
    """Two windows of ``WINDOW_K`` steps against ``2 WINDOW_K`` eager
    steps, each from a fresh ``build()`` (the same seed): the means and
    the model state bit for bit; the step time (the second window of
    each), the peak memory, the wrapper launches and collectives of each
    run, and the window's captures, replays, capture and warm-up times;
    then one more window of each under the profiler, after a traced
    warm-up window whose events are dropped: idle share and the trace's
    counts of ``profile_names``."""
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.distributed.window import repeat_batch, windowed
    from horovod_tpu_torch.distributed.zero import \
        sharded_distributed_optimizer

    out, states, means = {}, {}, {}
    for kind in ("eager", "window"):
        model, step = build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        fused_reduce.collectives = 0
        sharded_distributed_optimizer.collectives = 0
        if kind == "eager":
            def run():
                return _window_mean(torch, [step(batch)
                                            for _ in range(WINDOW_K)])
        else:
            win = windowed(step, WINDOW_K)
            stacked = repeat_batch(batch, WINDOW_K)

            def run():
                return win(stacked)
        got, secs = [], []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            got.append(run())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        res = {
            "means": [{k: float(v) for k, v in m.items()}
                      if isinstance(m, dict) else float(m) for m in got],
            "window_s": secs, "step_ms": secs[-1] / WINDOW_K * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k.__name__: k.launches for k in kernels},
            "collectives": fused_reduce.collectives,
            "zero_collectives": sharded_distributed_optimizer.collectives,
        }
        if kind == "window":
            res.update(captures=win.step.captures, replays=win.step.replays,
                       capture_s=win.step.capture_s,
                       warmup_s=win.step.warmup_s)
        states[kind] = _state_of(torch, model)
        means[kind] = [v for m in got for v in (
            m.values() if isinstance(m, dict) else [m])]
        # The trace starts on a warm-up window: one that starts on a
        # graph replay can lose the replay's first kernel. A trace only
        # ever loses kernels (one replayed ResNet-50 window's held none,
        # its wrapper counts right; one LM window's lost one K1), so two
        # are taken and the fuller one is checked.
        res["profile"] = max(
            (_profile_run(torch, run, profile_names, warmup=run)
             for _ in range(2)),
            key=lambda p: sum(p["counts"].values()))
        out[kind] = res
        del model, step, run, got
        if kind == "window":
            del win, stacked
        torch.cuda.empty_cache()
    e, w = out["eager"], out["window"]
    diff = _bit_diff(torch, states["eager"], states["window"])
    mdiff = _bit_diff(torch, means["eager"], means["window"])
    out["max_abs_diff"] = {"state": diff, "means": mdiff}
    check(diff == 0.0 and mdiff == 0.0,
          f"window[{name}]: {WINDOWS} windows of {WINDOW_K} differ from "
          f"{WINDOWS * WINDOW_K} eager steps: state max abs diff {diff:.3e}, "
          f"means {mdiff:.3e} (eager {e['means']}, window {w['means']})")
    check(w["captures"] == 1 and w["replays"] == WINDOWS * WINDOW_K - 1,
          f"window[{name}]: {w['captures']} captures and {w['replays']} "
          f"replays, expected 1 and {WINDOWS * WINDOW_K - 1} (one warm-up "
          "step)")
    return out


def _lm_window_lane(torch, flash, mode):
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models.train import make_train_step

    def build():
        model = _lm(torch, flash, remat=mode == "fused_ce_remat",
                    layers=WINDOW_LAYERS)
        adam = torch.optim.Adam(model.parameters(), lr=1e-4,
                                capturable=True)
        opt = (hvd.sharded_distributed_optimizer(adam) if mode == "zero"
               else hvd.DistributedOptimizer(adam, overlap="on"))
        return model, make_train_step(model, opt,
                                      fused_ce=mode == "fused_ce_remat")

    return build


def window_phase(torch, np):
    """The window lanes on the card: the LM (hooks, ZeRO, fused_ce +
    remat) and ResNet-50 ``--fused-bn`` as replays of one captured step,
    each against the same number of eager steps, with the wrapper
    launches and collectives of the warm-up and the capture, and the
    kernels the trace counts in one replayed window."""
    import functools

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models.train import make_image_train_step
    from horovod_tpu_torch.ops import attention as fa
    from horovod_tpu_torch.ops import conv_bn as cb

    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"window: expected an NCCL world of one, got "
          f"{dist.get_backend()} x {hvd.size()}")
    flash = functools.partial(fa.flash_attention, causal=True,
                              bwd_impl="kernel")
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, VOCAB, (FLASH_B, FLASH_L)), device="cuda")
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    lm_names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "nccl")
    result, lm_plan = {}, None
    for mode in ("hooks", "zero", "fused_ce_remat"):
        t0 = time.perf_counter()
        ab = _window_ab(torch, f"lm {mode}",
                        _lm_window_lane(torch, flash, mode), tokens,
                        kernels, lm_names)
        w = ab["window"]
        k1 = (2 * WINDOW_LAYERS if mode == "fused_ce_remat"
              else WINDOW_LAYERS)
        check(w["launches"] == {"flash_forward": 2 * k1,
                                "flash_bwd_dq": 2 * WINDOW_LAYERS,
                                "flash_bwd_dkv": 2 * WINDOW_LAYERS},
              f"window[lm {mode}]: wrapper launches {w['launches']}, "
              f"expected K1 {k1}, K2/K3 {WINDOW_LAYERS} for each of the "
              "warm-up and the capture")
        counts = w["profile"]["counts"]
        check(counts["flash_fwd"] == k1 * WINDOW_K
              and counts["flash_bwd_dq"] == WINDOW_LAYERS * WINDOW_K
              and counts["flash_bwd_dkv"] == WINDOW_LAYERS * WINDOW_K,
              f"window[lm {mode}]: a replayed window of {WINDOW_K} traced "
              f"{counts}, expected K1 {k1} and K2/K3 {WINDOW_LAYERS} a step")
        if mode == "zero":
            per_step = 2                  # one float32 group: RS + AG
            issued = w["zero_collectives"]
        else:
            if lm_plan is None:           # the same parameters each lane
                model = _lm(torch, flash, layers=WINDOW_LAYERS)
                lm_plan = len(hvd.plan_buckets(
                    list(model.parameters()),
                    basics.config().fusion_threshold))
                del model
            per_step = lm_plan
            issued = w["collectives"]
        ab["collectives_a_step"] = per_step
        eager_nccl = ab["eager"]["profile"]["counts"]["nccl"]
        check(issued == 2 * per_step and counts["nccl"] == eager_nccl,
              f"window[lm {mode}]: {issued} collectives issued (expected "
              f"{per_step} for each of the warm-up and the capture); NCCL "
              f"kernels traced in a window: {counts['nccl']} replayed, "
              f"{eager_nccl} eager")
        torch.cuda.empty_cache()
        ab["seconds"] = time.perf_counter() - t0
        result[f"lm_{mode}"] = ab
        log(f"window[lm {mode}]: {json.dumps(ab)}")

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    batch = {"image": torch.tensor(rng.standard_normal(
                 (IMG_B, IMG_SIZE, IMG_SIZE, 3), dtype=np.float32),
                 device="cuda"),
             "label": torch.tensor(rng.integers(0, CLASSES, IMG_B),
                                   device="cuda")}

    def build_resnet():
        model = _resnet(torch, True)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.01, momentum=0.9))
        return model, make_image_train_step(model, opt, average_loss=False)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ab = _window_ab(torch, "resnet", build_resnet, batch,
                        (cb.bn_stats_forward,),
                        ("conv_bn_bf16_kernel", "nccl"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    w = ab["window"]
    counts = w["profile"]["counts"]
    model = _resnet(torch, True)
    per_step = len(hvd.plan_buckets(list(model.parameters()),
                                    basics.config().fusion_threshold))
    del model
    ab["collectives_a_step"] = per_step
    check(w["launches"] == {"bn_stats_forward": 2 * 36}
          and counts["conv_bn_bf16_kernel"] == 36 * WINDOW_K,
          f"window[resnet]: K5 wrapper launches {w['launches']} (expected "
          f"36 for each of the warm-up and the capture), "
          f"{counts['conv_bn_bf16_kernel']} traced in a replayed window "
          f"(expected 36 x {WINDOW_K})")
    eager_nccl = ab["eager"]["profile"]["counts"]["nccl"]
    check(w["collectives"] == 2 * per_step and counts["nccl"] == eager_nccl,
          f"window[resnet]: {w['collectives']} bucket collectives issued "
          f"(expected {per_step} for each of the warm-up and the capture); "
          f"NCCL kernels traced in a window: {counts['nccl']} replayed, "
          f"{eager_nccl} eager")
    ab["seconds"] = time.perf_counter() - t0
    result["resnet"] = ab
    log(f"window[resnet]: {json.dumps(ab)}")
    hvd.shutdown()
    del batch, tokens
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- phase 9


def _requests(np):
    """8 requests, prompts of 64-256 tokens, 32 new tokens each, in three
    waves so that requests join and leave mid-batch."""
    rng = np.random.default_rng(1)
    lens = rng.integers(64, 257, 8)
    prompts = [rng.integers(0, VOCAB, int(n)).astype(np.int32)
               for n in lens]
    waves = [(prompts[0:3], 6), (prompts[3:6], 10), (prompts[6:8], 0)]
    return prompts, waves


def _top2_gap(torch, params, tokens):
    from horovod_tpu_torch.models.parallel_lm import lm_prefill

    with torch.no_grad():
        _, logits = lm_prefill(params, torch.tensor(
            tokens, dtype=torch.long, device="cuda")[None])
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


NEW_TOKENS = 32


def _warm_engine(torch, params, prompts, mode, capture, **knobs):
    """An engine in ``mode`` (``knobs``: more ``ServeConfig`` fields),
    warmed by one short request (on the card with ``capture``: its first
    decode or speculative step is the warm-up step and the capture of
    the lane, the rest replays), metrics reset."""
    from horovod_tpu_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(params, ServeConfig(
        page_size=PAGE, num_pages=NUM_PAGES, decode_slots=SLOTS,
        prefill_chunk=CHUNK, attention=mode, **knobs), device="cuda",
        capture=capture)
    eng.submit(prompts[0][:16], 4)
    eng.run()
    torch.cuda.synchronize()
    eng.reset_metrics()
    return eng


def _serve(torch, eng, waves):
    """Submit the waves, drain, synchronise; returns (requests, wall s)."""
    t0 = time.perf_counter()
    reqs = []
    for wave, steps in waves:
        reqs += [eng.submit(p, NEW_TOKENS) for p in wave]
        for _ in range(steps):
            eng.step()
    eng.run(max_steps=2000)
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


#: The engine runs: each attention mode with the decode lane captured
#: (the engine's default on the card) and eager (``capture=False``).
ENGINE_RUNS = (("paged", True), ("paged", False), ("gather", True),
               ("gather", False))


def _run_name(mode, capture):
    return mode if capture else f"{mode}_eager"


#: The engine phase's depth: 4 of GPT-2-small's 12 layers (the phase's
#: depth cut, which pays toward the harness and examples phases; every
#: check is kept, at this depth).
ENGINE_LAYERS = 4
#: Speculative decoding at the serving geometry: k = 4, the draft auto
#: (half the depth: 2 layers), so K4 runs 8 times a live tick in
#: ``paged`` mode; runs (name, attention, captured, draft layers), the
#: last with a full-depth draft, which must accept every proposal.
SPEC_K, SPEC_DRAFT = 4, ENGINE_LAYERS // 2
SPEC_RUNS = (("spec_paged", "paged", True, 0),
             ("spec_paged_eager", "paged", False, 0),
             ("spec_gather", "gather", True, 0),
             ("spec_full_paged", "paged", True, ENGINE_LAYERS))
#: Prefix caching: 8 requests sharing a 128-token system prompt (8 whole
#: pages) with distinct tails, paged and captured, the cache on and off.
SYSTEM_PROMPT = 128


def _check_streams(torch, params, prompts, runs, names, ref_name):
    """Every run's greedy streams equal ``ref_name``'s; on a divergence,
    the first position and the top-2 logit gap there."""
    for name in names:
        for i, (a, b) in enumerate(zip(runs[name]["reqs"],
                                       runs[ref_name]["reqs"])):
            j = _first_divergence(a.output, b.output)
            if j is not None:
                gap = _top2_gap(torch, params,
                                list(prompts[i]) + list(b.output[:j]))
                raise SmokeFailure(
                    f"request {i}: {name} and {ref_name} streams diverge "
                    f"at generated position {j} (top-2 logit gap there "
                    f"{gap:.3e})")


def _check_lm_decode(torch, params, prompts, reqs, what):
    from horovod_tpu_torch.models.parallel_lm import lm_decode

    for i in (0, 1):
        ref = lm_decode(params, prompts[i][None], NEW_TOKENS,
                        device="cuda")[0].tolist()
        j = _first_divergence(reqs[i].output, ref)
        if j is not None:
            gap = _top2_gap(torch, params, list(prompts[i]) + ref[:j])
            raise SmokeFailure(
                f"request {i}: {what} and lm_decode diverge at generated "
                f"position {j} (top-2 logit gap there {gap:.3e})")


def _serve_run(torch, params, prompts, waves, name, mode, capture,
               **knobs):
    """One engine run of the phase: warm (with ``prompts``, the plain
    runs' requests, so a prefix index starts cold), set K4's count to 0,
    serve the waves, read the count; every request must finish."""
    from horovod_tpu_torch.ops.paged_attention import paged_attention_decode

    paged_attention_decode.launches = 0
    eng = _warm_engine(torch, params, prompts, mode, capture, **knobs)
    warm_launches = paged_attention_decode.launches
    # Greedy requests: the lane's one graph is the one without the
    # sampled draw.
    graph = (eng.lane_graphs or {}).get(False)
    replays0 = graph.replays if graph else 0
    paged_attention_decode.launches = 0
    reqs, wall = _serve(torch, eng, waves)
    run = dict(reqs=reqs, launches=paged_attention_decode.launches,
               warm_launches=warm_launches,
               live_steps=sum(1 for s in eng.attn_len_samples if any(s)),
               steps=eng.steps, stats=eng.stats(), wall=wall)
    check(all(r.state == "finished" and len(r.output) == NEW_TOKENS
              for r in reqs),
          f"{name}: not every request finished: "
          f"{[(r.state, len(r.output)) for r in reqs]}")
    check((graph is not None) == capture
          and (not capture or set(eng.lane_graphs) == {False}),
          f"{name}: lane graphs {eng.lane_graphs}, capture {capture}")
    if graph is not None:
        run.update(captures=graph.captures,
                   replays=graph.replays - replays0,
                   capture_s=graph.capture_s, warmup_s=graph.warmup_s)
        check(graph.captures == 1 and run["replays"] == run["live_steps"],
              f"{name}: {graph.captures} captures, {run['replays']} "
              f"replays while serving, expected 1 and {run['live_steps']} "
              "(one a live step)")
    st = run["stats"]
    log(f"engine[{name}]: {len(reqs)} requests, {eng.steps} steps "
        f"({run['live_steps']} with a live decode slot), wall {wall:.3f} "
        f"s, tokens/s {st['tokens_per_sec_per_chip']}, TTFT ms p50 "
        f"{st['ttft_ms']['p50']} p99 {st['ttft_ms']['p99']}, per-token "
        f"ms p50 {st['tbt_ms']['p50']} p99 {st['tbt_ms']['p99']}, kernel "
        f"launches {run['launches']} (warm-up request {warm_launches})"
        + (f", capture {graph.capture_s:.3f} s, {run['replays']} replays"
           if graph else ""))
    return eng, run


def _prefix_requests(np):
    """The prefix runs' 8 requests: one 128-token system prompt + a tail
    of 16-128 tokens each, in the waves of :func:`_requests`."""
    rng = np.random.default_rng(2)
    system = rng.integers(0, VOCAB, SYSTEM_PROMPT).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(
        0, VOCAB, int(n)).astype(np.int32)]) for n in rng.integers(16, 129,
                                                                  8)]
    return prompts, [(prompts[0:3], 6), (prompts[3:6], 10),
                     (prompts[6:8], 0)]


def _sampled_spec_checks(torch, np, params, prompts):
    """The draft's device-side draw: its counter hash on the card gives
    the host form's bits, and three sampled requests (temperature 0.8,
    top-k 50) draw the same streams captured and eager."""
    from horovod_tpu_torch.serve import sampling

    rng = np.random.default_rng(3)
    seeds, pos = rng.integers(0, 2 ** 40, 256), rng.integers(0, 2 ** 33, 256)
    for fold in (0, sampling.DRAFT_FOLD, sampling.ACCEPT_FOLD):
        got = sampling._key_t(torch.tensor(seeds, device="cuda"),
                              torch.tensor(pos, device="cuda"), fold)
        want = [sampling._signed(sampling._key64(a, b, fold))
                for a, b in zip(seeds, pos)]
        check(got.tolist() == want,
              f"the draft's hash on the card differs from the host's "
              f"(fold {fold})")
    outs = []
    for capture in (True, False):
        eng = _warm_engine(torch, params, prompts, "paged", capture,
                           speculate_k=SPEC_K)
        reqs = [eng.submit(prompts[i], NEW_TOKENS, temperature=0.8,
                           top_k=50, seed=7 + i) for i in range(3)]
        eng.run()
        check(all(len(r.output) == NEW_TOKENS for r in reqs),
              "sampled speculative requests did not finish")
        outs.append([r.output for r in reqs])
        if capture:
            graphs = eng.lane_graphs
            check(set(graphs) == {False, True}
                  and graphs[False].captures == graphs[True].captures == 1,
                  f"a greedy warm-up and sampled requests made the lane "
                  f"graphs {graphs}, expected one of each, captured once")
            lane_ms = _lane_graph_ms(torch, graphs)
    check(outs[0] == outs[1],
          f"sampled speculative streams differ captured and eager: {outs}")
    log("engine: the draft's hash equals the host's on the card; three "
        "sampled speculative streams equal captured and eager")
    log(f"engine[spec_paged]: one replay of the speculative lane, median "
        f"of 20 (CUDA events): {lane_ms[False]:.4f} ms without the "
        f"sampled draw (all live slots greedy), {lane_ms[True]:.4f} ms "
        f"with it")
    return lane_ms


def _lane_graph_ms(torch, graphs):
    """Median device ms of one replay of each captured lane graph, on the
    inputs of the engine's last tick (the engine is idle: the rows it
    writes land in free pages)."""
    ms = {}
    for sampled, graph in graphs.items():
        times = []
        for _ in range(20):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            graph()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms[sampled] = sorted(times)[len(times) // 2]
    return ms


def spec_prefix_runs(torch, np, params, prompts, waves, runs):
    """Phase 9's speculative and prefix runs (added to ``runs``): greedy
    streams equal the plain engine's and ``lm_decode``'s; eager paged
    speculation launches K4 ``draft_layers x k`` times a live tick and
    the captured lane only for its warm-up and capture, and a profiled
    captured run traces as many; the full-depth draft accepts every
    proposal; prefix hits skip prefill with no COW copy and leave the
    streams as they are."""
    per_tick = SPEC_DRAFT * SPEC_K
    for name, mode, capture, draft in SPEC_RUNS:
        eng, runs[name] = _serve_run(
            torch, params, prompts, waves, name, mode, capture,
            speculate_k=SPEC_K, draft_layers=draft)
        log(f"engine[{name}]: spec_stats {eng.spec_stats()}")
        check(eng.draft_layers == (draft or SPEC_DRAFT),
              f"{name}: draft of {eng.draft_layers} layers")
    _check_streams(torch, params, prompts, runs,
                   [n for n, *_ in SPEC_RUNS], "gather_eager")
    log(f"engine: the speculative streams equal the plain engine's "
        f"({[n for n, *_ in SPEC_RUNS]})")
    eager, cap = runs["spec_paged_eager"], runs["spec_paged"]
    check(eager["launches"] == per_tick * eager["live_steps"] > 0,
          f"spec_paged_eager: {eager['launches']} kernel launches, "
          f"expected {SPEC_DRAFT} x {SPEC_K} x {eager['live_steps']} live "
          "ticks")
    check(cap["warm_launches"] == 2 * per_tick and cap["launches"] == 0,
          f"spec_paged: {cap['warm_launches']} kernel launches warming "
          f"up and {cap['launches']} serving, expected {2 * per_tick} "
          "(warm-up + capture) and 0 (replays)")
    g = runs["spec_gather"]
    check(g["launches"] + g["warm_launches"] == 0,
          "spec_gather launched the kernel")
    full = runs["spec_full_paged"]["stats"]["spec"]
    check(full["accept_rate"] == 1.0 and full["tokens_per_step"] > 1,
          f"spec_full_paged: a full-depth draft accepted {full}")
    eng = _warm_engine(torch, params, prompts, "paged", True,
                       speculate_k=SPEC_K)
    prof = _profile_run(torch, lambda: _serve(torch, eng, waves),
                        ("paged_split", "paged_merge"))
    live = sum(1 for s in eng.attn_len_samples if any(s))
    check(prof["counts"]["paged_split"] == per_tick * live
          and prof["counts"]["paged_merge"] == per_tick * live,
          f"spec_paged: a captured run traced {prof['counts']}, expected "
          f"{per_tick} x {live} live ticks of each kernel")
    cap["replay_launches"] = prof["counts"]["paged_split"]
    cap["replay_profile"] = prof
    log(f"engine[spec_paged]: captured run under the profiler: "
        f"{prof['counts']} for {live} live ticks, idle share "
        f"{prof['idle_share']:.3f}")
    del eng
    cap["lane_ms"] = _sampled_spec_checks(torch, np, params, prompts)

    pprompts, pwaves = _prefix_requests(np)
    for name, on in (("prefix_off", False), ("prefix_on", True)):
        eng, runs[name] = _serve_run(torch, params, prompts, pwaves, name,
                                     "paged", True, prefix_caching=on)
        st = runs[name]["stats"]
        log(f"engine[{name}]: TTFT ms p50 {st['ttft_ms']['p50']} p99 "
            f"{st['ttft_ms']['p99']}, prefix {st.get('prefix')}")
    _check_streams(torch, params, pprompts, runs, ["prefix_on"],
                   "prefix_off")
    _check_lm_decode(torch, params, pprompts, runs["prefix_on"]["reqs"],
                     "prefix_on")
    pst = runs["prefix_on"]["stats"]["prefix"]
    check(pst["hits"] == len(pprompts) - 1
          and pst["prefill_tokens_saved"] == SYSTEM_PROMPT * pst["hits"]
          and pst["cow_copies"] == 0,
          f"prefix_on: hits, skipped prefill tokens and COW copies {pst}")
    log("engine: prefix hits leave the 8 streams as they are, and "
        "streams 0 and 1 equal lm_decode's")
    del eng
    torch.cuda.empty_cache()


def engine_phase(torch, np):
    from horovod_tpu_torch.models.parallel_lm import (init_lm_params,
                                                      lm_decode)

    t0 = time.perf_counter()
    params = init_lm_params(0, VOCAB, LMAX, ENGINE_LAYERS, HEADS, HEAD_DIM,
                            FFN, device="cuda")
    log(f"engine: params {sum(p.numel() for p in _leaves(params))} "
        f"float32 on the card in {time.perf_counter() - t0:.1f} s")
    prompts, waves = _requests(np)
    runs = {}
    for mode, capture in ENGINE_RUNS:
        name = _run_name(mode, capture)
        runs[name] = _serve_run(torch, params, prompts, waves, name, mode,
                                capture)[1]

    paged, eager = runs["paged"], runs["paged_eager"]
    check(eager["launches"] == ENGINE_LAYERS * eager["live_steps"],
          f"paged_eager: {eager['launches']} kernel launches, expected "
          f"{ENGINE_LAYERS} x {eager['live_steps']} live decode steps")
    check(eager["launches"] > 0, "paged_eager: the kernel never ran")
    # Captured: the wrapper launches at the warm-up request's first decode
    # step (the eager warm-up step, then the capture) and never again.
    check(paged["warm_launches"] == 2 * ENGINE_LAYERS
          and paged["launches"] == 0,
          f"paged: {paged['warm_launches']} kernel launches warming up and "
          f"{paged['launches']} serving, expected {2 * ENGINE_LAYERS} "
          "(warm-up + capture) and 0 (replays)")
    for name in ("gather", "gather_eager"):
        check(runs[name]["launches"] + runs[name]["warm_launches"] == 0,
              f"{name} mode launched the kernel")
    _check_streams(torch, params, prompts, runs, list(runs),
                   "gather_eager")
    log(f"engine: {len(prompts)} greedy streams identical across "
        f"{sorted(runs)}")
    _check_lm_decode(torch, params, prompts, runs["gather_eager"]["reqs"],
                     "engine")
    log("engine: streams 0 and 1 equal lm_decode's")

    # The device-side form of the launch check: K4's two kernels in the
    # trace of a captured run, ENGINE_LAYERS a live decode step.
    eng = _warm_engine(torch, params, prompts, "paged", True)
    prof = _profile_run(torch, lambda: _serve(torch, eng, waves),
                        ("paged_split", "paged_merge"))
    live = sum(1 for s in eng.attn_len_samples if any(s))
    counts = prof["counts"]
    check(counts["paged_split"] == ENGINE_LAYERS * live
          and counts["paged_merge"] == ENGINE_LAYERS * live,
          f"paged: a captured run traced {counts}, expected "
          f"{ENGINE_LAYERS} x {live} live decode steps of each kernel")
    paged["replay_launches"] = counts["paged_split"]
    paged["replay_profile"] = prof
    log(f"engine[paged]: captured run under the profiler: {counts} for "
        f"{live} live decode steps, idle share {prof['idle_share']:.3f}")

    # A weight swap re-captures the lane over the new weights.
    other = init_lm_params(1, VOCAB, LMAX, ENGINE_LAYERS, HEADS, HEAD_DIM,
                           FFN, device="cuda")
    eng.update_params(other)
    req = eng.submit(prompts[0], 8)
    eng.run()
    ref = lm_decode(other, prompts[0][None], 8, device="cuda")[0].tolist()
    check(req.output == ref and ref != runs["paged"]["reqs"][0].output[:8]
          and eng.lane_graphs[False].captures == 2,
          f"paged: after update_params the stream {req.output} is not "
          f"lm_decode's {ref} over the new weights, or the lane was not "
          f"captured again ({eng.lane_graphs[False].captures} captures)")
    log("engine: update_params re-captured the lane; the stream equals "
        "lm_decode's over the new weights")
    del eng, other
    torch.cuda.empty_cache()
    spec_prefix_runs(torch, np, params, prompts, waves, runs)
    return runs, params, prompts, waves


# ------------------------------------------------------------- phase 10

#: The fleet phase's placements and budgets. Spawn covers a worker's
#: torch import, CUDA context, the wire push of the ~538 MB float32
#: artifact and the engine build; the first step RPC after it waits out
#: the first capture.
FLEET_REPLICAS = 2
# The fleet's and the pools' LM: 2 of GPT-2-small's 12 layers (phases 10
# and 11's depth cut, which pays toward phases 20 to 22; every check
# kept, at this depth), the TP phases' depth too, so that phases 10, 11, 13
# and 13b hold their streams to one single-card reference run
# (:func:`tp_references`).
FLEET_LAYERS = 2
FLEET_SPAWN_S, FLEET_RPC_S = 180.0, 180.0
FLEET_TIMEOUT_S = 300.0


def _reserved_mib(torch):
    return torch.cuda.memory_reserved() / 2**20


class _FleetWatch:
    """Counts K4's wrapper launches per replica (each replica engine's
    ``step`` is wrapped: the counter's delta across it) and records the
    card's reserved memory around each replica's captures."""

    def __init__(self, torch, fl):
        self.torch, self.fl = torch, fl
        self.launches = {}
        self.captured = {}
        #: (replica, capture number, MiB reserved before, after)
        self.captures = []

    def wrap(self):
        from horovod_tpu_torch.ops.paged_attention import \
            paged_attention_decode as k4

        for rep in self.fl.replicas:
            eng = rep.engine
            if eng is None or getattr(eng, "_watched", False):
                continue
            step = eng.step

            def counted(step=step, rid=rep.id, eng=eng):
                n0, mib0 = k4.launches, _reserved_mib(self.torch)
                out = step()
                self.launches[rid] = self.launches.get(rid, 0) + \
                    k4.launches - n0
                g = (eng.lane_graphs or {}).get(False)
                caps = g.captures if g else 0
                if caps > self.captured.get(id(eng), 0):
                    self.captured[id(eng)] = caps
                    mib = _reserved_mib(self.torch)
                    self.captures.append((rid, caps, mib0, mib))
                    log(f"fleet: replica {rid} capture {caps}: reserved "
                        f"{mib0:.1f} -> {mib:.1f} MiB")
                return out

            eng.step = counted
            eng._watched = True


def _fleet_serve(torch, fl, waves, watch=None, kill_at=None):
    """The engine phase's waves through a fleet: submit each wave, step
    the fleet, drain; ``kill_at`` arms ``kill:replica=N`` as soon as that
    replica holds a request mid-decode. Returns (requests, wall s)."""
    t0 = time.perf_counter()
    reqs = []
    armed = kill_at is None

    def tick():
        nonlocal armed
        if watch is not None:
            watch.wrap()
        progressed = fl.step()
        if not armed:
            rep = fl.replicas[kill_at]
            if any(r.generated for r in rep.assigned):
                fl.arm_fault_plan(f"kill:replica={kill_at},at=0s")
                armed = True
        return progressed

    for wave, steps in waves:
        reqs += [fl.submit(p, NEW_TOKENS) for p in wave]
        for _ in range(steps):
            tick()
    while not fl.idle or fl.update_active:
        check(time.perf_counter() - t0 < FLEET_TIMEOUT_S,
              f"fleet: not drained in {FLEET_TIMEOUT_S} s: "
              f"{[r.state for r in reqs]}")
        if not tick():
            time.sleep(0.0005)
    torch.cuda.synchronize()
    check(armed, f"fleet: replica {kill_at} never held a request "
          "mid-decode, the kill was never armed")
    return reqs, time.perf_counter() - t0


def _fleet_stats(fl, wall):
    """The fleet's numbers of one run. ``stats()`` divides the tokens by
    one chip per replica, as the reference does; here every replica
    shares the one card, so the card's own rate is that times the
    replicas: ``tokens_per_sec_per_card`` is the figure to hold against
    the single engine's."""
    st = fl.stats()
    f = st["fleet"]
    per_replica = st["tokens_per_sec_per_chip"]
    return {"tokens_per_sec_per_card": round(per_replica * fl.chips, 1),
            "tokens_per_sec_per_replica": per_replica,
            "ttft_ms": st["ttft_ms"], "tbt_ms": st["tbt_ms"],
            "wall_s": wall, "by_state": st["by_state"],
            "incidents_by_class": f["incidents_by_class"],
            "redispatched": f["redispatched"],
            "tokens_recomputed": f["tokens_recomputed"],
            "restarts_used": f["restarts_used"], "rpc_ms": f["rpc_ms"],
            "params_push": f["params_push"]}


def _fleet_check(torch, params, prompts, name, reqs, ref, what):
    """Every request finished with NEW_TOKENS tokens (none emitted twice)
    and its stream equals ``ref``'s."""
    for i, r in enumerate(reqs):
        check(r.state == "finished" and len(r.output) == NEW_TOKENS
              and len(r.token_times) == NEW_TOKENS,
              f"{name}: request {i} {r.state} with {len(r.output)} "
              f"tokens and {len(r.token_times)} emissions")
    for i, (a, b) in enumerate(zip(reqs, ref)):
        j = _first_divergence(a.output, b.output)
        if j is not None:
            gap = _top2_gap(torch, params, list(prompts[i])
                            + list(b.output[:j]))
            raise SmokeFailure(
                f"request {i}: {name} and {what} streams diverge at "
                f"generated position {j} (top-2 logit gap there "
                f"{gap:.3e})")


def _fleet_cfg():
    from horovod_tpu_torch.serve import ServeConfig

    return ServeConfig(page_size=PAGE, num_pages=NUM_PAGES,
                       decode_slots=SLOTS, prefill_chunk=CHUNK,
                       attention="paged")


def _clone(torch, tree):
    if isinstance(tree, dict):
        return {k: _clone(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(torch, v) for v in tree]
    return tree.clone()


def _inproc_fleet(torch, params, prompts, waves, single):
    """10.1 and 10.3: two in-process replicas, clean, then the same
    submissions with replica 1 killed mid-decode, then a rolling update
    to version 2 (a copy of the same weights) mid-run and a second roll
    to version 3."""
    from horovod_tpu_torch.ops.paged_attention import \
        paged_attention_decode as k4
    from horovod_tpu_torch.serve import FleetConfig, ServeFleet

    out = {}
    mib0 = _reserved_mib(torch)
    fl = ServeFleet(params, _fleet_cfg(), FleetConfig(
        replicas=FLEET_REPLICAS, backoff_base=0.01, max_restarts=2),
        device="cuda")
    try:
        check(all(rep.engine.params["embed"].data_ptr()
                  == params["embed"].data_ptr() for rep in fl.replicas),
              "fleet: in-process replicas copied the weights")
        watch = _FleetWatch(torch, fl)
        log(f"fleet[inproc]: reserved {mib0:.1f} MiB before, "
            f"{_reserved_mib(torch):.1f} MiB with {FLEET_REPLICAS} "
            "engines built")
        k4.launches = 0
        _fleet_warm(fl, prompts, watch)
        reqs, wall = _fleet_serve(torch, fl, waves, watch)
        out["clean"] = _fleet_stats(fl, wall)
        _fleet_check(torch, params, prompts, "fleet[inproc]", reqs,
                     single["reqs"], "the single engine")
        out["clean_reqs"] = reqs
        _check_lm_decode(torch, params, prompts, reqs, "fleet[inproc]")
        check(sorted(rid for rid, *_ in watch.captures)
              == list(range(FLEET_REPLICAS)),
              f"fleet[inproc]: replicas captured {watch.captures}")
        check(all(watch.launches.get(r, 0) == 2 * FLEET_LAYERS
                  for r in range(FLEET_REPLICAS)),
              f"fleet[inproc]: K4 wrapper launches per replica "
              f"{watch.launches}, expected {2 * FLEET_LAYERS} each (warm-up + "
              "capture; replays launch none)")
        out["launches_per_replica"] = dict(watch.launches)
        log(f"fleet[inproc] clean: {out['clean']}")

        # One replayed tick under the profiler (after one it traces as
        # its warm-up): K4's kernels 12 for each replica with a live
        # decode slot.
        fl.reset_metrics()
        for p in prompts[:4]:
            fl.submit(p, NEW_TOKENS)
        for _ in range(400):
            if all(any(s is not None for s in r.engine.slots)
                   for r in fl.replicas):
                break
            fl.step()
        before = {}

        def warm_tick():
            fl.step()
            before.update((r.id, len(r.engine.attn_len_samples))
                          for r in fl.replicas)

        prof = _profile_run(torch, fl.step, ("paged_split", "paged_merge"),
                            warmup=warm_tick)
        live = sum(1 for r in fl.replicas
                   if len(r.engine.attn_len_samples) > before[r.id]
                   and any(r.engine.attn_len_samples[-1]))
        check(live >= 1
              and prof["counts"]["paged_split"] == FLEET_LAYERS * live
              and prof["counts"]["paged_merge"] == FLEET_LAYERS * live,
              f"fleet[inproc]: one replayed tick traced {prof['counts']}, "
              f"expected {FLEET_LAYERS} x {live} live replicas")
        out["tick_trace"] = {"live_replicas": live, **prof}
        _fleet_drain(fl)

        # The same submissions with replica 1 killed mid-decode.
        fl.reset_metrics()
        reqs_f, wall = _fleet_serve(torch, fl, waves, watch, kill_at=1)
        out["faulted"] = _fleet_stats(fl, wall)
        _fleet_check(torch, params, prompts, "fleet[inproc] faulted",
                     reqs_f, reqs, "clean fleet")
        f = out["faulted"]
        check(f["incidents_by_class"] == {"crashed": 1}
              and f["redispatched"] >= 1 and f["restarts_used"] == 1,
              f"fleet[inproc] faulted: {f}")
        log(f"fleet[inproc] faulted: {f}")

        # Rolling updates: version 2 mid-run (a copy of the same weights,
        # so the streams stay the clean run's), then version 3. Reserved
        # memory is read after empty_cache: a graph or its pool that
        # outlived its roll would stay reserved.
        # Both copies are made first, so the weights' allocations do not
        # differ between the two readings.
        fl.reset_metrics()
        rolled = []
        copies = [_clone(torch, params) for _ in range(2)]
        for version, new in ((2, copies[0]), (3, copies[1])):
            caps0 = {r.id: r.engine.lane_graphs[False].captures
                     for r in fl.replicas}
            reqs_u, t0 = [], time.perf_counter()
            for n, (wave, steps) in enumerate(waves):
                reqs_u += [fl.submit(p, NEW_TOKENS) for p in wave]
                for _ in range(steps):
                    watch.wrap()
                    fl.step()
                if n == 0:
                    check(fl.update_params(new) == version,
                          f"fleet: update_params did not give v{version}")
            _fleet_drain(fl, watch)
            _fleet_check(torch, params, prompts,
                         f"fleet[inproc] roll v{version}", reqs_u, reqs,
                         "clean fleet")
            # one short request per replica: each decodes on the new
            # weights at least once
            _fleet_warm(fl, prompts, watch)
            fs = fl.stats()["fleet"]
            caps = {r.id: r.engine.lane_graphs[False].captures
                    for r in fl.replicas}
            check(fs["params_version"] == version
                  and all(r["version"] == version
                          for r in fs["per_replica"])
                  and all(r.engine.params["embed"].data_ptr()
                          == new["embed"].data_ptr() for r in fl.replicas)
                  and all(caps[r] == caps0[r] + 1 for r in caps),
                  f"fleet: roll to v{version}: {fs['per_replica']}, "
                  f"captures {caps} from {caps0}")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            rolled.append({
                "version": version,
                "request_versions": sorted({r.version for r in reqs_u}),
                "wall_s": time.perf_counter() - t0,
                "reserved_mib": _reserved_mib(torch)})
            log(f"fleet[inproc]: rolled to v{version} mid-run "
                f"{rolled[-1]}")
        pool = max(after - before for _, c, before, after in watch.captures
                   if c == 1)
        growth = rolled[1]["reserved_mib"] - rolled[0]["reserved_mib"]
        check(pool > 0 and abs(growth) <= pool,
              f"fleet: reserved memory moved {growth:.1f} MiB from the "
              f"first roll to the second, more than one lane graph's pool "
              f"({pool:.1f} MiB)")
        del copies, new
        out.update(rolls=rolled, graph_pool_mib=pool,
                   roll_growth_mib=growth, captures=watch.captures,
                   fleet_launches=k4.launches)
    finally:
        fl.close()
    return out


def _fleet_warm(fl, prompts, watch=None):
    """One short request per replica (the router spreads them), so every
    replica has captured its lane before the measured run; then the
    metrics reset. Returns the params pushes made until then."""
    for _ in fl.replicas:
        fl.submit(prompts[0][:16], 4)
    _fleet_drain(fl, watch)
    push = dict(fl.push_stats)
    fl.reset_metrics()
    return push


def _fleet_drain(fl, watch=None):
    t0 = time.perf_counter()
    while not fl.idle or fl.update_active:
        check(time.perf_counter() - t0 < FLEET_TIMEOUT_S,
              "fleet: not drained")
        if watch is not None:
            watch.wrap()
        if not fl.step():
            time.sleep(0.0005)


def _compute_apps():
    """``nvidia-smi --query-compute-apps``: the pids holding a context on
    the card, with their memory."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return [line.strip() for line in smi.stdout.splitlines()
            if line.strip()]


def _others_mib(torch):
    """Memory in use on the card outside this process's allocator: the
    contexts of every process on the card (this one's included) and what
    other processes hold. ``cudaMemGetInfo`` sees the whole card, where
    a container's ``nvidia-smi`` may not tell its processes apart."""
    free, total = torch.cuda.mem_get_info()
    return (total - free - torch.cuda.memory_reserved()) / 2**20


def _check_worker_decode(fl, name, lane_replays=None):
    """Each worker's own count of K4 wrapper calls: its decode lane's
    warm-up step and capture, 2 x FLEET_LAYERS, and replays after that, which
    launch none through the wrapper. Returns the workers' replies."""
    pongs = [rep.engine.client.call("ping") for rep in fl.replicas]
    for rep, p in zip(fl.replicas, pongs):
        check(p["decode_launches"] == 2 * FLEET_LAYERS
              and p["lane_captures"] == 1 and p["lane_replays"] > 0
              and p["lane_replays"] > (lane_replays or {}).get(p["pid"], 0)
              and p["pid"] == rep.proc.pid,
              f"{name}: worker {rep.id} reports {p}, expected "
              f"{2 * FLEET_LAYERS} K4 wrapper calls, one capture and new "
              "replays")
    return pongs


def _process_fleet(torch, params, prompts, waves, clean_reqs):
    """10.2: two worker processes sharing the card (``--device cuda``),
    the weights pushed over the wire; a clean run, then the same
    submissions with replica 1 SIGKILLed mid-decode."""
    from horovod_tpu_torch.serve import FleetConfig, ServeFleet

    out = {}
    torch.cuda.synchronize()
    others0 = _others_mib(torch)
    t0 = time.perf_counter()
    fl = ServeFleet(params, _fleet_cfg(), FleetConfig(
        replicas=FLEET_REPLICAS, transport="process", backoff_base=0.01,
        max_restarts=2, spawn_timeout=FLEET_SPAWN_S,
        rpc_deadline=FLEET_RPC_S), device="cuda")
    procs = []
    try:
        procs = [rep.proc for rep in fl.replicas]
        out["initial_push"] = _fleet_warm(fl, prompts)
        out["warm_s"] = time.perf_counter() - t0
        log(f"fleet[process]: construction to warm {out['warm_s']:.1f} s, "
            f"params pushed {out['initial_push']}")
        sha = fl._artifact["sha256"]
        check(all(rep.params_sha == sha and rep.version == 1
                  for rep in fl.replicas),
              f"fleet[process]: pushed digests "
              f"{[rep.params_sha for rep in fl.replicas]} != {sha}")
        pongs = [rep.engine.client.call("ping") for rep in fl.replicas]
        check(all(p["params_sha256"] == sha for p in pongs),
              f"fleet[process]: workers report {pongs}")
        # Each worker holds its own context and its copy of the weights
        # on the card beside this process's: the card's memory outside
        # this process's allocator grows by at least the weights of each.
        # A container's nvidia-smi may list the contexts under other pids
        # than the workers' own, so its count is checked and the pids are
        # only logged.
        weights_mib = len(fl._artifact["blob"]) / 2**20
        others1 = _others_mib(torch)
        apps = _compute_apps()
        pids = [str(rep.proc.pid) for rep in fl.replicas]
        log(f"fleet[process]: worker pids {pids}; nvidia-smi compute apps "
            f"{apps}; card memory outside this allocator {others0:.1f} -> "
            f"{others1:.1f} MiB")
        check(len(apps) >= 1 + FLEET_REPLICAS,
              f"fleet[process]: nvidia-smi lists {len(apps)} compute "
              f"apps, fewer than this process and {FLEET_REPLICAS} "
              "workers")
        check(others1 - others0 >= FLEET_REPLICAS * weights_mib,
              f"fleet[process]: the card's memory outside this process "
              f"grew {others1 - others0:.1f} MiB with {FLEET_REPLICAS} "
              f"workers up, less than their weights ({weights_mib:.1f} "
              "MiB each)")
        out.update(worker_pids=pids, compute_apps=apps, artifact_sha256=sha,
                   artifact_bytes=len(fl._artifact["blob"]),
                   card_mib_outside={"before": others0, "up": others1})
        reqs, wall = _fleet_serve(torch, fl, waves)
        out["clean"] = _fleet_stats(fl, wall)
        _fleet_check(torch, params, prompts, "fleet[process]", reqs,
                     clean_reqs, "in-process fleet")
        pongs = _check_worker_decode(fl, "fleet[process] clean")
        decode = {p["pid"]: p for p in pongs}
        log(f"fleet[process] clean: {out['clean']}")
        fl.reset_metrics()
        victim = fl.replicas[1].proc
        reqs_f, wall = _fleet_serve(torch, fl, waves, kill_at=1)
        out["faulted"] = _fleet_stats(fl, wall)
        f = out["faulted"]
        _fleet_check(torch, params, prompts, "fleet[process] faulted",
                     reqs_f, clean_reqs, "in-process fleet")
        check(victim.poll() == -signal.SIGKILL
              and f["incidents_by_class"] == {"crashed": 1}
              and f["redispatched"] >= 1 and f["restarts_used"] == 1
              and fl.stats()["fleet"]["failed"] == 0,
              f"fleet[process] faulted: exit {victim.poll()}, {f}")
        procs = [p for p in procs] + [rep.proc for rep in fl.replicas]
        log(f"fleet[process] faulted: {f}")
        pongs = _check_worker_decode(
            fl, "fleet[process] faulted",
            {pid: p["lane_replays"] for pid, p in decode.items()})
        decode.update((p["pid"], p) for p in pongs)
        check(len(decode) == FLEET_REPLICAS + 1,
              f"fleet[process]: decode evidence from {sorted(decode)}, "
              "expected both first incarnations and the relaunched one")
        out["worker_decode"] = [
            {k: p[k] for k in ("pid", "decode_launches", "lane_captures",
                               "lane_replays")} for p in decode.values()]
        log(f"fleet[process]: K4 wrapper calls per worker incarnation "
            f"{out['worker_decode']}")
        out["first_steps"] = list(fl.first_steps)
        log(f"fleet[process]: spawn to first step {fl.first_steps}")
        check(sorted((s["replica"], s["incarnation"])
                     for s in fl.first_steps)
              == [(0, 1), (1, 1), (1, 2)],
              f"fleet[process]: incarnations {fl.first_steps}")
    finally:
        fl.close()
    for p in procs:
        check(p.poll() is not None,
              f"fleet[process]: worker {p.pid} not reaped after close()")
    out["reaped"] = sorted({p.pid for p in procs})
    out["card_mib_outside"]["closed"] = _card_freed(
        torch, others0, weights_mib, "fleet[process]")
    return out


def _card_freed(torch, others0, weights_mib, name):
    """The card's memory outside this process back within one worker's
    weights of ``others0`` after ``close()`` (a dead process's memory
    is freed asynchronously, so it polls); returns the last reading."""
    for _ in range(100):
        others2 = _others_mib(torch)
        if others2 - others0 < weights_mib:
            break
        time.sleep(0.1)
    check(others2 - others0 < weights_mib,
          f"{name}: {others2 - others0:.1f} MiB more of the card is in use "
          "outside this process after close() than before the spawn: a "
          "worker's weights are still there")
    return others2


def fleet_phase(torch, np, params, prompts, waves, single, card):
    """Phase 10: the fleet at the engine phase's geometry and width,
    ``FLEET_LAYERS`` deep; ``single`` is the single engine's run at that
    depth."""
    t0 = time.perf_counter()
    inproc = _inproc_fleet(torch, params, prompts, waves, single)
    torch.cuda.empty_cache()
    clean_reqs = inproc.pop("clean_reqs")
    proc = _process_fleet(torch, params, prompts, waves, clean_reqs)
    st = single["stats"]
    res = {
        "card": card, "replicas": FLEET_REPLICAS,
        "single_engine": {"tokens_per_sec_per_card":
                          st["tokens_per_sec_per_chip"],
                          "ttft_ms": st["ttft_ms"], "tbt_ms": st["tbt_ms"],
                          "wall_s": single["wall"]},
        "inproc": inproc, "process": proc,
        # each run's tokens/s of the card over the single engine's
        "per_card_over_single": {
            f"{where}_{run}": round(
                res[run]["tokens_per_sec_per_card"]
                / st["tokens_per_sec_per_chip"], 3)
            for where, res in (("inproc", inproc), ("process", proc))
            for run in ("clean", "faulted")},
        "phase_s": time.perf_counter() - t0}
    log(f"fleet: phase passed in {res['phase_s']:.1f} s")
    return res, clean_reqs


# ------------------------------------------------------------- phase 11

#: Disaggregated serving: one prefill replica and one decode replica on
#: the card, the engine phase's geometry, width and workload.
DISAGG_POOLS = {"prefill": 1, "decode": 1}
#: The KV transfer's chunk size (FleetConfig.push_chunk_bytes' default).
KV_CHUNK = 1 << 20


def _kv_blob_bytes(prompts):
    """The HVKV blob of each prompt's pages, from the geometry alone
    (header, then K and V tiles of every layer): ``(bytes, pages)``
    each."""
    out = []
    for p in prompts:
        n = -(-len(p) // PAGE)
        header = json.dumps({
            "layers": FLEET_LAYERS, "page_size": PAGE, "heads": HEADS,
            "head_dim": HEAD_DIM, "dtype": "float32", "pages": n,
            "positions": len(p)}).encode("utf-8")
        out.append((8 + len(header)
                    + FLEET_LAYERS * 2 * n * PAGE * HEADS * HEAD_DIM * 4, n))
    return out


def _disagg_cfg(**kw):
    from horovod_tpu_torch.serve import FleetConfig

    return FleetConfig(replicas=2, backoff_base=0.01, max_restarts=2,
                       pools=DISAGG_POOLS, **kw)


def _disagg_stats(fl, wall):
    out = _fleet_stats(fl, wall)
    d = fl.stats()["fleet"]["disagg"]
    out.update(disagg=d)
    return out


def _spy_admissions(fl, admitted):
    """Record which replica's scheduler each dispatch reaches."""
    for rep in fl.replicas:
        if rep.engine is None:
            continue        # dead, waiting for its relaunch
        sched = rep.engine.scheduler
        if getattr(sched, "_spied", False):
            continue
        submit = sched.submit

        def spied(req, submit=submit, rid=rep.id):
            admitted.setdefault(req.rid, []).append(rid)
            return submit(req)

        sched.submit = spied
        sched._spied = True


def _spy_exports(fl, exports):
    """Record the sha256 of every blob the prefill replica exports."""
    import hashlib

    eng = fl.replicas[0].engine
    if eng is None or getattr(eng, "_spied", False):
        return
    export = eng.export_handoff

    def spied(rid):
        blob = export(rid)
        exports.setdefault(rid, []).append(hashlib.sha256(blob).hexdigest())
        return blob

    eng.export_handoff = spied
    eng._spied = True


def _disagg_serve(torch, fl, waves, watch, admitted, exports=None):
    """The waves through a pools fleet, every admission and (with
    ``exports``) every export recorded; the spies are put on each
    engine a relaunch makes too."""
    orig = watch.wrap

    def wrap():
        orig()
        _spy_admissions(fl, admitted)
        if exports is not None:
            _spy_exports(fl, exports)

    watch.wrap = wrap
    try:
        return _fleet_serve(torch, fl, waves, watch)
    finally:
        watch.wrap = orig


def _transfer_parts(torch, cache, npos):
    """Where an in-process transfer's time goes, for a blob of ``npos``
    positions in ``cache`` (pages borrowed from its free list and given
    back): export (gather on the card, one copy to the host a layer and
    K/V), the chunk codec (manifest sha256, base64 + crc32 a chunk each
    way, the commit's sha256), and import (host-to-device copies into
    the page tensors). Milliseconds, synchronised, each once."""
    from horovod_tpu_torch.serve.kv_wire import KvReceiver, KvSender

    pages = cache.allocator.alloc(cache.pages_needed(npos, 1))
    grant = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = cache.export_pages(pages, npos)
        t1 = time.perf_counter()
        sender = KvSender(blob, 0, KV_CHUNK)
        recv = KvReceiver(0)
        recv.begin(sender.manifest)
        for i in range(sender.num_chunks):
            recv.write_chunk(sender.chunk(i))
        check(recv.commit() == blob, "disagg: the codec changed the blob")
        t2 = time.perf_counter()
        grant, _ = cache.import_pages(blob)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        cache.allocator.release(pages + list(grant))
    return {"bytes": len(blob), "export_ms": (t1 - t0) * 1e3,
            "codec_ms": (t2 - t1) * 1e3, "import_ms": (t3 - t2) * 1e3}


def _inproc_disagg(torch, params, prompts, waves, ref_reqs, blobs):
    """11.1 and 11.2: the in-process pools fleet, clean, then with a
    decode-side and a prefill-side tear of one transfer each."""
    from horovod_tpu_torch.ops.paged_attention import \
        paged_attention_decode as k4
    from horovod_tpu_torch.serve import ServeFleet

    out = {}
    t0 = time.perf_counter()
    k4.launches = 0
    fl = ServeFleet(params, _fleet_cfg(), _disagg_cfg(), device="cuda")
    try:
        check([r.role for r in fl.replicas] == ["prefill", "decode"],
              f"disagg: roles {[r.role for r in fl.replicas]}")
        watch = _FleetWatch(torch, fl)
        _fleet_warm(fl, prompts, watch)
        admitted = {}
        reqs, wall = _disagg_serve(torch, fl, waves, watch, admitted)
        st = _disagg_stats(fl, wall)
        d = st["disagg"]
        _fleet_check(torch, params, prompts, "disagg[inproc]", reqs,
                     ref_reqs, "the colocated fleet")
        _check_lm_decode(torch, params, prompts, reqs, "disagg[inproc]")
        check(all(admitted.get(r.rid) == [0] and r.replica == 1
                  and r.redispatches == 0 for r in reqs),
              f"disagg[inproc]: admissions {admitted}, finished on "
              f"{[r.replica for r in reqs]}")
        check(d["transfers"] == len(prompts) and d["failures"] == {}
              and d["parked"] == 0,
              f"disagg[inproc]: {d}")
        want = sum(b for b, _ in blobs)
        pages = sum(n for _, n in blobs)
        tile = FLEET_LAYERS * 2 * PAGE * HEADS * HEAD_DIM * 4
        chunks = sum(-(-b // KV_CHUNK) for b, _ in blobs)
        check(d["kv_bytes_shipped"] == want
              and d["chunks_shipped"] == chunks,
              f"disagg[inproc]: shipped {d['kv_bytes_shipped']} bytes in "
              f"{d['chunks_shipped']} chunks, the geometry gives {want} "
              f"({pages} pages x {tile} bytes of tiles + headers) in "
              f"{chunks} chunks of {KV_CHUNK}")
        pe, de = fl.replicas[0].engine, fl.replicas[1].engine
        dg = (de.lane_graphs or {}).get(False)
        check(watch.launches.get(1, 0) == 2 * FLEET_LAYERS and dg is not None
              and dg.captures == 1 and dg.replays > 0,
              f"disagg[inproc]: decode replica K4 wrapper calls "
              f"{watch.launches.get(1, 0)}, graph {dg and dg.captures} "
              f"captures {dg and dg.replays} replays; expected "
              f"{2 * FLEET_LAYERS} (warm-up + capture), 1 capture and replays")
        check(not pe.lane_graphs and pe.attn_len_samples
              and not any(any(s) for s in pe.attn_len_samples),
              f"disagg[inproc]: the prefill replica decoded "
              f"({pe.lane_graphs})")
        out.update(clean=st, launches_per_replica=dict(watch.launches),
                   kv_pages=pages, kv_tile_bytes=pages * tile)
        log(f"disagg[inproc] clean: {st}; K4 wrapper calls per replica "
            f"{watch.launches} (prefill replica {watch.launches.get(0, 0)}"
            f"); {pages} pages, {pages * tile} bytes of tiles")

        # One replayed decode-pool tick under the profiler (after one it
        # traces as its warm-up): 12 of each K4 kernel for the decode
        # replica's live step, none elsewhere.
        for p in prompts[:4]:
            fl.submit(p, NEW_TOKENS)
        for _ in range(400):
            if any(s is not None for s in de.slots) and \
                    not pe.handoff and pe.prefilling is None \
                    and not pe.scheduler.queue:
                break
            fl.step()
        n0 = []

        def warm_tick():
            fl.step()
            n0.append(len(de.attn_len_samples))

        prof = _profile_run(torch, fl.step, ("paged_split", "paged_merge"),
                            warmup=warm_tick)
        live = int(len(de.attn_len_samples) > n0[0]
                   and any(de.attn_len_samples[-1]))
        check(live == 1 and prof["counts"]["paged_split"] == FLEET_LAYERS
              and prof["counts"]["paged_merge"] == FLEET_LAYERS,
              f"disagg[inproc]: one replayed decode-pool tick traced "
              f"{prof['counts']} with {live} live decode step, expected "
              f"{FLEET_LAYERS} of each")
        out["tick_trace"] = prof
        _fleet_drain(fl, watch)
        out["launches"] = k4.launches
        out["transfer_parts"] = _transfer_parts(
            torch, de.cache, max(len(p) for p in prompts))
        log(f"disagg[inproc]: one transfer's parts, the largest blob "
            f"{out['transfer_parts']}")
        log(f"disagg[inproc]: a replayed decode-pool tick traced "
            f"{prof['counts']}, idle share {prof['idle_share']:.3f}")

        # 11.2: one transfer torn on each side.
        for side in ("decode", "prefill"):
            fl.reset_metrics()
            fl.disagg.fault_next_transfer = side
            admitted, exports = {}, {}
            torn, wall = _disagg_serve(torch, fl, waves, watch, admitted,
                                       exports)
            st = _disagg_stats(fl, wall)
            f, d = fl.stats()["fleet"], st["disagg"]
            _fleet_check(torch, params, prompts, f"disagg[{side} tear]",
                         torn, ref_reqs, "the colocated fleet")
            check(d["failures"] == {side: 1}
                  and fl.disagg.fault_next_transfer is None
                  and f["incidents_by_class"] == {"crashed": 1}
                  and [r.role for r in fl.replicas]
                  == ["prefill", "decode"],
                  f"disagg[{side} tear]: {d}, {f['incidents_by_class']}")
            if side == "decode":
                again = {rid: h for rid, h in exports.items()
                         if len(h) > 1}
                check(f["redispatched"] == 0 and d["transfers"]
                      == len(prompts) and len(again) == 1
                      and all(len(set(h)) == 1 for h in again.values())
                      and all(r.redispatches == 0 for r in torn),
                      f"disagg[decode tear]: redispatched "
                      f"{f['redispatched']}, transfers {d['transfers']}, "
                      f"exports {exports}")
            else:
                check(1 <= f["redispatched"] and f["tokens_recomputed"] > 0
                      and all(r.redispatches <= 1 for r in torn),
                      f"disagg[prefill tear]: {f}")
            out[f"{side}_tear"] = dict(
                st, redispatched=f["redispatched"],
                tokens_recomputed=f["tokens_recomputed"],
                exports_repeated=sum(len(h) - 1 for h in exports.values()))
            log(f"disagg[{side} tear]: {out[f'{side}_tear']}")
    finally:
        fl.close()
    out["phase_s"] = time.perf_counter() - t0
    return out


def _process_disagg(torch, params, prompts, waves, ref_reqs, shipped):
    """11.3: a prefill worker and a decode worker sharing the card."""
    from horovod_tpu_torch.serve import ServeFleet

    out = {}
    torch.cuda.synchronize()
    others0 = _others_mib(torch)
    t0 = time.perf_counter()
    fl = ServeFleet(params, _fleet_cfg(), _disagg_cfg(
        transport="process", spawn_timeout=FLEET_SPAWN_S,
        rpc_deadline=FLEET_RPC_S), device="cuda")
    procs = [rep.proc for rep in fl.replicas]
    try:
        _fleet_warm(fl, prompts)
        out["warm_s"] = time.perf_counter() - t0
        others1 = _others_mib(torch)
        weights_mib = len(fl._artifact["blob"]) / 2**20
        check(others1 - others0 >= 2 * weights_mib,
              f"disagg[process]: the card's memory outside this process "
              f"grew {others1 - others0:.1f} MiB with both workers up, "
              f"less than their weights ({weights_mib:.1f} MiB each)")
        reqs, wall = _fleet_serve(torch, fl, waves)
        st = _disagg_stats(fl, wall)
        d = st["disagg"]
        _fleet_check(torch, params, prompts, "disagg[process]", reqs,
                     ref_reqs, "the colocated fleet")
        check(all(r.replica == 1 and r.redispatches == 0 for r in reqs)
              and d["transfers"] == len(prompts) and d["failures"] == {}
              and d["parked"] == 0 and d["kv_bytes_shipped"] == shipped,
              f"disagg[process]: {d}, finished on "
              f"{[r.replica for r in reqs]}; in process shipped {shipped}")
        pongs = [rep.engine.client.call("ping") for rep in fl.replicas]
        pp, dp = pongs
        check(dp["decode_launches"] == 2 * FLEET_LAYERS
              and dp["lane_captures"] == 1 and dp["lane_replays"] > 0,
              f"disagg[process]: the decode worker reports {dp}, expected "
              f"{2 * FLEET_LAYERS} K4 wrapper calls, one capture and replays")
        check(pp["lane_replays"] is None and pp["lane_captures"] is None,
              f"disagg[process]: the prefill worker decoded: {pp}")
        out.update(clean=st, card_mib_outside={"before": others0,
                                               "up": others1},
                   worker_decode=[{k: p[k] for k in (
                       "pid", "decode_launches", "lane_captures",
                       "lane_replays")} for p in pongs])
        log(f"disagg[process] clean: {st}; workers {out['worker_decode']}")
    finally:
        fl.close()
    for p in procs:
        check(p.poll() is not None,
              f"disagg[process]: worker {p.pid} not reaped after close()")
    out["card_mib_outside"]["closed"] = _card_freed(
        torch, others0, weights_mib, "disagg[process]")
    out["phase_s"] = time.perf_counter() - t0
    return out


def _colocated_inproc(torch, params, prompts, waves):
    """The colocated in-process fleet's clean run (phase 10's first),
    for ``--disagg-only``."""
    from horovod_tpu_torch.serve import FleetConfig, ServeFleet

    fl = ServeFleet(params, _fleet_cfg(), FleetConfig(
        replicas=FLEET_REPLICAS, backoff_base=0.01, max_restarts=2),
        device="cuda")
    try:
        _fleet_warm(fl, prompts)
        reqs, wall = _fleet_serve(torch, fl, waves)
        return _fleet_stats(fl, wall), reqs
    finally:
        fl.close()


def _latency(st):
    return {"tokens_per_sec_per_card": st["tokens_per_sec_per_card"],
            "ttft_ms": st["ttft_ms"], "tbt_ms": st["tbt_ms"],
            "wall_s": st["wall_s"]}


def disagg_phase(torch, np, params, prompts, waves, single, card,
                 colocated=None):
    """Phase 11: disaggregated prefill/decode pools at the engine phase's
    geometry and width, ``FLEET_LAYERS`` deep. ``colocated`` holds phase
    10's clean runs (the in-process one's streams and numbers, the
    workers' numbers); without it the colocated in-process fleet runs
    here first."""
    t0 = time.perf_counter()
    if colocated is None:
        st, reqs = _colocated_inproc(torch, params, prompts, waves)
        _fleet_check(torch, params, prompts, "colocated fleet", reqs,
                     single["reqs"], "the single engine")
        colocated = {"reqs": reqs, "inproc": st, "process": None}
    blobs = _kv_blob_bytes(prompts)
    inproc = _inproc_disagg(torch, params, prompts, waves,
                            colocated["reqs"], blobs)
    torch.cuda.empty_cache()
    proc = _process_disagg(torch, params, prompts, waves, colocated["reqs"],
                           inproc["clean"]["disagg"]["kv_bytes_shipped"])
    res = {"card": card, "pools": DISAGG_POOLS}
    for name, dis, colo in (("inproc", inproc, colocated["inproc"]),
                            ("process", proc, colocated["process"])):
        d = dis["clean"]["disagg"]
        res[name] = {
            "disagg": _latency(dis["clean"]),
            "colocated": _latency(colo) if colo else "not measured",
            **{k: d[k] for k in ("transfers", "transfer_ms_p50",
                                 "transfer_ms_p99", "kv_bytes_shipped",
                                 "chunks_shipped")},
            "phase_s": dis["phase_s"]}
    res["inproc"].update(
        tears={side: {k: inproc[f"{side}_tear"][k] for k in (
            "tokens_per_sec_per_card", "ttft_ms", "tbt_ms", "redispatched",
            "tokens_recomputed", "exports_repeated")}
            for side in ("decode", "prefill")},
        kv_pages=inproc["kv_pages"], kv_tile_bytes=inproc["kv_tile_bytes"],
        tick_trace=inproc["tick_trace"],
        transfer_parts=inproc["transfer_parts"])
    res["process"].update(worker_decode=proc["worker_decode"],
                          card_mib_outside=proc["card_mib_outside"],
                          warm_s=proc["warm_s"])
    res["single_engine"] = {
        "tokens_per_sec_per_card":
            single["stats"]["tokens_per_sec_per_chip"],
        "ttft_ms": single["stats"]["ttft_ms"],
        "tbt_ms": single["stats"]["tbt_ms"]}
    res["launches"] = {
        "inproc": inproc["launches"],
        "inproc_per_replica": inproc["launches_per_replica"],
        "tick_replay": inproc["tick_trace"]["counts"]["paged_split"],
        "worker": [p["decode_launches"] for p in proc["worker_decode"]]}
    res["phase_s"] = time.perf_counter() - t0
    log(f"disagg: phase passed in {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ phase 12

HIER_RANKS = 8
# Sequences of FLASH_L tokens a rank: eight full-width replicas share one
# card's 80 GB here, so each takes one sequence (the training phase's 8
# a card would need 8x the activations).
HIER_SEQS = 1
# Timed steps after one warm-up step, per variant (2 until the tp phase
# came: one step pays for part of it; the loss after the first update
# already holds each codec to the flat exchange).
HIER_STEPS = 1
# The LM's depth here: 2 of the 12 layers at the full width (12 until the
# sp phase came, 4 until the ep phase came: each cut pays for part of the
# new phase). A step's time is gloo's host staging of the gradient
# buckets, 543 MB at 12 layers, 316 MB at 4 and 259 MB at 2 (the
# embedding and head are 196 MB of it), and the buckets still span
# several layers' leaves and the big singletons.
HIER_LAYERS = 2
# (name, HOROVOD_HIERARCHICAL, compression, inner size): the flat
# exchange, the ladder at 2 hosts of 4 (m 2), int8 on it (the all-gather
# exchange) and fp8 at 4 hosts of 2 (m 4, the two-stage all-to-all
# exchange).
HIER_VARIANTS = (("off", "off", "none", 0), ("on_none", "on", "none", 4),
                 ("on_int8", "on", "int8", 4), ("on_fp8", "on", "fp8", 2))
# Each step's loss (the rank mean) against the flat exchange's, same
# weights and tokens. none: the ladder adds the same float32 gradients
# in another order, which moves Adam's first updates by rounding only.
# int8/fp8: the inter-host leg rounds each shard to 255 levels of its
# absmax (fp8: 3 mantissa bits), so small gradients of a 64 MB bucket
# quantize to 0 and their Adam update waits for the residual to carry
# them: the loss after 1-3 updates at lr 1e-4 moves by well under 2%; a
# dropped shard or a doubled sum moves it by whole units.
HIER_LOSS_RTOL = {"none": 1e-4, "int8": 2e-2, "fp8": 2e-2}
HIER_TIMEOUT_S = 600.0
HIER_CAVEAT = ("8 ranks share one card over gloo: each collective stages "
               "its CUDA tensors through host memory and loopback TCP, so "
               "step_ms measures host copies and the host's sockets, not "
               "NVLink or InfiniBand")


def _hier_bases(np):
    """Integer-valued tensors (every summation order exact) in a
    multi-bucket plan at a 400-byte threshold."""
    rng = np.random.RandomState(0)
    return [np.asarray(rng.randint(-8, 8, size=s), np.float32)
            for s in ((33,), (7, 5), (101,), (4, 4, 4), (257,))]


def _hier_probe(torch, dist, dev, world):
    """Each collective of the ladder on ``dev`` tensors, over the world
    and over the inner and outer groups of inner 4 and 2: "ok" or the
    error's text, by name."""
    from horovod_tpu_torch.parallel import mesh as pmesh

    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ok"
        except Exception as e:             # noqa: BLE001 - reported
            out[name] = f"{type(e).__name__}: {e}"[:300]

    groups = [("world", None)]
    for inner in (4, 2):
        try:
            ig, og = pmesh.ladder_groups(world, inner)
            groups += [(f"inner{inner}", ig), (f"outer{inner}", og)]
        except Exception as e:             # noqa: BLE001 - reported
            out[f"groups{inner}"] = f"{type(e).__name__}: {e}"[:300]
    for gname, g in groups:
        n = dist.get_world_size(g)
        r = dist.get_rank(g)

        def rs():
            x = torch.arange(4 * n, dtype=torch.float32, device=dev)
            y = torch.empty(4, device=dev)
            dist.reduce_scatter_tensor(y, x, group=g, async_op=True).wait()
            want = torch.arange(4 * r, 4 * r + 4, dtype=torch.float32,
                                device=dev) * n
            assert torch.equal(y, want), (y, want)

        def ag():
            x = torch.full((3,), r, dtype=torch.uint8, device=dev)
            y = torch.empty(3 * n, dtype=torch.uint8, device=dev)
            dist.all_gather_into_tensor(y, x, group=g, async_op=True).wait()
            assert torch.equal(y.view(n, 3)[:, 0].cpu(),
                               torch.arange(n, dtype=torch.uint8))

        def a2a():
            x = torch.arange(n, dtype=torch.uint8, device=dev) + 10 * r
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x, group=g, async_op=True).wait()
            want = torch.arange(n, dtype=torch.uint8) * 10 + r
            assert torch.equal(y.cpu(), want), (y, want)

        def ar():
            x = torch.ones(5, device=dev)
            dist.all_reduce(x, group=g, async_op=True).wait()
            assert float(x[0]) == n

        for name, fn in (("reduce_scatter_tensor", rs),
                         ("all_gather_into_tensor", ag),
                         ("all_to_all_single", a2a), ("all_reduce", ar)):
            attempt(f"{gname}/{name}", fn)
    return out


def _hier_exact(torch, np, dev, world):
    """Integer-valued buckets through ``fused_reduce`` on ``dev``: the
    ladder at inner 4 and 2 against the flat exchange, average on and
    off, overlap off and on; the largest difference (must be 0)."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics

    cfg = basics.config()
    rank = hvd.rank()
    ts = [torch.tensor(b, device=dev) * (rank + 1) for b in _hier_bases(np)]
    out = {}
    for average in (False, True):
        flat = hvd.fused_reduce(ts, average=average, fusion_threshold=400,
                                hierarchical="off")
        for inner in (4, 2):
            cfg.hierarchical_inner_size = inner
            for overlap in ("off", "on"):
                got = hvd.fused_reduce(ts, average=average,
                                       fusion_threshold=400,
                                       overlap=overlap, hierarchical="on")
                out[f"inner{inner}_avg{int(average)}_{overlap}"] = max(
                    float((g - f).abs().max()) for g, f in zip(got, flat))
    cfg.hierarchical_inner_size = 0
    return out


def _hier_lm(torch, np, dev, world, variant):
    """One variant's LM steps on this rank: a warm-up step, then
    HIER_STEPS timed ones; the losses, step times, K1-K3 launches, the
    residuals' shapes against ``ef_residual_specs``, the wire summary and
    the largest difference of this rank's parameters from rank 0's."""
    import functools
    import gc

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models.train import (create_train_state,
                                                make_train_step)
    from horovod_tpu_torch.ops import attention as fa

    name, mode, codec, inner = variant
    cfg = basics.config()
    cfg.hierarchical_inner_size = inner
    comp = getattr(hvd.Compression, codec)
    flash = functools.partial(fa.flash_attention, causal=True,
                              bwd_impl="kernel")
    model = _lm(torch, flash, layers=HIER_LAYERS)
    opt = create_train_state(
        model, torch.optim.Adam(model.parameters(), lr=1e-4),
        compression=comp, hierarchical=mode, device=dev)
    step = make_train_step(model, opt)
    rank = hvd.rank()
    tokens = torch.tensor(np.random.default_rng(7).integers(
        0, VOCAB, (world * HIER_SEQS, FLASH_L))[
            rank * HIER_SEQS:(rank + 1) * HIER_SEQS], device=dev)
    losses = [float(step(tokens))]
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = 0
    times = []
    for _ in range(HIER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in kernels}
    trainable = [p for p in model.parameters() if p.requires_grad]
    threshold = cfg.fusion_threshold
    got_inner = opt.hierarchical_inner
    wire = (hvd.hier_wire_summary(hvd.plan_buckets(trainable, threshold),
                                  world, got_inner, comp)
            if got_inner else None)
    res = opt.residuals
    specs = (hvd.ef_residual_specs(trainable, threshold, world, got_inner)
             if res is not None else [])
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    out = {
        "inner": got_inner, "m": world // got_inner if got_inner else None,
        "losses": losses, "step_ms": times, "launches": launches,
        "wire": wire, "max_param_diff": float((flat - ref).abs().max()),
        "residuals": None if res is None else {
            "n": len(res),
            "shapes_match": [tuple(r.shape) for r in res]
            == [tuple(s.shape) for s in specs],
            "nonzero": sum(int(r.count_nonzero()) for r in res),
            "elems": sum(r.numel() for r in res),
            "abs_max": max(float(r.abs().max()) for r in res)},
    }
    del model, opt, step, flat, ref, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hier_rank(argv):
    """``--hier-rank RANK WORLD PORT DEVICE``: one rank of the hier
    phase's world; prints ``HIER_RESULT {json}`` last. ``DEVICE`` cuda:
    the probe, the exact ladder and the LM variants on the card (its own
    card over NCCL when there are WORLD cards, else the first card over
    gloo); cpu: the exact ladder on CPU tensors over gloo."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port = (int(a) for a in argv[:3])
    on_card = argv[3] == "cuda"
    own = on_card and torch.cuda.device_count() >= world
    dev = torch.device("cuda", rank if own else 0) if on_card else \
        torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    backend = "nccl" if own else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from horovod_tpu_torch import distributed as hvd

    hvd.init(device=dev)
    out = {"rank": rank, "backend": backend, "device": str(dev)}
    try:
        if on_card:
            out["probe"] = _hier_probe(torch, dist, dev, world)
            out["ladder_on_card"] = all(v == "ok"
                                        for v in out["probe"].values())
        if not on_card or out["ladder_on_card"]:
            out["exact"] = _hier_exact(torch, np, dev, world)
        if on_card and out["ladder_on_card"]:
            out["lm"] = {v[0]: _hier_lm(torch, np, dev, world, v)
                         for v in HIER_VARIANTS}
    finally:
        hvd.shutdown()
        dist.destroy_process_group()
    print("HIER_RESULT " + json.dumps(out), flush=True)


def _hier_world(device):
    """Start HIER_RANKS rank processes of this script on ``device``; wait
    for all, kill all on a failure or past HIER_TIMEOUT_S; return each
    rank's result."""
    import os
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--hier-rank",
         str(r), str(HIER_RANKS), str(port), device],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        # Eight ranks on the host's cores: one CPU thread each.
        env=dict(os.environ, OMP_NUM_THREADS="1"))
        for r in range(HIER_RANKS)]
    outs = []
    try:
        deadline = time.monotonic() + HIER_TIMEOUT_S
        for p in procs:
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (rc, stdout, stderr) in enumerate(outs):
        lines = [l for l in stdout.splitlines()
                 if l.startswith("HIER_RESULT ")]
        check(rc == 0 and lines,
              f"hier: rank {r} on {device} exited {rc}: "
              f"{stderr[-3000:]}")
        results.append(json.loads(lines[-1][len("HIER_RESULT "):]))
    return results


def _hier_codecs(torch, np):
    """Int8/fp8 ``quantize``/``dequantize`` on the card against the same
    calls on the CPU, bit for bit: a seeded shard of 2^20 values, an
    all-zero shard, values at the caps and past them, and the
    dequantized sum of a 4-row stack."""
    from horovod_tpu_torch.distributed.compression import Compression
    from horovod_tpu_torch.distributed.fusion import _dequant_sum

    rng = np.random.default_rng(3)
    cases = {
        "normal": rng.standard_normal(1 << 20).astype(np.float32) * 3,
        "zeros": np.zeros(4096, np.float32),
        "at_cap": np.array([127, -127, 448, -448, 0.5, -0.5], np.float32),
        "past_cap": np.array([1e4, -3e5, 449, 128, -1, 0, 2.5, -2.5],
                             np.float32),
    }
    out = {}
    for codec in ("int8", "fp8"):
        c = getattr(Compression, codec)
        for name, v in cases.items():
            qc, sc = c.quantize(torch.tensor(v, device="cuda"))
            qh, sh = c.quantize(torch.tensor(v))
            same = (torch.equal(c.wire_view(qc).cpu(), c.wire_view(qh))
                    and float(sc) == float(sh)
                    and torch.equal(c.dequantize(qc, sc).cpu(),
                                    c.dequantize(qh, sh)))
            check(same, f"hier: {codec} {name}: the card's quantize/"
                        "dequantize differ from the CPU's")
            out[f"{codec}/{name}"] = same
        rows = [c.quantize(torch.tensor(rng.standard_normal(4096).astype(
            np.float32))) for _ in range(4)]
        q = torch.stack([r[0] for r in rows])
        s = torch.stack([r[1] for r in rows])
        same = torch.equal(_dequant_sum(q.cuda(), s.cuda()).cpu(),
                           _dequant_sum(q, s))
        check(same, f"hier: {codec} dequantized sum differs on the card")
        out[f"{codec}/dequant_sum"] = same
    return out


def _hier_world_of_one(torch, np):
    """The LM under ``hierarchical="on"`` in an NCCL world of one (the
    ladder resolves flat) against ``"off"``: two steps, bit for bit."""
    import functools

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models.train import (create_train_state,
                                                make_train_step)
    from horovod_tpu_torch.ops import attention as fa

    hvd.init()
    flash = functools.partial(fa.flash_attention, causal=True,
                              bwd_impl="kernel")
    tokens = torch.tensor(np.random.default_rng(7).integers(
        0, VOCAB, (HIER_SEQS, FLASH_L)), device="cuda")
    params = {}
    for mode in ("off", "on"):
        model = _lm(torch, flash)
        step = make_train_step(model, create_train_state(
            model, torch.optim.Adam(model.parameters(), lr=1e-4),
            hierarchical=mode, compression=hvd.Compression.int8,
            device="cuda"))
        for _ in range(2):
            step(tokens)
        params[mode] = torch.cat([p.detach().reshape(-1)
                                  for p in model.parameters()])
        del model, step
    same = torch.equal(params["on"], params["off"])
    check(same, "hier: a world of one under hierarchical='on' differs "
                "from 'off'")
    hvd.shutdown()
    torch.cuda.empty_cache()
    return same


def hier_phase(torch, np, card):
    """Phase 12 (module docstring): the codecs on the card, then the
    8-rank world: the probe, the exact ladder and the LM variants."""
    t0 = time.perf_counter()
    res = {"card": card, "ranks": HIER_RANKS,
           "cards": min(torch.cuda.device_count(), HIER_RANKS),
           "codecs": _hier_codecs(torch, np)}
    log(f"hier: codecs bit for bit on the card: {res['codecs']}")
    ranks = _hier_world("cuda")
    r0 = ranks[0]
    res["backend"] = r0["backend"]
    res["probe"] = r0["probe"]
    res["ladder_on_card"] = all(r["ladder_on_card"] for r in ranks)
    log(f"hier: {HIER_RANKS} ranks over {r0['backend']} on "
        f"{res['cards']} card(s); probe {r0['probe']}")
    if not res["ladder_on_card"]:
        # No host staging to get round a refused collective: the ladder
        # is checked on CPU tensors instead, and says so.
        res["errors"] = {k: v for r in ranks for k, v in r["probe"].items()
                         if v != "ok"}
        res["world_of_one_on_equals_off"] = _hier_world_of_one(torch, np)
        ranks = _hier_world("cpu")
        res["exact_device"] = "cpu"
    else:
        res["exact_device"] = "cuda"
    worst = max(v for r in ranks for v in r["exact"].values())
    check(worst == 0.0, f"hier: the ladder differs from the flat exchange "
                        f"on integer data by {worst} "
                        f"({ranks[0]['exact']})")
    res["exact_max_diff"] = worst
    if res["ladder_on_card"]:
        res["variants"] = _hier_check_lm(ranks)
    res["caveat"] = HIER_CAVEAT
    res["phase_s"] = time.perf_counter() - t0
    log(f"hier: phase passed in {res['phase_s']:.1f} s")
    return res


def _hier_check_lm(ranks):
    """The LM variants' checks across the ranks; returns their summary."""
    off = ranks[0]["lm"]["off"]["losses"]
    out = {}
    for name, mode, codec, inner in HIER_VARIANTS:
        runs = [r["lm"][name] for r in ranks]
        r0 = runs[0]
        for r, run in enumerate(runs):
            check(run["losses"] == r0["losses"],
                  f"hier[{name}]: rank {r}'s losses {run['losses']} are "
                  f"not rank 0's {r0['losses']}")
            check(run["max_param_diff"] == 0.0,
                  f"hier[{name}]: rank {r}'s parameters differ from rank "
                  f"0's by up to {run['max_param_diff']}")
            check(run["inner"] == inner,
                  f"hier[{name}]: rank {r} resolved inner {run['inner']}, "
                  f"expected {inner}")
            for k, n in run["launches"].items():
                check(n == HIER_LAYERS * HIER_STEPS,
                      f"hier[{name}]: rank {r}: {k} launched {n} times, "
                      f"expected {HIER_LAYERS} layers x {HIER_STEPS} "
                      "steps")
            res = run["residuals"]
            if codec in ("int8", "fp8"):
                check(res is not None and res["n"] > 0
                      and res["shapes_match"] and res["nonzero"] > 0,
                      f"hier[{name}]: rank {r}'s residuals {res} are not "
                      "the non-zero ef_residual_specs shapes")
            else:
                check(res is None, f"hier[{name}]: residuals {res} "
                                   "without a low-bit codec")
        check(all(math.isfinite(x) for x in r0["losses"]),
              f"hier[{name}]: non-finite loss {r0['losses']}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], off)]
        check(max(rel) <= HIER_LOSS_RTOL[codec],
              f"hier[{name}]: losses {r0['losses']} against off's {off} "
              f"(rel {max(rel):.2e} > {HIER_LOSS_RTOL[codec]})")
        step_ms = sorted(t for run in runs for t in run["step_ms"])
        wire = r0["wire"] or {}
        out[name] = {
            "inner": inner, "m": r0["m"], "compression": codec,
            "step_ms": step_ms[len(step_ms) // 2],
            "step_ms_all": [run["step_ms"] for run in runs],
            "ici_mb": wire.get("ici_mb"), "dcn_mb": wire.get("dcn_mb"),
            "dtype": wire.get("dtype"), "ratio": wire.get("ratio"),
            "max_param_diff": max(run["max_param_diff"] for run in runs),
            "losses": r0["losses"], "loss_rel_vs_off": max(rel),
            "launches": r0["launches"],
            "residuals": r0["residuals"],
        }
        log(f"hier[{name}]: inner {inner}, m {r0['m']}, step ms "
            f"{out[name]['step_ms']:.1f}, losses {r0['losses']} (rel vs "
            f"off {max(rel):.2e}), wire {r0['wire']}, residuals "
            f"{r0['residuals']}")
    return out



# ------------------------------------------------------------ phase 13

TP_RANKS = 4
TP_TIMEOUT_S = 300.0
# The training check: one step of the tp LM at the engine's width on a
# batch of 2 x 256 tokens (numpy seed 9), against the dense step on the
# same weights. Both run float32 with no TF32; the row-parallel sums add
# the same products in another order, so the loss moves by float32
# rounding (a few 1e-7 relative) and each gradient leaf's largest error
# stays well under 1e-4 of its largest entry; a shard summed twice or a
# missing conjugate moves them by whole factors.
TP_BATCH, TP_SEQ = 2, 256
TP_LOSS_RTOL = 1e-5
TP_GRAD_RTOL = 1e-4
TP_CAVEAT = ("4 ranks share one card over gloo: each collective stages "
             "its CUDA tensors through host memory and loopback TCP, so "
             "the tokens/s is that of host copies and sockets, not of "
             "NVLink")
# The weight swap's numpy seed (the engine phase swaps to the same
# weights), and the HVKV tiles' tolerance against the single card's
# (atol = rtol: float32 sums in another order across 12 layers).
TP_SWAP_SEED = 1
TP_PAGE_TOL = 1e-5
# Phases 13 and 13b's LM: the serving width at the fleet's cut depth
# (the swap, the blob and phase 13b's gloo ticks on one card cost about
# a second a tick on slow hosts at 12 layers, and the zoo phase is paid
# for by these cuts); its reference runs on the single card are at the
# same depth.
TP_LAYERS = FLEET_LAYERS
TP_NO_CAPTURE = ("the ranks share one card, so they meet over gloo, "
                 "whose collectives cannot be captured into a CUDA "
                 "graph: ServeEngine refuses capture=True over a gloo "
                 "group (NCCL refuses two ranks on one device)")


def _blob_parts(np, blob):
    """An HVKV blob's framing bytes and its float32 tiles."""
    end = 8 + int.from_bytes(blob[4:8], "big")
    return blob[:end], np.frombuffer(blob[end:], np.float32)


def _tp_blob(torch, np, eng, params, prompts, job):
    """Phase 13's HVKV round trip on the controller (module docstring):
    request 0 parked and exported, against the single card's blob, into
    a tp=1 cache and out, then admitted back and decoded."""
    from horovod_tpu_torch.serve import ServeConfig
    from horovod_tpu_torch.serve.kvcache import PagedKVCache
    from horovod_tpu_torch.serve.scheduler import make_request

    req = eng.submit(prompts[0], NEW_TOKENS)
    req.prefill_only = True
    while not eng.handoff:
        eng.step()
    t0 = time.perf_counter()
    blob = eng.export_handoff(req.rid)
    export_ms = (time.perf_counter() - t0) * 1e3
    eng.release_handoff(req.rid)
    with open(job["single_blob"], "rb") as f:
        single = f.read()
    frame, tiles = _blob_parts(np, blob)
    frame1, tiles1 = _blob_parts(np, single)
    err = (float(np.abs(tiles - tiles1).max())
           if tiles.shape == tiles1.shape else None)
    cache1 = PagedKVCache(params, ServeConfig(
        page_size=PAGE, num_pages=NUM_PAGES, decode_slots=SLOTS,
        prefill_chunk=CHUNK))
    grant, npos = cache1.import_pages(blob)
    back = cache1.export_pages(grant, npos)
    del cache1
    r2 = make_request(eng.config, eng.clock, prompts[0], NEW_TOKENS)
    r2.generated = [req.output[0]]
    r2.output = list(r2.generated)
    t0 = time.perf_counter()
    eng.admit_prefilled(r2, back)
    import_ms = (time.perf_counter() - t0) * 1e3
    again = eng.export_pages(r2.pages[:len(grant)], npos)
    eng.run(max_steps=2000)
    return {"bytes": len(blob), "pages": len(grant), "positions": npos,
            "framing_equal": frame == frame1,
            "max_abs_err": err,
            "within_tol": err is not None and bool(np.allclose(
                tiles, tiles1, rtol=TP_PAGE_TOL, atol=TP_PAGE_TOL)),
            "tp1_bit_exact": back == blob,
            "tp_bit_exact": again == blob,
            "stream_equal": r2.output == job["refs_new"][0],
            "export_ms": export_ms, "import_ms": import_ms}


def _tp_captured(torch, np, params, dev, world, prompts, job, streams):
    """Phase 13's captured lane over NCCL: a second engine with
    ``capture=True`` on every rank, the waves again (the controller),
    one replayed live tick under the profiler, then a weight swap, which
    every rank's lane captures again."""
    from horovod_tpu_torch.models.parallel_lm import init_lm_params
    from horovod_tpu_torch.ops.paged_attention import paged_attention_decode
    from horovod_tpu_torch.serve import ServeConfig, ServeEngine

    paged_attention_decode.launches = 0
    eng = ServeEngine(params, ServeConfig(
        page_size=PAGE, num_pages=NUM_PAGES, decode_slots=SLOTS,
        prefill_chunk=CHUNK, attention="paged", mesh=f"dp=1,tp={world}"),
        device=dev, capture=True, chips=world)
    out = {"ran": True}
    if eng.is_controller:
        eng.submit(prompts[0][:16], 4)
        eng.run()
        eng.reset_metrics()
        t1 = time.perf_counter()
        reqs = []
        for idx, steps in job["waves"]:
            reqs += [eng.submit(prompts[i], NEW_TOKENS) for i in idx]
            for _ in range(steps):
                eng.step()
        eng.run(max_steps=2000)
        torch.cuda.synchronize()
        st = eng.stats()
        out.update(wall=time.perf_counter() - t1,
                   streams_equal_eager=[r.output for r in reqs] == streams,
                   ttft_ms=st["ttft_ms"], tbt_ms=st["tbt_ms"],
                   tokens_per_sec_per_chip=st["tokens_per_sec_per_chip"])
        # One replayed live tick under the profiler, after a traced one.
        eng.submit(prompts[1], 8)
        while not any(eng.slots):
            eng.step()
        prof = _profile_run(torch, eng.step, ("paged_split", "paged_merge"),
                            warmup=eng.step)
        out["tick_trace"] = prof
        eng.run(max_steps=2000)
        # A weight swap captures the lane again on every rank.
        new = init_lm_params(TP_SWAP_SEED, VOCAB, LMAX, TP_LAYERS, HEADS,
                             HEAD_DIM, FFN, device=dev)
        eng.update_params(new)
        n = min(8, NEW_TOKENS)
        req = eng.submit(prompts[0], n)
        eng.run(max_steps=2000)
        out["swap_stream_equal"] = req.output == job["refs_new"][0][:n]
        del new
        eng.close()
    else:
        eng.follow()
    graph = eng.lane_graphs[False]
    out.update(captures=graph.captures, replays=graph.replays,
               capture_s=graph.capture_s,
               launches=paged_attention_decode.launches)
    del eng, graph
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_train(torch, np, params, world, rank, dev):
    """One TP training step (``lm_apply(tp)`` + the vocab-parallel fused
    loss + ``reduce_grads``) against the dense step on the same weights:
    the losses and the largest error of each gradient shard against the
    dense gradient's slice, relative to the slice's largest entry."""
    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.parallel.logical import LogicalMesh, bind

    tokens = torch.tensor(np.random.default_rng(9).integers(
        0, VOCAB, (TP_BATCH, TP_SEQ)), device=dev)
    specs = plm.lm_param_specs(TP_LAYERS, "tp", vocab_parallel=True)

    def tree(fn, t):
        if isinstance(t, dict):
            return {k: tree(fn, v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(fn, v) for v in t]
        return fn(t)

    def step(p, tp):
        tree(lambda x: x.requires_grad_(True), p)
        hidden = plm.lm_apply(p, tokens, tp=tp, return_hidden=True)
        loss = plm.next_token_nll_fused(p, hidden, tokens, tp=tp,
                                        vocab_parallel=tp is not None)
        loss.backward()
        return float(loss), plm.reduce_grads(tree(lambda x: x.grad, p))

    # A world of one's "shard" is a copy of the dense weights.
    dense_loss, dense_g = step(plm.shard_lm_params(params, specs, 1, 0),
                               None)
    with bind(LogicalMesh.from_config(f"dp=1,tp={world}")):
        tp_loss, tp_g = step(plm.shard_lm_params(params, specs, world,
                                                 rank), "tp")
    cut = plm.shard_lm_params(dense_g, specs, world, rank)
    errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(_leaves(tp_g), _leaves(cut))]
    torch.cuda.synchronize()
    return {"loss": tp_loss, "dense_loss": dense_loss,
            "loss_rel": abs(tp_loss - dense_loss) / abs(dense_loss),
            "grad_rel_max": max(errs), "leaves": len(errs)}


def tp_rank(argv):
    """``--tp-rank RANK WORLD PORT FILE``: one rank of the tp phase's
    world: its own card over NCCL when there are WORLD cards, else the
    first card over gloo. Rank 0 serves ``FILE``'s requests through a
    ``mesh="dp=1,tp=WORLD"`` paged engine (eager) and the others follow;
    then every rank takes the TP training step. Prints ``TP_RESULT
    {json}`` last."""
    import faulthandler

    import numpy as np
    import torch
    import torch.distributed as dist

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    rank, world, port = (int(a) for a in argv[:3])

    with open(argv[3]) as f:
        job = json.load(f)
    own = torch.cuda.device_count() >= world
    dev = torch.device("cuda", rank if own else 0)
    torch.cuda.set_device(dev)
    backend = "nccl" if own else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from horovod_tpu_torch.models.parallel_lm import init_lm_params
    from horovod_tpu_torch.ops.paged_attention import paged_attention_decode
    from horovod_tpu_torch.serve import ServeConfig, ServeEngine

    out = {"rank": rank, "backend": backend, "device": str(dev)}
    try:
        params = init_lm_params(0, VOCAB, LMAX, TP_LAYERS, HEADS, HEAD_DIM,
                                FFN, device=dev)
        eng = ServeEngine(params, ServeConfig(
            page_size=PAGE, num_pages=NUM_PAGES, decode_slots=SLOTS,
            prefill_chunk=CHUNK, attention="paged",
            mesh=f"dp=1,tp={world}"), device=dev, capture=False,
            chips=world)
        out["page_shape"] = list(eng.cache.pages[0]["k"].shape)
        out["pages_contiguous"] = all(
            t.is_contiguous() for layer in eng.cache.pages
            for t in layer.values())
        prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
        # K4's count from just before the engine serves to just after.
        paged_attention_decode.launches = 0
        t0 = time.perf_counter()
        if eng.is_controller:
            eng.submit(prompts[0][:16], 4)
            eng.run()
            eng.reset_metrics()
            t1 = time.perf_counter()
            reqs = []
            for idx, steps in job["waves"]:
                reqs += [eng.submit(prompts[i], NEW_TOKENS) for i in idx]
                for _ in range(steps):
                    eng.step()
            eng.run(max_steps=2000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            out["streams"] = [r.output for r in reqs]
            out["states"] = [r.state for r in reqs]
            out["stats"] = eng.stats()
            out["wall"] = wall
            out["divergence"] = _tp_divergence(torch, params, prompts,
                                               reqs, job["refs"])
            # The weight swap, then the same requests again.
            new = init_lm_params(TP_SWAP_SEED, VOCAB, LMAX, TP_LAYERS, HEADS,
                                 HEAD_DIM, FFN, device=dev)
            t1 = time.perf_counter()
            eng.update_params(new)
            torch.cuda.synchronize()
            out["swap_s"] = time.perf_counter() - t1
            reqs = []
            for idx, steps in job["waves"]:
                reqs += [eng.submit(prompts[i], NEW_TOKENS) for i in idx]
                for _ in range(steps):
                    eng.step()
            eng.run(max_steps=2000)
            out["swap_states"] = [r.state for r in reqs]
            out["swap_divergence"] = _tp_divergence(
                torch, new, prompts, reqs, job["refs_new"])
            out["blob"] = _tp_blob(torch, np, eng, params, prompts, job)
            del new
            eng.close()
        else:
            eng.follow()
        out["lane_ticks"] = eng.lane_ticks
        out["launches"] = paged_attention_decode.launches
        out["serve_s"] = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
        out["captured"] = (
            _tp_captured(torch, np, params, dev, world, prompts, job,
                         out.get("streams"))
            if backend == "nccl" else {"ran": False, "why": TP_NO_CAPTURE})
        out["train"] = _tp_train(torch, np, params, world, rank, dev)
        print("TP_RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def _tp_divergence(torch, params, prompts, reqs, refs):
    """The first request whose stream leaves its reference: the position
    and the top-2 logit gap there (None when every stream is equal)."""
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        j = _first_divergence(r.output, ref)
        if j is not None:
            return {"request": i, "position": j,
                    "top2_gap": _top2_gap(torch, params,
                                          list(prompts[i]) + ref[:j])}
    return None


def _rank_world(flag, n, timeout, arg, tag, parent=None):
    """Start ``n`` rank processes of this script (``flag RANK n PORT
    arg``); wait for all, kill all as soon as one fails or past
    ``timeout`` seconds; return each rank's ``TAG_RESULT`` object.
    ``parent()``, when given, runs in this process while the ranks start
    (it writes what they wait for under ``arg``, then ``_mark_ready``);
    a failure there kills the ranks."""
    import os
    import socket
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prefix = f"{tag}_RESULT "
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(os.path.join(tmp, f"r{r}.out"), "w+"),
                 open(os.path.join(tmp, f"r{r}.err"), "w+"))
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), flag,
             str(r), str(n), str(port), arg],
            cwd=here, stdout=o, stderr=e, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
            for r, (o, e) in enumerate(logs)]
        try:
            if parent is not None:
                parent()
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            live = [p for p in procs if p.poll() is None]
            for p in live:
                # A rank that registered faulthandler on SIGUSR1 dumps
                # its threads' stacks: where it waited.
                p.send_signal(signal.SIGUSR1)
            if live:
                time.sleep(3)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results, errors = [], []
        for r, (p, (o, e)) in enumerate(zip(procs, logs)):
            o.seek(0)
            e.seek(0)
            stdout, stderr = o.read(), e.read()
            o.close()
            e.close()
            lines = [l for l in stdout.splitlines() if l.startswith(prefix)]
            if p.returncode == 0 and lines:
                results.append(json.loads(lines[-1][len(prefix):]))
            else:
                errors.append(f"rank {r} exited {p.returncode}: "
                              f"{stderr[-3000:]}" + (
                                  f"\nits result: {lines[-1][:3000]}"
                                  if lines else ""))
        check(not errors, f"{tag.lower()}: " + "\n".join(errors))
    return results


def _mark_ready(d):
    """Tell the ranks waiting in :func:`_wait_ready` that ``d`` holds the
    parent's references."""
    import os

    with open(os.path.join(d, "ready"), "w"):
        pass


def _wait_ready(d, timeout):
    """Wait until the parent has marked ``d`` ready."""
    import os

    deadline = time.monotonic() + timeout
    while not os.path.exists(os.path.join(d, "ready")):
        check(time.monotonic() < deadline,
              f"the parent's references in {d} were not ready after "
              f"{timeout} s")
        time.sleep(0.2)


def _tp_world(job, blob):
    """Start TP_RANKS rank processes of this script over ``job`` (written
    to a file, with the single card's handoff ``blob`` beside it); return
    each rank's result."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        job = dict(job, single_blob=os.path.join(tmp, "single.hvkv"))
        with open(job["single_blob"], "wb") as f:
            f.write(blob)
        path = os.path.join(tmp, "tp_job.json")
        with open(path, "w") as f:
            json.dump(job, f)
        return _rank_world("--tp-rank", TP_RANKS, TP_TIMEOUT_S, path, "TP")


def tp_references(torch, np, prompts, waves):
    """The single card's captured paged engine at the cut depth of phases
    10, 11, 13 and 13b (``FLEET_LAYERS``): its run over the waves under
    the weights of numpy seed 0 (``old``, with those weights as
    ``"params"``) and of ``TP_SWAP_SEED`` (``new``, with request 0's
    handoff blob). Those phases compare against them."""
    from horovod_tpu_torch.models.parallel_lm import init_lm_params

    out = {}
    for name, seed in (("old", 0), ("new", TP_SWAP_SEED)):
        params = init_lm_params(seed, VOCAB, LMAX, TP_LAYERS, HEADS,
                                HEAD_DIM, FFN, device="cuda")
        eng, run = _serve_run(torch, params, prompts, waves,
                              f"tp_reference_{name}", "paged", True)
        if name == "new":
            req = eng.submit(prompts[0], NEW_TOKENS)
            req.prefill_only = True
            while not eng.handoff:
                eng.step()
            run["blob"] = eng.export_handoff(req.rid)
        else:
            run["params"] = params
        out[name] = run
        del eng, params
        torch.cuda.empty_cache()
    return out


def tp_phase(torch, np, prompts, waves, card, ref):
    """Phase 13 (module docstring): the engine phase's requests through a
    4-rank tensor-parallel paged engine, against the single-card paged
    engine's streams before and after a weight swap (``ref``:
    :func:`tp_references`, with request 0's blob under the new weights);
    the HVKV round trip; K4 on every rank's 3-head shard; the captured
    lane over NCCL; the TP training step against the dense one."""
    t0 = time.perf_counter()
    index = {id(p): i for i, p in enumerate(prompts)}
    single = ref["old"]
    job = {"prompts": [p.tolist() for p in prompts],
           "waves": [([index[id(p)] for p in wave], steps)
                     for wave, steps in waves],
           "refs": [r.output for r in single["reqs"]],
           "refs_new": [r.output for r in ref["new"]["reqs"]]}
    ranks = _tp_world(job, ref["new"]["blob"])
    r0 = ranks[0]
    for what, states, div in (
            ("", r0["states"], r0["divergence"]),
            (" after the weight swap", r0["swap_states"],
             r0["swap_divergence"])):
        check(all(s == "finished" for s in states),
              f"tp: not every request finished{what}: {states}")
        check(div is None,
              f"tp: request {div and div['request']}: the tp={TP_RANKS} "
              f"stream and the single-card paged stream diverge{what} at "
              f"generated position {div and div['position']} (top-2 "
              f"logit gap there {div and div['top2_gap']})")
    blob = r0["blob"]
    check(blob["framing_equal"] and blob["within_tol"]
          and blob["tp1_bit_exact"] and blob["tp_bit_exact"]
          and blob["stream_equal"],
          f"tp: the HVKV round trip of request 0: {blob} (framing equal to "
          f"the single card's, tiles within {TP_PAGE_TOL}, a tp=1 cache's "
          "and the TP engine's re-exports bit for bit, the admitted "
          "request's stream the single card's)")
    cap = r0["captured"]
    if r0["backend"] == "nccl":
        counts = cap["tick_trace"]["counts"]
        check(cap["streams_equal_eager"] and cap["swap_stream_equal"]
              and counts["paged_split"] == counts["paged_merge"] == TP_LAYERS,
              f"tp: the captured lane's streams equal eager "
              f"{cap['streams_equal_eager']} and the single card's after "
              f"the swap {cap['swap_stream_equal']}, a replayed tick "
              f"traced {counts}, expected {TP_LAYERS} of each K4 kernel")
        for r in ranks:
            c = r["captured"]
            check(c["captures"] == 2
                  and c["replays"] == cap["replays"] > 0
                  and c["launches"] == 4 * TP_LAYERS,
                  f"tp: rank {r['rank']}'s captured lane: {c['captures']} "
                  f"captures, {c['replays']} replays (rank 0 "
                  f"{cap['replays']}), {c['launches']} K4 wrapper calls; "
                  f"expected 2 (before and after the swap), equal and "
                  f"{4 * TP_LAYERS} (a warm-up step and a capture each)")
    heads = HEADS // TP_RANKS
    for r in ranks:
        check(r["page_shape"] == [NUM_PAGES, PAGE, heads, HEAD_DIM]
              and r["pages_contiguous"],
              f"tp: rank {r['rank']}'s pages {r['page_shape']} (contiguous "
              f"{r['pages_contiguous']}), expected [{NUM_PAGES}, {PAGE}, "
              f"{heads}, {HEAD_DIM}] each its own tensor")
        check(r["lane_ticks"] == r0["lane_ticks"] > 0
              and r["launches"] == TP_LAYERS * r["lane_ticks"],
              f"tp: rank {r['rank']} launched K4 {r['launches']} times "
              f"over {r['lane_ticks']} live decode ticks (rank 0: "
              f"{r0['lane_ticks']}), expected {TP_LAYERS} a tick")
        t = r["train"]
        check(t["loss_rel"] <= TP_LOSS_RTOL and math.isfinite(t["loss"]),
              f"tp: rank {r['rank']}'s TP loss {t['loss']} against the "
              f"dense {t['dense_loss']} (rel {t['loss_rel']:.2e} > "
              f"{TP_LOSS_RTOL})")
        check(t["grad_rel_max"] <= TP_GRAD_RTOL,
              f"tp: rank {r['rank']}'s gradient shards differ from the "
              f"dense gradient's slices by up to {t['grad_rel_max']:.2e} "
              f"of their largest entry (> {TP_GRAD_RTOL})")
    st, st1 = r0["stats"], single["stats"]
    kv, kv1 = (st["attention"]["kv_bytes_per_chip"],
               st1["attention"]["kv_bytes_per_chip"])
    check(kv <= kv1 / TP_RANKS * 1.001,
          f"tp: kv_bytes_per_chip {kv} above the single card's {kv1} / "
          f"{TP_RANKS}")
    cards = max(1, min(torch.cuda.device_count(), TP_RANKS))
    res = {
        "degree": TP_RANKS, "backend": r0["backend"], "cards": cards,
        "card": card, "mesh": f"dp=1,tp={TP_RANKS}", "attention": "paged",
        "capture": False,
        "streams_compared": len(r0["streams"]),
        "streams_equal": sum(a == b for a, b in zip(r0["streams"],
                                                    job["refs"])),
        # chips=TP_RANKS: the engine's tokens over its ranks; over the
        # card(s) they share.
        "tokens_per_sec_per_card": (st["tokens_per_sec_per_chip"]
                                    * TP_RANKS / cards
                                    if st["tokens_per_sec_per_chip"]
                                    else None),
        "single_tokens_per_sec": st1["tokens_per_sec_per_chip"],
        "ttft_ms": st["ttft_ms"], "tbt_ms": st["tbt_ms"],
        "wall_s": r0["wall"],
        "kv_bytes_per_chip": kv, "kv_bytes_per_chip_single": kv1,
        "swap_s": r0["swap_s"], "swap_streams_equal": True,
        "blob": blob,
        "captured": (
            {k: cap[k] for k in ("ran", "wall", "ttft_ms", "tbt_ms",
                                 "tokens_per_sec_per_chip", "capture_s")}
            | {"captures": [r["captured"]["captures"] for r in ranks],
               "replays": [r["captured"]["replays"] for r in ranks],
               "wrapper_launches": [r["captured"]["launches"]
                                    for r in ranks],
               "tick_trace": cap["tick_trace"]["counts"],
               "eager_tbt_ms": st["tbt_ms"]}
            if cap["ran"] else cap),
        "k4_launches": [r["launches"] for r in ranks],
        "lane_ticks": [r["lane_ticks"] for r in ranks],
        "k4_heads": heads,
        "page_shape": r0["page_shape"],
        "train": {k: [r["train"][k] for r in ranks]
                  for k in ("loss", "dense_loss", "loss_rel",
                            "grad_rel_max")},
        "train_shape": [TP_BATCH, TP_SEQ],
        "caveat": TP_CAVEAT if r0["backend"] == "gloo" else None,
    }
    res["phase_s"] = time.perf_counter() - t0
    log(f"tp: {TP_RANKS} ranks over {res['backend']} on {cards} card(s): "
        f"{res['streams_equal']}/{res['streams_compared']} streams equal "
        f"the single card's; K4 {res['k4_launches']} launches over "
        f"{res['lane_ticks']} live ticks ({heads} heads a rank); "
        f"kv_bytes_per_chip {kv} vs {kv1}; tokens/s a card "
        f"{res['tokens_per_sec_per_card']}; swap {r0['swap_s']:.2f} s; "
        f"blob {blob['bytes']} bytes, max err {blob['max_abs_err']}, "
        f"export {blob['export_ms']:.1f} ms, import "
        f"{blob['import_ms']:.1f} ms; captured: "
        f"{res['captured'] if cap['ran'] else 'not run (gloo)'}; "
        f"train loss rel "
        f"{max(res['train']['loss_rel']):.2e}, grad rel "
        f"{max(res['train']['grad_rel_max']):.2e}; phase passed in "
        f"{res['phase_s']:.1f} s")
    return res


# ----------------------------------------------------------- phase 13b

TP_FLEET_MESH = "dp=1,tp=2"
TP_FLEET_CAVEAT = ("each replica's 2 ranks share the card over gloo: "
                   "every collective stages its CUDA tensors through host "
                   "memory and loopback TCP, and all 4 ranks share one "
                   "card, so the tokens/s is that of host copies and "
                   "sockets, not of NVLink")


def _rank_counts(fl):
    """Every replica's ranks' counters (``rank_counters`` RPC)."""
    return [rep.engine.client.call("rank_counters")["ranks"]
            for rep in fl.replicas]


def _pid_gone(pid):
    """True when ``pid`` has exited (or is a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] == "Z"
    except OSError:
        return True


def tp_fleet_phase(torch, np, prompts, waves, ref, card):
    """Phase 13b (module docstring): a tp=2 prefill pool feeding a tp=2
    decode pool over the process transport, against the single card's
    streams (``ref``: :func:`tp_references`, ``new`` after a rolling
    update to the seed-1 weights)."""
    from horovod_tpu_torch.models.parallel_lm import init_lm_params
    from horovod_tpu_torch.serve import ServeConfig, ServeFleet

    t0 = time.perf_counter()
    params = init_lm_params(0, VOCAB, LMAX, TP_LAYERS, HEADS, HEAD_DIM, FFN,
                            device="cuda")
    fl = ServeFleet(params, ServeConfig(
        page_size=PAGE, num_pages=NUM_PAGES, decode_slots=SLOTS,
        prefill_chunk=CHUNK, attention="paged", mesh=TP_FLEET_MESH),
        _disagg_cfg(transport="process", spawn_timeout=FLEET_SPAWN_S,
                    rpc_deadline=FLEET_RPC_S), device="cuda")
    procs = [rep.proc for rep in fl.replicas]
    out = {"mesh": TP_FLEET_MESH, "pools": DISAGG_POOLS, "card": card,
           "cards": fl.replica_cards}
    followers = []
    try:
        _fleet_warm(fl, prompts)
        out["warm_s"] = time.perf_counter() - t0
        worlds = [rep.engine.client.call("ping")["tp"] for rep in fl.replicas]
        followers = [pid for w in worlds for pid in w["followers"]]
        out["backend"] = [w["backend"] for w in worlds]
        before = _rank_counts(fl)
        reqs, wall = _fleet_serve(torch, fl, waves)
        after = _rank_counts(fl)
        _fleet_check(torch, params, prompts, "tp_fleet", reqs,
                     ref["old"]["reqs"], "the single-card paged engine")
        st = _disagg_stats(fl, wall)
        d = st["disagg"]
        check(all(r.replica == 1 and r.redispatches == 0 for r in reqs)
              and d["transfers"] == len(prompts) and d["failures"] == {}
              and d["parked"] == 0,
              f"tp_fleet: {d}, finished on {[r.replica for r in reqs]}")
        delta = [[{k: a[k] - b[k] for k in ("lane_ticks", "decode_launches",
                                             "lane_replays")
                   if a[k] is not None}
                  for a, b in zip(ra, rb)] for ra, rb in zip(after, before)]
        pre, dec = delta
        captured = worlds[1]["backend"] == "nccl"
        check(all(c["lane_ticks"] == c["decode_launches"] == 0
                  for c in pre),
              f"tp_fleet: the prefill ranks decoded: {pre}")
        ticks = dec[0]["lane_ticks"]
        check(ticks > 0 and all(
            c["lane_ticks"] == ticks
            and c["decode_launches"] == (0 if captured else TP_LAYERS * ticks)
            and (not captured or c["lane_replays"] == ticks) for c in dec),
              f"tp_fleet: the decode ranks' counters over the run {dec}, "
              f"expected equal live ticks and K4 {TP_LAYERS} a tick "
              + ("in replays" if captured else "eager"))
        out.update(clean=st, rank_delta=delta,
                   ranks=[[{k: c[k] for k in ("rank", "pid")} for c in r]
                          for r in after])
        # The rolling update, then a second wave under the new weights.
        new = init_lm_params(TP_SWAP_SEED, VOCAB, LMAX, TP_LAYERS, HEADS,
                             HEAD_DIM, FFN, device="cuda")
        t1 = time.perf_counter()
        fl.update_params(new)
        _fleet_drain(fl)
        out["roll_s"] = time.perf_counter() - t1
        check([r.version for r in fl.replicas] == [2, 2],
              f"tp_fleet: versions after the roll "
              f"{[r.version for r in fl.replicas]}")
        fl.reset_metrics()
        reqs2, wall2 = _fleet_serve(torch, fl, waves)
        _fleet_check(torch, new, prompts, "tp_fleet[rolled]", reqs2,
                     ref["new"]["reqs"], "the single-card paged engine "
                     "under the new weights")
        out["rolled"] = _disagg_stats(fl, wall2)
        del new
    finally:
        fl.close()
    for p in procs:
        check(p.poll() is not None,
              f"tp_fleet: worker {p.pid} not reaped after close()")
    deadline = time.monotonic() + 10
    while not all(_pid_gone(p) for p in followers) and \
            time.monotonic() < deadline:
        time.sleep(0.1)
    check(all(_pid_gone(p) for p in followers),
          f"tp_fleet: followers {followers} outlived close()")
    cards = max(1, len({c for cs in fl.replica_cards.values() for c in cs}))
    for key in ("clean", "rolled"):
        run = out[key]
        total = run["tokens_per_sec_per_replica"] * fl.chips
        run["tokens_per_sec_per_card"] = round(total / cards, 1)
    out["caveat"] = (TP_FLEET_CAVEAT if "gloo" in out["backend"] else None)
    out["phase_s"] = time.perf_counter() - t0
    c = out["clean"]
    log(f"tp_fleet: {len(prompts)} requests through a {TP_FLEET_MESH} "
        f"prefill pool and decode pool ({out['backend']}, cards "
        f"{fl.replica_cards}), streams equal the single card's before and "
        f"after the roll ({out['roll_s']:.1f} s); transfers "
        f"{c['disagg']['transfers']}, ms p50 "
        f"{c['disagg']['transfer_ms_p50']} p99 "
        f"{c['disagg']['transfer_ms_p99']}; tokens/s a card "
        f"{c['tokens_per_sec_per_card']}; per-token ms p50 "
        f"{c['tbt_ms']['p50']}; decode ranks {dec}; phase "
        f"{out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------ phase 14

SP_RANKS = 4
SP_TIMEOUT_S = 600.0
# Ulysses: GPT-2-small in float32 (no TF32) on one sequence of 8192
# tokens, 2048 a rank; after the all-to-all each rank's K1 runs over [1,
# 8192, 3, 64], its K2/K3 in the backward. Ring: lm_apply(sp=) and the
# fused loss on one sequence of 4096 tokens, 1024 a rank (the dense
# reference keeps about 29 GB of [1, 12, 4096, 4096] probabilities for
# its backward, so it runs before the world starts). sp=2,tp=2: one
# forward on the ring's weights and tokens. Pipeline: 4 stages of one
# block, 8 x 512 tokens in 4 microbatches. Each against the dense step
# on the same weights: the sharded sums add the same float32 terms in
# another order (the loss moves by a few 1e-7 relative, a gradient leaf
# by far less than 1e-4 of its largest entry), where a missed shard, a
# wrong global position or a gradient summed twice moves them by whole
# factors.
SP_ULYSSES_L, SP_RING_L = 8192, 4096
# The Ulysses and ring models' depth: 2 of the 12 layers at the full
# width (12 until the ep phase came, 4 until phase 13b came: each cut
# pays for part of a new phase, as the hier phase's did for this one).
# Every layer runs the same collectives and kernels, so the checks see
# the same paths at a sixth of the steps.
SP_LAYERS = 2
SP_PP_BATCH, SP_PP_SEQ, SP_PP_MICRO = 8, 512, 4
SP_LOSS_RTOL = 1e-5
SP_GRAD_RTOL = 1e-4
SP_CAVEAT = ("4 ranks share one card over gloo: each collective stages "
             "its CUDA tensors through host memory and loopback TCP, so "
             "the step times are those of host copies and sockets, not of "
             "NVLink")
# The collectives of the phase's paths and the torch.distributed call
# each rides.
SP_PRIMITIVES = {
    "ppermute": "all_to_all_single (the whole tensor to one peer)",
    "all_to_all": "all_to_all_single",
    "sum_across, reduce_grads, pp_reduce_rest_grads": "all_reduce",
}


def _sp_tokens(np, shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, shape)


def _sp_ulysses_model(torch, attn_fn, dev):
    from horovod_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(vocab_size=VOCAB, num_layers=SP_LAYERS,
                         num_heads=HEADS, embed_dim=D_MODEL,
                         max_len=SP_ULYSSES_L, dtype=torch.float32,
                         attn_fn=attn_fn, seed=0, device=dev)


def _sp_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _sp_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sp_tree(fn, v) for v in tree]
    return fn(tree)


def _sp_trainable(tree):
    for t in _leaves(tree):
        t.requires_grad_(True)
    return tree


def _sp_references(torch, np, out):
    """The dense steps the ranks are held to, on the card in this
    process before the world starts, saved under ``out``: each variant's
    loss and gradients (CPU tensors, in parameter order; the pipeline's
    as ``stack_layers`` splits them). Returns the losses."""
    import functools
    import os

    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.ops.attention import flash_attention

    losses = {}

    def save(name, loss, grads):
        losses[name] = float(loss.detach())
        torch.save({"loss": losses[name],
                    "grads": [g.detach().cpu() for g in grads]},
                   os.path.join(out, f"{name}.pt"))

    model = _sp_ulysses_model(
        torch, functools.partial(flash_attention, causal=True), "cuda")
    toks = torch.tensor(_sp_tokens(np, (1, SP_ULYSSES_L), 15),
                        device="cuda")
    loss = plm.next_token_nll(model(toks), toks)
    loss.backward()
    save("ulysses", loss, [p.grad for p in model.parameters()])
    del model, loss
    params = _sp_trainable(plm.init_lm_params(
        1, VOCAB, SP_RING_L, SP_LAYERS, HEADS, HEAD_DIM, FFN,
        device="cuda"))
    toks = torch.tensor(_sp_tokens(np, (1, SP_RING_L), 16), device="cuda")
    loss = plm.next_token_nll_fused(
        params, plm.lm_apply(params, toks, return_hidden=True), toks)
    loss.backward()
    save("ring", loss, [t.grad for t in _leaves(params)])
    del params, loss
    torch.cuda.empty_cache()
    params = _sp_trainable(plm.init_lm_params(
        2, VOCAB, SP_PP_SEQ, SP_RANKS, HEADS, HEAD_DIM, FFN, device="cuda"))
    toks = torch.tensor(_sp_tokens(np, (SP_PP_BATCH, SP_PP_SEQ), 17),
                        device="cuda")
    loss = plm.next_token_nll(plm.lm_apply(params, toks), toks)
    loss.backward()
    rest, stacked = plm.stack_layers(_sp_tree(lambda t: t.grad, params))
    save("pipeline", loss, list(_leaves(rest)) + list(_leaves(stacked)))
    del params, loss, rest, stacked
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return losses


def _sp_kernel_check(torch, np):
    """K1-K3 alone at the Ulysses step's shape and dtype ([1, 8192, 3,
    64] float32, causal) against their plain versions at
    ``TOL["float32"]``: the dense reference runs the same kernels, so the
    step's loss and gradients alone would not see a kernel's fault over
    8192 keys. Returns the largest absolute error of each output."""
    from horovod_tpu_torch.ops import attention as fa

    rng = np.random.default_rng(18)
    q, k, v, do = _flash_case(torch, np, rng, 1, HEADS // SP_RANKS,
                              HEAD_DIM, SP_ULYSSES_L, SP_ULYSSES_L,
                              torch.float32)
    errs = _flash_check(torch, fa, q, k, v, do, True, 0, 0, TOL["float32"],
                        f"sp Ulysses shape [1, {SP_ULYSSES_L}, "
                        f"{HEADS // SP_RANKS}, {HEAD_DIM}] float32 causal")
    del q, k, v, do
    torch.cuda.empty_cache()
    return errs


def _sp_errors(torch, grads, ref, dev):
    """The largest error of each gradient leaf against the reference's,
    relative to the reference leaf's largest entry: the worst of them."""
    errs = []
    for g, r in zip(grads, ref):
        r = r.to(dev)
        errs.append(float((g - r).abs().max()
                          / r.abs().max().clamp(min=1e-30)))
    check(len(errs) == len(ref) and len(errs) > 0,
          f"sp: {len(errs)} gradient leaves against {len(ref)}")
    return max(errs)


def _sp_time(torch, step, warm=True, before=None):
    """A warm-up ``step()`` (``warm``), then ``before()`` and one timed
    ``step()``: its result and milliseconds; the warm-up's milliseconds
    and the timed step's peak memory on this rank's card are left in
    ``_sp_time.warm_ms`` and ``_sp_time.peak``."""
    t0 = time.perf_counter()
    if warm:
        step()
        torch.cuda.synchronize()
    _sp_time.warm_ms = (time.perf_counter() - t0) * 1e3
    if before is not None:
        before()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    _sp_time.peak = torch.cuda.max_memory_allocated()
    return out, (time.perf_counter() - t0) * 1e3


def _sp_ulysses(torch, np, dev, rank, ref):
    """Ulysses: the bench lane's model with a Ulysses ``attn_fn`` on the
    flash kernels and ``pos_offset``, one forward and backward step, the
    gradients summed over ``sp``; K1-K3's launches in the timed step."""
    import functools

    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.ops import attention as fa
    from horovod_tpu_torch.parallel import (LogicalMesh, bind,
                                            ulysses_attention)

    lt = SP_ULYSSES_L // SP_RANKS
    toks = torch.tensor(_sp_tokens(np, (1, SP_ULYSSES_L), 15)[
        :, rank * lt:(rank + 1) * lt], device=dev)
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    with bind(LogicalMesh.from_config(f"sp={SP_RANKS}")):
        model = _sp_ulysses_model(torch, functools.partial(
            ulysses_attention, axis="sp", causal=True, use_flash=True), dev)

        def step():
            model.zero_grad(set_to_none=True)
            loss = plm.next_token_nll(model(toks, pos_offset=rank * lt),
                                      toks, sp="sp")
            loss.backward()
            return float(loss)

        def zero():
            for k in kernels:
                k.launches = 0

        loss, ms = _sp_time(torch, step, before=zero)
        peak, warm_ms = _sp_time.peak, _sp_time.warm_ms
        launches = {k.__name__: k.launches for k in kernels}
        grads, red_ms = _sp_time(torch, lambda: plm.reduce_grads(
            [p.grad for p in model.parameters()], sp="sp"), warm=False)
    out = {"loss": loss, "step_ms": ms, "warmup_ms": warm_ms,
           "reduce_ms": red_ms, "peak_memory_bytes": peak,
           "launches": launches, "k1_shape": [1, SP_ULYSSES_L,
                                              HEADS // SP_RANKS, HEAD_DIM],
           "grad_rel_max": _sp_errors(torch, grads, ref["grads"], dev)}
    del model, grads
    return out


def _sp_ring(torch, np, dev, rank, ref):
    """Ring attention through ``lm_apply(sp=)``, the fused loss and
    ``reduce_grads(sp=)``; the dead blocks the timed forward skipped.
    Returns the result and the weights (the sp=2,tp=2 forward's)."""
    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.parallel import LogicalMesh, bind, ring_attention

    lt = SP_RING_L // SP_RANKS
    toks = torch.tensor(_sp_tokens(np, (1, SP_RING_L), 16)[
        :, rank * lt:(rank + 1) * lt], device=dev)
    params = _sp_trainable(plm.init_lm_params(
        1, VOCAB, SP_RING_L, SP_LAYERS, HEADS, HEAD_DIM, FFN, device=dev))
    skipped = []
    with bind(LogicalMesh.from_config(f"sp={SP_RANKS}")):
        def step():
            for t in _leaves(params):
                t.grad = None
            hidden = plm.lm_apply(params, toks, sp="sp", return_hidden=True)
            loss = plm.next_token_nll_fused(params, hidden, toks, sp="sp")
            loss.backward()
            return float(loss)

        loss, ms = _sp_time(torch, step, before=lambda: skipped.append(
            ring_attention.skipped))
        peak, warm_ms = _sp_time.peak, _sp_time.warm_ms
        skipped = ring_attention.skipped - skipped[0]
        grads, red_ms = _sp_time(torch, lambda: plm.reduce_grads(
            [t.grad for t in _leaves(params)], sp="sp"), warm=False)
    out = {"loss": loss, "step_ms": ms, "warmup_ms": warm_ms,
           "reduce_ms": red_ms, "peak_memory_bytes": peak,
           "skipped": skipped,
           "grad_rel_max": _sp_errors(torch, grads, ref["grads"], dev)}
    del grads
    return out, params


def _sp_tp(torch, np, dev, rank, params):
    """One forward of ``lm_apply(sp=, tp=)`` and its fused loss over
    ``sp=2,tp=2`` on the ring's weights and tokens."""
    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.parallel import LogicalMesh, bind

    lm = LogicalMesh.from_config("sp=2,tp=2")
    sp_i, tp_i = (int(x) for x in np.argwhere(lm.ranks == rank)[0])
    lt = SP_RING_L // 2
    toks = torch.tensor(_sp_tokens(np, (1, SP_RING_L), 16)[
        :, sp_i * lt:(sp_i + 1) * lt], device=dev)
    with bind(lm), torch.no_grad():
        shard = plm.shard_lm_params(params, plm.lm_param_specs(
            SP_LAYERS, "tp"), 2, tp_i)

        def step():
            hidden = plm.lm_apply(shard, toks, sp="sp", tp="tp",
                                  return_hidden=True)
            return float(plm.next_token_nll_fused(shard, hidden, toks,
                                                  sp="sp", tp="tp"))

        # The warm-up forward also brings up the new groups' communicators
        # (NCCL makes them on first use, seconds of set-up).
        loss, ms = _sp_time(torch, step)
    return {"loss": loss, "forward_ms": ms,
            "warmup_ms": _sp_time.warm_ms, "sp_index": sp_i,
            "tp_index": tp_i}


def _sp_pipeline(torch, np, dev, rank, ref):
    """``lm_apply_pp`` over ``pp=4`` (one block a stage), ``remat`` off
    and on; the stage's gradients and the ``pp_reduce_rest_grads`` ones
    against the dense step's."""
    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.parallel import LogicalMesh, bind

    params = plm.init_lm_params(2, VOCAB, SP_PP_SEQ, SP_RANKS, HEADS,
                                HEAD_DIM, FFN, device=dev)
    rest, stacked = plm.stack_layers(params)
    rspec, lspec = plm.lm_pp_specs(rest, stacked)
    rest = _sp_trainable(plm.shard_lm_params(rest, rspec, SP_RANKS, rank))
    stage = _sp_trainable(plm.shard_lm_params(stacked, lspec, SP_RANKS,
                                              rank))
    del params, stacked
    toks = torch.tensor(_sp_tokens(np, (SP_PP_BATCH, SP_PP_SEQ), 17),
                        device=dev)
    n_rest = len(list(_leaves(rest)))
    ref_rest = ref["grads"][:n_rest]
    ref_stage = [g[rank:rank + 1] for g in ref["grads"][n_rest:]]
    out = {}
    with bind(LogicalMesh.from_config(f"pp={SP_RANKS}")):
        for remat in (False, True):
            def step():
                for t in list(_leaves(rest)) + list(_leaves(stage)):
                    t.grad = None
                loss = plm.next_token_nll(plm.lm_apply_pp(
                    rest, stage, toks, axis="pp", microbatches=SP_PP_MICRO,
                    remat=remat), toks)
                loss.backward()
                return float(loss)

            loss, ms = _sp_time(torch, step)
            g_rest = plm.pp_reduce_rest_grads(_sp_tree(lambda t: t.grad,
                                                       rest))
            out["remat" if remat else "stored"] = {
                "loss": loss, "step_ms": ms, "warmup_ms": _sp_time.warm_ms,
                "rest_grad_rel_max": _sp_errors(
                    torch, list(_leaves(g_rest)), ref_rest, dev),
                "stage_grad_rel_max": _sp_errors(
                    torch, [t.grad for t in _leaves(stage)], ref_stage,
                    dev)}
    return out


def sp_rank(argv):
    """``--sp-rank RANK WORLD PORT DIR``: one rank of the sp/pp phase's
    world (its own card over NCCL when there are WORLD cards, else the
    first card over gloo): the Ulysses, ring, sp=2,tp=2 and pipeline
    variants against the dense references under ``DIR``. Prints
    ``SP_RESULT {json}`` last."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port = (int(a) for a in argv[:3])
    secs, t0 = {}, time.perf_counter()
    own = torch.cuda.device_count() >= world
    dev = torch.device("cuda", rank if own else 0)
    torch.cuda.set_device(dev)
    backend = "nccl" if own else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from horovod_tpu_torch.common import basics

    basics.init(device=dev)
    out = {"rank": rank, "backend": backend, "device": str(dev),
           "seconds": secs}

    def lap(name):
        nonlocal t0
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    lap("setup")
    try:
        _wait_ready(argv[3], SP_TIMEOUT_S)
        refs = {name: torch.load(os.path.join(argv[3], f"{name}.pt"))
                for name in ("ulysses", "ring", "pipeline")}
        lap("wait_for_references")
        out["ulysses"] = _sp_ulysses(torch, np, dev, rank, refs["ulysses"])
        torch.cuda.empty_cache()
        lap("ulysses")
        out["ring"], params = _sp_ring(torch, np, dev, rank, refs["ring"])
        lap("ring")
        out["sp_tp"] = _sp_tp(torch, np, dev, rank, params)
        del params
        torch.cuda.empty_cache()
        lap("sp_tp")
        out["pipeline"] = _sp_pipeline(torch, np, dev, rank,
                                       refs["pipeline"])
        lap("pipeline")
    finally:
        basics.shutdown()
        dist.destroy_process_group()
    print("SP_RESULT " + json.dumps(out), flush=True)


def sp_phase(torch, np, card):
    """Phase 14 (module docstring): sequence and pipeline parallelism in
    a 4-rank world against the dense steps on the same weights; K1-K3 on
    every rank's Ulysses head group."""
    import tempfile

    t0 = time.perf_counter()
    parent = {}

    def references(tmp):
        # While the ranks start: the kernel check, then the references.
        kcheck = _sp_kernel_check(torch, np)
        log(f"sp: K1-K3 agree with their plain versions at [1, "
            f"{SP_ULYSSES_L}, {HEADS // SP_RANKS}, {HEAD_DIM}] float32 "
            f"causal (max_abs_err {kcheck}, atol=rtol={TOL['float32']})")
        parent["kcheck"] = kcheck
        parent["check_s"] = time.perf_counter() - t0
        parent["refs"] = _sp_references(torch, np, tmp)
        parent["refs_s"] = time.perf_counter() - t0 - parent["check_s"]
        _mark_ready(tmp)

    with tempfile.TemporaryDirectory() as tmp:
        ranks = _rank_world("--sp-rank", SP_RANKS, SP_TIMEOUT_S, tmp, "SP",
                            parent=lambda: references(tmp))
    kcheck, check_s = parent["kcheck"], parent["check_s"]
    refs, refs_s = parent["refs"], parent["refs_s"]
    r0 = ranks[0]

    def rel(loss, ref):
        return abs(loss - ref) / abs(ref)

    for r in ranks:
        who = f"sp: rank {r['rank']}"
        u, g = r["ulysses"], r["ring"]
        for name, res, ref in (("ulysses", u, refs["ulysses"]),
                               ("ring", g, refs["ring"]),
                               ("sp=2,tp=2", r["sp_tp"], refs["ring"])):
            check(math.isfinite(res["loss"])
                  and rel(res["loss"], ref) <= SP_LOSS_RTOL,
                  f"{who}: {name} loss {res['loss']} against the dense "
                  f"{ref} (rel {rel(res['loss'], ref):.2e} > "
                  f"{SP_LOSS_RTOL})")
        for name, err in (("ulysses", u["grad_rel_max"]),
                          ("ring", g["grad_rel_max"])):
            check(err <= SP_GRAD_RTOL,
                  f"{who}: {name} gradients summed over sp differ from "
                  f"the dense ones by up to {err:.2e} of their largest "
                  f"entry (> {SP_GRAD_RTOL})")
        check(all(n == SP_LAYERS for n in u["launches"].values()),
              f"{who}: K1-K3 launches {u['launches']} in the Ulysses step, "
              f"expected {SP_LAYERS} each")
        want_skip = SP_LAYERS * (SP_RANKS - 1 - r["rank"])
        check(g["skipped"] == want_skip,
              f"{who}: the ring's forward skipped {g['skipped']} dead "
              f"blocks, expected {want_skip}")
        for name, p in r["pipeline"].items():
            check(rel(p["loss"], refs["pipeline"]) <= SP_LOSS_RTOL,
                  f"{who}: pipeline ({name}) loss {p['loss']} against the "
                  f"dense {refs['pipeline']}")
            err = max(p["rest_grad_rel_max"], p["stage_grad_rel_max"])
            check(err <= SP_GRAD_RTOL,
                  f"{who}: pipeline ({name}) gradients differ from the "
                  f"dense ones by up to {err:.2e} (> {SP_GRAD_RTOL})")
    cards = max(1, min(torch.cuda.device_count(), SP_RANKS))

    def rate(tokens, key, sub):
        ms = max(sub(r)[key] for r in ranks)
        return tokens / (ms / 1e3) / cards

    ticks = SP_PP_MICRO + SP_RANKS - 1
    res = {
        "ranks": SP_RANKS, "backend": r0["backend"], "cards": cards,
        "card": card, "collectives": SP_PRIMITIVES,
        "ulysses": {
            "mesh": f"sp={SP_RANKS}", "tokens": SP_ULYSSES_L,
            "step_ms": [r["ulysses"]["step_ms"] for r in ranks],
            "warmup_ms": [r["ulysses"]["warmup_ms"] for r in ranks],
            "reduce_ms": [r["ulysses"]["reduce_ms"] for r in ranks],
            "peak_memory_bytes": [r["ulysses"]["peak_memory_bytes"]
                                  for r in ranks],
            "tokens_per_sec_per_card": rate(SP_ULYSSES_L, "step_ms",
                                            lambda r: r["ulysses"]),
            "loss": r0["ulysses"]["loss"], "dense_loss": refs["ulysses"],
            "loss_rel": max(rel(r["ulysses"]["loss"], refs["ulysses"])
                            for r in ranks),
            "grad_rel_max": max(r["ulysses"]["grad_rel_max"]
                                for r in ranks),
            "launches": [r["ulysses"]["launches"] for r in ranks],
            "k1_shape": r0["ulysses"]["k1_shape"],
            "kernel_check": {"dtype": "float32", "causal": True,
                             "tol": TOL["float32"], "max_abs_err": kcheck}},
        "ring": {
            "mesh": f"sp={SP_RANKS}", "tokens": SP_RING_L,
            "step_ms": [r["ring"]["step_ms"] for r in ranks],
            "warmup_ms": [r["ring"]["warmup_ms"] for r in ranks],
            "reduce_ms": [r["ring"]["reduce_ms"] for r in ranks],
            "peak_memory_bytes": [r["ring"]["peak_memory_bytes"]
                                  for r in ranks],
            "tokens_per_sec_per_card": rate(SP_RING_L, "step_ms",
                                            lambda r: r["ring"]),
            "loss": r0["ring"]["loss"], "dense_loss": refs["ring"],
            "loss_rel": max(rel(r["ring"]["loss"], refs["ring"])
                            for r in ranks),
            "grad_rel_max": max(r["ring"]["grad_rel_max"] for r in ranks),
            "dead_blocks_skipped": [r["ring"]["skipped"] for r in ranks],
            "block_steps": SP_LAYERS * SP_RANKS * SP_RANKS},
        "sp_tp": {
            "mesh": "sp=2,tp=2", "tokens": SP_RING_L, "forward_only": True,
            "forward_ms": [r["sp_tp"]["forward_ms"] for r in ranks],
            "warmup_ms": [r["sp_tp"]["warmup_ms"] for r in ranks],
            "loss": r0["sp_tp"]["loss"], "dense_loss": refs["ring"],
            "loss_rel": max(rel(r["sp_tp"]["loss"], refs["ring"])
                            for r in ranks)},
        "pipeline": {
            "mesh": f"pp={SP_RANKS}", "tokens": SP_PP_BATCH * SP_PP_SEQ,
            "microbatches": SP_PP_MICRO, "ticks": ticks,
            "bubble_share": (SP_RANKS - 1) / ticks,
            "dense_loss": refs["pipeline"],
            **{name: {
                "step_ms": [r["pipeline"][name]["step_ms"] for r in ranks],
                "warmup_ms": [r["pipeline"][name]["warmup_ms"]
                              for r in ranks],
                "tokens_per_sec_per_card": rate(
                    SP_PP_BATCH * SP_PP_SEQ, "step_ms",
                    lambda r, name=name: r["pipeline"][name]),
                "loss": r0["pipeline"][name]["loss"],
                "loss_rel": max(rel(r["pipeline"][name]["loss"],
                                    refs["pipeline"]) for r in ranks),
                "grad_rel_max": max(
                    max(r["pipeline"][name]["rest_grad_rel_max"],
                        r["pipeline"][name]["stage_grad_rel_max"])
                    for r in ranks)}
               for name in ("stored", "remat")}},
        "caveat": SP_CAVEAT if r0["backend"] == "gloo" else None,
    }
    res["kernel_check_s"] = check_s
    res["references_s"] = refs_s
    res["rank_seconds"] = [r["seconds"] for r in ranks]
    res["phase_s"] = time.perf_counter() - t0
    u, g = res["ulysses"], res["ring"]
    log(f"sp: {SP_RANKS} ranks over {res['backend']} on {cards} card(s): "
        f"ulysses loss rel {u['loss_rel']:.2e}, grad rel "
        f"{u['grad_rel_max']:.2e}, K1-K3 {u['launches'][0]} a rank, step "
        f"ms {max(u['step_ms']):.1f}; ring loss rel {g['loss_rel']:.2e}, "
        f"grad rel {g['grad_rel_max']:.2e}, dead blocks "
        f"{g['dead_blocks_skipped']}; sp=2,tp=2 loss rel "
        f"{res['sp_tp']['loss_rel']:.2e}; pipeline loss rel "
        f"{res['pipeline']['stored']['loss_rel']:.2e} / "
        f"{res['pipeline']['remat']['loss_rel']:.2e}; phase passed in "
        f"{res['phase_s']:.1f} s")
    return res


EP_RANKS = 4
EP_TIMEOUT_S = 600.0
# The MoE LM at Switch-base-8's widths (Fedus et al. 2021, the public
# google/switch-base-8 config): d_model 768, 12 heads of 64, d_ff 3072,
# 8 experts (2 a rank), with the repo's vocab and every block an MoE
# block; one sequence of 1024 tokens a rank. Capacity factor 8.0 is
# drop-free (C = T_local), Switch's 1.25 drops.
EP_EXPERTS, EP_SEQ = 8, 1024
# The MoE LM's depth: 4 of Switch-base-8's 12 layers (the phase's depth
# cut, which pays toward phases 21 and 22; every check is kept, at this
# depth, two all-to-alls a layer).
EP_LAYERS = 4
EP_CF_FREE, EP_CF_SWITCH = 8.0, 1.25
EP_STEPS, EP_LR, EP_AUX_W = 3, 0.05, 0.01
# The ep step adds the dense step's float32 terms in another order
# (attention and the MoE's einsums are per token; the replicated
# gradients are averaged over 4 ranks): logits and loss move by a few
# 1e-7 relative, a gradient leaf by far less than 1e-4 of its largest
# entry, where a token routed to the wrong expert or a gradient summed
# twice moves them by whole factors.
EP_LOSS_RTOL = 1e-5
EP_LOGIT_RTOL = 1e-5
EP_GRAD_RTOL = 1e-4
EP_CAVEAT = ("4 ranks share one card over gloo: each collective stages "
             "its CUDA tensors through host memory and loopback TCP, so "
             "the step times are those of host copies and sockets, not of "
             "NVLink")


def _ep_tokens(np):
    return np.random.default_rng(19).integers(0, VOCAB, (EP_RANKS, EP_SEQ))


def _ep_params(torch, dev):
    from horovod_tpu_torch.models import parallel_lm as plm

    return plm.init_moe_lm_params(3, VOCAB, EP_SEQ, EP_LAYERS, HEADS,
                                  HEAD_DIM, FFN, EP_EXPERTS, device=dev)


def _ep_references(torch, np, out):
    """The dense references the ranks are held to, on the card in this
    process before the world starts, saved under ``out`` as CPU tensors
    (the ranks read them back memory mapped): the weights; for each
    rank, ``lm_apply_moe(ep=None)`` over its own tokens at Switch's
    capacity factor (logits and routing); and the drop-free step,
    ``lm_apply_moe(ep=None)`` over all ranks' tokens at capacity factor
    8.0 (logits and gradients). Returns the drop-free loss."""
    import os

    from horovod_tpu_torch.models import parallel_lm as plm

    params = _ep_params(torch, "cuda")
    torch.save(_sp_tree(lambda t: t.cpu(), params),
               os.path.join(out, "params.pt"))
    toks = torch.tensor(_ep_tokens(np), device="cuda")
    routes, drops = [], []
    with torch.no_grad(), _routing_log(torch, routes):
        for r in range(EP_RANKS):
            drops.append(plm.lm_apply_moe(
                params, toks[r:r + 1], capacity_factor=EP_CF_SWITCH)[0].cpu())
    torch.save({"logits": torch.cat(drops), "routes": [
        [x.cpu() for x in routes[r * EP_LAYERS:(r + 1) * EP_LAYERS]]
        for r in range(EP_RANKS)]}, os.path.join(out, "dropping.pt"))
    del drops
    params = _sp_trainable(params)
    logits, _ = plm.lm_apply_moe(params, toks, capacity_factor=EP_CF_FREE)
    loss = plm.next_token_nll(logits, toks)
    loss.backward()
    torch.save(logits.detach().cpu(), os.path.join(out, "logits.pt"))
    torch.save(_sp_tree(lambda t: t.grad.cpu(), params),
               os.path.join(out, "grads.pt"))
    loss = float(loss.detach())
    del params, logits, toks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return loss


def _rel(a, b):
    """``max |a - b|`` over ``max |b|``."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _ep_collectives(torch, np, hvd, dev):
    """Every collective of the port through ``spmd_run`` on CUDA tensors
    against the closed form of its tests/test_collectives.py case; the
    largest relative error of each (0 where the result is exact) and the
    tolerance it is held to."""
    from horovod_tpu_torch.parallel import P

    n = hvd.size()
    whole = dict(out_specs=P("hvd"), host_local=False)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    res = {}

    def held(name, got, want, tol=1e-6):
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        check(len(got) == len(want)
              and all(g.is_cuda and tuple(g.shape) == tuple(w.shape)
                      for g, w in zip(got, want)),
              f"ep: {name}: {[tuple(g.shape) for g in got]} on "
              f"{[str(g.device) for g in got]}, expected "
              f"{[tuple(w.shape) for w in want]} on the card")
        err = max(_rel(g.double(), t(w, torch.float64))
                  for g, w in zip(got, want))
        check(err <= tol, f"ep: {name} off by {err:.2e} (> {tol})")
        res[name] = {"rel_err": err, "tol": tol}

    base = np.arange(60).reshape(3, 4, 5)
    tri = n * (n + 1) // 2
    for dt, tdt in (("float32", torch.float32), ("int32", torch.int32)):
        b = t(base, tdt)
        out = hvd.spmd_run(lambda: hvd.allreduce(b * (hvd.rank() + 1),
                                                 average=False))
        check(out.dtype == tdt, f"ep: allreduce {dt} came back {out.dtype}")
        held(f"allreduce_sum_{dt}", out, base * tri)
    held("allreduce_average", hvd.spmd_run(lambda: hvd.allreduce(
        torch.ones(4, 4, device=dev) * hvd.rank())),
        np.full((4, 4), (n - 1) / 2))
    held("allreduce_min_max", hvd.spmd_run(lambda: [hvd.allreduce(
        torch.ones(2, 2, device=dev) * hvd.rank(), op=op)
        for op in (hvd.Min, hvd.Max)]),
        [np.zeros((2, 2)), np.full((2, 2), n - 1.0)])
    rng = np.random.RandomState(0)
    for name, comp, tol in (("fp16", hvd.Compression.fp16, 1e-2),
                            ("bf16", hvd.Compression.bf16, 2e-2)):
        x = rng.rand(17, 3).astype(np.float32)
        out = hvd.spmd_run(lambda: hvd.allreduce(t(x), compression=comp))
        check(out.dtype == torch.float32, f"ep: {name} came back "
              f"{out.dtype}")
        held(f"allreduce_{name}", out, x, tol)
    held("allgather", hvd.spmd_run(lambda: hvd.allgather(
        torch.ones(2, 3, device=dev) * hvd.rank())),
        np.repeat(np.arange(n), 2)[:, None] * np.ones((1, 3)))
    g, c = hvd.spmd_run(lambda: hvd.allgatherv(
        torch.ones(8, 2, device=dev) * hvd.rank(), hvd.rank() + 1, 8))
    check(c.tolist() == list(range(1, n + 1)), f"ep: allgatherv counts "
          f"{c.tolist()}")
    held("allgatherv", [g[8 * r:8 * r + r + 1] for r in range(n)],
         [np.full((r + 1, 2), float(r)) for r in range(n)])
    for root in (0, n - 1):
        held(f"broadcast_root{root}", hvd.spmd_run(lambda: hvd.broadcast(
            torch.full((3, 3), 10.0, device=dev) * (hvd.rank() + 1),
            root_rank=root)), np.full((3, 3), 10.0 * (root + 1)))
    out = hvd.spmd_run(lambda: hvd.broadcast(
        t([hvd.rank() % 2 == 0, True], torch.bool), root_rank=1))
    check(out.dtype == torch.bool and out.tolist() == [False, True],
          f"ep: broadcast of bools from rank 1 gave {out.tolist()}")
    res["broadcast_bool"] = {"rel_err": 0.0, "tol": 0.0}
    held("alltoall", hvd.spmd_run(lambda: hvd.alltoall(
        torch.ones(n, 4, device=dev) * hvd.rank()), **whole),
        np.tile(np.arange(n), n)[:, None] * np.ones((1, 4)))
    held("reducescatter", hvd.spmd_run(lambda: hvd.reducescatter(
        torch.ones(2 * n, 2, device=dev) * hvd.rank(), average=False),
        **whole), np.full((2 * n, 2), n * (n - 1) / 2))
    outs = hvd.spmd_run(lambda: hvd.grouped_allreduce(
        [torch.ones(4, device=dev), t(np.ones(4), torch.int32),
         torch.ones(5, device=dev) * (hvd.rank() + 1)], average=False))
    check(outs[1].dtype == torch.int32, "ep: grouped_allreduce int32 leaf "
          f"came back {outs[1].dtype}")
    held("grouped_allreduce_mixed", outs,
         [np.full(4, n), np.full(4, n), np.full(5, tri)])
    idx, vals = hvd.spmd_run(lambda: hvd.allreduce_sparse(
        t([hvd.rank(), 0], torch.long),
        torch.ones(2, 3, device=dev) * (hvd.rank() + 1), average=False))
    held("allreduce_sparse", [idx, vals],
         [np.stack([np.arange(n), np.zeros(n, int)], 1).reshape(-1),
          np.repeat(np.arange(1, n + 1), 2)[:, None] * np.ones((1, 3))])
    dense = np.zeros((n + 1, 3))
    for r in range(n):
        dense[r] += (r + 1) / n
        dense[0] += (r + 1) / n
    held("allreduce_sparse_dense", hvd.spmd_run(lambda: hvd.allreduce_sparse(
        t([hvd.rank(), 0], torch.long),
        torch.ones(2, 3, device=dev) * (hvd.rank() + 1),
        dense_rows=n + 1)), dense)

    def grad(x):
        x = x.clone().requires_grad_(True)
        y = hvd.allreduce(x * (hvd.rank() + 1), average=False)
        (g,) = torch.autograd.grad(y.sum(), x)
        return hvd.allgather(g[None])

    held("allreduce_gradient", hvd.spmd_run(grad, torch.ones(3, device=dev)),
         np.stack([np.full(3, n * (r + 1.0)) for r in range(n)]))
    held("rank_in_region", hvd.spmd_run(lambda: hvd.allgather(
        t([hvd.rank()], torch.int32))), np.arange(n))
    return res


@contextlib.contextmanager
def _spied(module, name, record):
    """``module.name`` wrapped for the block: each call's arguments and
    result go to ``record(args, result)``."""
    orig = getattr(module, name)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        record(args, out)
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _routing_log(torch, calls):
    """Logs each ``top1_routing`` call (``moe_layer`` and ``lm_apply_moe``
    call it through the module) into ``calls``: the expert of each token,
    -1 where it was dropped."""
    from horovod_tpu_torch.parallel import moe

    def record(args, out):
        d = out[0].sum(dim=2)
        calls.append(torch.where(d.sum(dim=1) > 0, d.argmax(dim=1), -1))

    return _spied(moe, "top1_routing", record)


def _wire_log(dist, sent):
    """Logs the bytes each ``all_to_all_single`` sends into ``sent``."""
    return _spied(dist, "all_to_all_single", lambda args, out: sent.append(
        args[1].numel() * args[1].element_size()))


def _ep_moe(torch, np, hvd, dev, rank, refdir, lap):
    """The MoE LM on this rank, on its shard of the saved weights: the
    drop-free ep step against the saved dense step, the dropping ep
    forward against the dense function over this rank's tokens, and
    EP_STEPS training steps; ``lap(name)`` after each."""
    import os

    import torch.distributed as dist

    from horovod_tpu_torch.models import parallel_lm as plm
    from horovod_tpu_torch.parallel import LogicalMesh, bind

    toks = torch.tensor(_ep_tokens(np)[rank:rank + 1], device=dev)
    specs = plm.moe_lm_param_specs(EP_LAYERS, "ep")
    shard = plm.params_to(plm.shard_lm_params(torch.load(
        os.path.join(refdir, "params.pt"), mmap=True), specs, EP_RANKS,
        rank), dev)
    drop_ref = torch.load(os.path.join(refdir, "dropping.pt"), mmap=True)
    ref_drop = drop_ref["logits"][rank:rank + 1].to(dev)
    ref_routes = [x.to(dev) for x in drop_ref["routes"][rank]]
    del drop_ref
    lap("params")
    out = {}
    lm = LogicalMesh.from_config(f"ep={EP_RANKS}")
    with bind(lm):
        # Drop-free: one warm-up and one timed forward and backward.
        shard = _sp_trainable(shard)
        state = {}

        def step():
            for x in _leaves(shard):
                x.grad = None
            state["sent"] = []
            with _wire_log(dist, state["sent"]):
                logits, _ = plm.lm_apply_moe(shard, toks, ep="ep",
                                             capacity_factor=EP_CF_FREE)
            loss = plm.next_token_nll(logits, toks)
            loss.backward()
            state["logits"] = logits.detach()
            return float(loss)

        loss, ms = _sp_time(torch, step)
        peak, warm_ms = _sp_time.peak, _sp_time.warm_ms
        grads, red_ms = _sp_time(torch, lambda: plm.moe_reduce_grads(
            _sp_tree(lambda t: t.grad, shard), "ep"), warm=False)
        lap("drop_free_steps")
        ref_logits = torch.load(os.path.join(refdir, "logits.pt"),
                                mmap=True)[rank:rank + 1].to(dev)
        logits_rel = _rel(state["logits"], ref_logits)
        del ref_logits
        ref = plm.shard_lm_params(torch.load(
            os.path.join(refdir, "grads.pt"), mmap=True), specs, EP_RANKS,
            rank)
        errs = [_rel(g, r.to(dev)) for g, r in zip(_leaves(grads),
                                                   _leaves(ref))]
        check(len(errs) == len(list(_leaves(ref))) > 0,
              f"ep: {len(errs)} gradient leaves")
        del ref, grads
        mean_loss = float(hvd.allreduce(torch.tensor(loss, device=dev)))
        cap = math.ceil(EP_SEQ * EP_CF_FREE / EP_EXPERTS)
        out["drop_free"] = {
            "capacity_factor": EP_CF_FREE, "capacity": cap,
            "loss": loss, "ep_mean_loss": mean_loss,
            "logits_rel": logits_rel, "grad_rel_max": max(errs),
            "step_ms": ms, "warmup_ms": warm_ms, "reduce_ms": red_ms,
            "peak_memory_bytes": peak,
            "all_to_all_bytes": state["sent"],
            "all_to_all_bytes_want": EP_EXPERTS * cap * D_MODEL * 4}
        torch.cuda.empty_cache()
        lap("drop_free_checks")

        # Dropping: Switch's capacity factor against the dense reference
        # over this rank's own tokens (the same capacity rule).
        routes = []
        with torch.no_grad(), _routing_log(torch, routes):
            logits, _ = plm.lm_apply_moe(shard, toks, ep="ep",
                                         capacity_factor=EP_CF_SWITCH)
        kept = sum(int((r >= 0).sum()) for r in routes)
        out["dropping"] = {
            "capacity_factor": EP_CF_SWITCH,
            "capacity": math.ceil(EP_SEQ * EP_CF_SWITCH / EP_EXPERTS),
            "routing_equal": len(routes) == len(ref_routes) == EP_LAYERS
            and all(bool((a == b).all()) for a, b in zip(routes,
                                                          ref_routes)),
            "logits_rel": _rel(logits, ref_drop),
            "dropped_share": 1 - kept / (EP_LAYERS * EP_SEQ)}
        del logits, ref_drop
        lap("dropping")

        # Training: SGD on nll + 0.01 x the ep-mean aux, inside spmd_run
        # (the allreduce carries the pmean's gradient).
        def train(p, t):
            for x in _leaves(p):
                x.grad = None
            logits, aux = plm.lm_apply_moe(p, t, ep="ep")
            loss = plm.next_token_nll(logits, t) + EP_AUX_W * hvd.allreduce(
                aux, average=True)
            loss.backward()
            g = plm.moe_reduce_grads(_sp_tree(lambda x: x.grad, p), "ep")
            with torch.no_grad():
                for x, gx in zip(_leaves(p), _leaves(g)):
                    x -= EP_LR * gx
            return float(loss)

        losses, step_ms = [], []
        for _ in range(EP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(hvd.spmd_run(train, shard, toks, mesh=lm,
                                       axis_name="ep"))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        out["training"] = {"losses": losses, "step_ms": step_ms,
                           "lr": EP_LR, "aux_weight": EP_AUX_W,
                           "capacity_factor": EP_CF_SWITCH}
        lap("training")
    return out


def ep_rank(argv):
    """``--ep-rank RANK WORLD PORT DIR``: one rank of the ep phase's
    world (its own card over NCCL when there are WORLD cards, else the
    first card over gloo): the collectives through ``spmd_run``, then the
    MoE LM against the dense references under ``DIR``. Prints
    ``EP_RESULT {json}`` last."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port = (int(a) for a in argv[:3])
    secs, t0 = {}, time.perf_counter()
    own = torch.cuda.device_count() >= world
    dev = torch.device("cuda", rank if own else 0)
    torch.cuda.set_device(dev)
    backend = "nccl" if own else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    import horovod_tpu_torch.distributed as hvd

    hvd.init(device=dev)
    out = {"rank": rank, "backend": backend, "device": str(dev),
           "seconds": secs}

    def lap(name):
        nonlocal t0
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    lap("setup")
    try:
        out["collectives"] = _ep_collectives(torch, np, hvd, dev)
        lap("collectives")
        _wait_ready(argv[3], EP_TIMEOUT_S)
        lap("wait_for_references")
        out.update(_ep_moe(torch, np, hvd, dev, rank, argv[3], lap))
    finally:
        hvd.shutdown()
        dist.destroy_process_group()
    print("EP_RESULT " + json.dumps(out), flush=True)


def ep_phase(torch, np, card):
    """Phase 15 (module docstring): expert parallelism and the SPMD
    harness's collectives in a 4-rank world, the MoE LM against the
    dense steps on the same weights."""
    import tempfile

    t0 = time.perf_counter()
    parent = {}

    def references(tmp):
        # While the ranks start and check the collectives.
        parent["loss"] = _ep_references(torch, np, tmp)
        parent["s"] = time.perf_counter() - t0
        _mark_ready(tmp)

    with tempfile.TemporaryDirectory() as tmp:
        ranks = _rank_world("--ep-rank", EP_RANKS, EP_TIMEOUT_S, tmp, "EP",
                            parent=lambda: references(tmp))
    dense_loss, refs_s = parent["loss"], parent["s"]
    r0 = ranks[0]
    for r in ranks:
        who = f"ep: rank {r['rank']}"
        f, d, tr = r["drop_free"], r["dropping"], r["training"]
        loss_rel = abs(f["ep_mean_loss"] - dense_loss) / abs(dense_loss)
        check(math.isfinite(f["loss"]) and loss_rel <= EP_LOSS_RTOL,
              f"{who}: drop-free ep-mean loss {f['ep_mean_loss']} against "
              f"the dense {dense_loss} (rel {loss_rel:.2e})")
        check(f["logits_rel"] <= EP_LOGIT_RTOL,
              f"{who}: drop-free logits off the dense ones by "
              f"{f['logits_rel']:.2e} of their largest entry")
        check(f["grad_rel_max"] <= EP_GRAD_RTOL,
              f"{who}: gradients after moe_reduce_grads differ from the "
              f"dense ones by up to {f['grad_rel_max']:.2e}")
        check(f["all_to_all_bytes"] == [f["all_to_all_bytes_want"]]
              * (2 * EP_LAYERS),
              f"{who}: a forward's all_to_all_single bytes "
              f"{f['all_to_all_bytes']}, expected 2 a layer of "
              f"{f['all_to_all_bytes_want']}")
        check(d["routing_equal"], f"{who}: the ep routing at capacity "
              f"factor {EP_CF_SWITCH} differs from the dense reference's")
        check(d["logits_rel"] <= EP_LOGIT_RTOL,
              f"{who}: dropping logits off the dense ones by "
              f"{d['logits_rel']:.2e}")
        check(0 < d["dropped_share"] < 1, f"{who}: dropped share "
              f"{d['dropped_share']} at capacity factor {EP_CF_SWITCH}")
        check(all(map(math.isfinite, tr["losses"]))
              and tr["losses"][-1] < tr["losses"][0],
              f"{who}: training losses {tr['losses']} do not fall")
    cards = max(1, min(torch.cuda.device_count(), EP_RANKS))
    step_ms = [r["drop_free"]["step_ms"] for r in ranks]
    train_ms = [r["training"]["step_ms"] for r in ranks]
    res = {
        "ranks": EP_RANKS, "backend": r0["backend"], "cards": cards,
        "card": card,
        "config": {"source": "google/switch-base-8 (Fedus et al. 2021): "
                             "d_model 768, 12 heads of 64, d_ff 3072, 8 "
                             "experts", "layers": EP_LAYERS, "vocab": VOCAB,
                   "experts": EP_EXPERTS, "experts_per_rank":
                   EP_EXPERTS // EP_RANKS, "moe_every_layer": True,
                   "tokens_per_rank": EP_SEQ, "dtype": "float32",
                   "tf32": False},
        "collectives": {name: max(r["collectives"][name]["rel_err"]
                                  for r in ranks)
                        for name in r0["collectives"]},
        "drop_free": {
            "capacity_factor": EP_CF_FREE,
            "capacity": r0["drop_free"]["capacity"],
            "dense_loss": dense_loss,
            "ep_mean_loss": r0["drop_free"]["ep_mean_loss"],
            "loss_rel": abs(r0["drop_free"]["ep_mean_loss"] - dense_loss)
            / abs(dense_loss),
            "logits_rel": max(r["drop_free"]["logits_rel"] for r in ranks),
            "grad_rel_max": max(r["drop_free"]["grad_rel_max"]
                                for r in ranks),
            "step_ms": step_ms,
            "warmup_ms": [r["drop_free"]["warmup_ms"] for r in ranks],
            "reduce_ms": [r["drop_free"]["reduce_ms"] for r in ranks],
            "tokens_per_sec_per_card": EP_RANKS * EP_SEQ
            / (max(step_ms) / 1e3) / cards,
            "peak_memory_bytes": [r["drop_free"]["peak_memory_bytes"]
                                  for r in ranks],
            "all_to_all_bytes_per_layer":
                2 * r0["drop_free"]["all_to_all_bytes_want"]},
        "dropping": {
            "capacity_factor": EP_CF_SWITCH,
            "capacity": r0["dropping"]["capacity"],
            "routing_equal": all(r["dropping"]["routing_equal"]
                                 for r in ranks),
            "logits_rel": max(r["dropping"]["logits_rel"] for r in ranks),
            "dropped_share": [r["dropping"]["dropped_share"]
                              for r in ranks]},
        "training": {
            "steps": EP_STEPS, "lr": EP_LR, "aux_weight": EP_AUX_W,
            "losses": [r["training"]["losses"] for r in ranks],
            "step_ms": train_ms,
            "tokens_per_sec_per_card": EP_RANKS * EP_SEQ
            / (max(ms[-1] for ms in train_ms) / 1e3) / cards},
        "caveat": EP_CAVEAT if r0["backend"] == "gloo" else None,
        "references_s": refs_s,
        "rank_seconds": [r["seconds"] for r in ranks],
    }
    res["phase_s"] = time.perf_counter() - t0
    f = res["drop_free"]
    log(f"ep: {EP_RANKS} ranks over {res['backend']} on {cards} card(s): "
        f"{len(res['collectives'])} collectives checked; drop-free loss "
        f"rel {f['loss_rel']:.2e}, logits rel {f['logits_rel']:.2e}, grad "
        f"rel {f['grad_rel_max']:.2e}, step ms {max(step_ms):.1f}; "
        f"dropping routing equal, logits rel "
        f"{res['dropping']['logits_rel']:.2e}, dropped "
        f"{res['dropping']['dropped_share']}; training losses "
        f"{res['training']['losses'][0]}; phase passed in "
        f"{res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ phase 16


JOB_RANKS = 2
# Each rank's batch: 4 sequences of the training width's length, from
# its own seed.
JOB_SEQS = 4
JOB_STEPS = 3
# The job's LM: the training width, 2 of its 12 layers (the phase's depth
# cut, which pays toward phases 13b, 21 and 22).
JOB_LAYERS = 2
JOB_SEED = 16
JOB_LR = 1e-4
JOB_DEVICE = "cuda"
JOB_TIMEOUT_S = 600.0
# Step 1's averaged gradient against the mean of the two ranks' local
# gradients, each computed on rank 0 with no collective: the same
# kernels on the same inputs, so the two differ by the rounding of the
# bf16 sum of the exchange (at most one bf16 ulp, 2^-7 of the largest
# entry of a leaf); a wrong or missing average is off by whole gradients.
JOB_GRAD_RTOL = 2.0 ** -7
JOB_COMM = [0, 2]
JOB_COMM_WORLD = 4
JOB_CAVEAT = ("2 ranks share one card over gloo: each collective stages "
              "through the host, so the step ms measure host copies, not "
              "a fabric")


def _job_tokens(np, rank):
    rng = np.random.default_rng(JOB_SEED + 100 + rank)
    return rng.integers(0, VOCAB, (JOB_SEQS, FLASH_L))


def _job_digest(torch, model):
    """SHA-256 of every parameter's bytes, in order: equal digests are
    bit-identical parameters."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def job_task():
    """One rank of the job phase, started by ``horovod_tpu_torch.run.run``
    and run from this module imported as ``chip_smoke`` (its functions
    pickle by reference). The world comes from the launcher's
    environment: its own card over NCCL when there is one a rank, else
    a gloo group on the first card. GPT-2-small at the training width on
    the flash kernels: ``hvd.value_and_grad`` over
    ``torch.func.functional_call``, ``allreduce_gradients_transform``,
    Adam, JOB_STEPS steps on the rank's own fixed batch."""
    import functools
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import (fused_reduce,
                                                      resolve_overlap)
    from horovod_tpu_torch.models.train import next_token_loss
    from horovod_tpu_torch.ops import attention as fa

    entered = time.time()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    on_card = JOB_DEVICE == "cuda"
    own = on_card and torch.cuda.device_count() >= world
    dev = (torch.device("cuda", int(os.environ["LOCAL_RANK"]) if own else 0)
           if on_card else torch.device("cpu"))
    if on_card:
        torch.cuda.set_device(dev)
    if not own:
        dist.init_process_group("gloo", init_method="env://")
    hvd.init(device=dev)
    check(hvd.size() == world and hvd.rank() == rank,
          f"job: rank {rank}: hvd sees rank {hvd.rank()} of {hvd.size()}")
    flash = functools.partial(fa.flash_attention, causal=True,
                              bwd_impl="kernel")
    from horovod_tpu_torch.models.transformer import TransformerLM

    # Each rank draws other weights; the broadcast gives every rank
    # rank 0's (seed JOB_SEED).
    model = TransformerLM(vocab_size=VOCAB, num_layers=JOB_LAYERS,
                          num_heads=HEADS, embed_dim=D_MODEL,
                          max_len=FLASH_L, dtype=torch.bfloat16,
                          attn_fn=flash, seed=JOB_SEED + rank, device=dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "entered": entered, "digests": [_job_digest(torch, model)]}
    tokens = torch.tensor(_job_tokens(np, rank), device=dev)

    def loss_fn(params, toks):
        logits = torch.func.functional_call(model, params, (toks,))
        return next_token_loss(logits, toks)

    mean = None
    if rank == 0:
        # Every rank's local gradient of step 1, here, with no
        # collective: plain autograd over the broadcast weights.
        local = []
        for r in range(world):
            toks = torch.tensor(_job_tokens(np, r), device=dev)
            model.zero_grad(set_to_none=True)
            next_token_loss(model(toks), toks).backward()
            local.append({n: p.grad.float() for n, p in
                          model.named_parameters()})
        model.zero_grad(set_to_none=True)
        mean = {n: sum(g[n] for g in local) / world for n in local[0]}
        del local
    params = {n: p.detach() for n, p in model.named_parameters()}
    vg = hvd.value_and_grad(loss_fn)
    tx = hvd.allreduce_gradients_transform()
    state = tx.init(params)
    opt = torch.optim.Adam(model.parameters(), lr=JOB_LR)
    # The transform's leaf order: JAX's, a dict's keys sorted. Under
    # overlap (auto: two buckets or more) a bucket past the scatter
    # threshold is a reduce-scatter and an all-gather, else one
    # all-reduce.
    cfg = basics.config()
    plan = hvd.plan_buckets([params[n] for n in sorted(params)],
                            cfg.fusion_threshold)
    scatter = resolve_overlap(None, len(plan)) and world > 1
    per_exchange = sum(
        2 if scatter and b.nbytes >= cfg.overlap_scatter_threshold else 1
        for b in plan)
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    if on_card:
        torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    fused_reduce.collectives = 0
    losses, step_ms = [], []
    for s in range(JOB_STEPS):
        t0 = time.perf_counter()
        loss, grads = vg(params, tokens)
        if s == 0 and mean is not None:
            errs = [float((grads[n].float() - mean[n]).abs().max()
                          / mean[n].abs().max().clamp(min=1e-30))
                    for n in mean]
            out["grad_rel_max"] = max(errs)
            del mean
        grads, state = tx.update(grads, state, params)
        for n, p in model.named_parameters():
            p.grad = grads[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
        if on_card:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out["digests"].append(_job_digest(torch, model))
    out.update({
        "losses": losses, "step_ms": step_ms, "buckets": len(plan),
        "exchange_collectives": per_exchange,
        "launches": {k.__name__: k.launches for k in kernels},
        "collectives": fused_reduce.collectives,
        "residuals": len(state.residuals),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_card else 0)})
    hvd.shutdown()
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


def comm_rank(argv):
    """``--comm-rank DIR``: one rank of the job phase's ``init(comm=)``
    world, started by ``launch_job``: a gloo group on the first card,
    then ``hvd.init(comm=JOB_COMM)``; writes ``DIR/rank<R>.json``."""
    import os

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError

    rank = int(os.environ["RANK"])
    dev = torch.device(JOB_DEVICE, 0) if JOB_DEVICE == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="env://")
    out = {"rank": rank}
    try:
        hvd.init(comm=JOB_COMM, device=dev)
    except InvalidArgumentError as e:
        out["excluded"] = str(e)
    else:
        t = hvd.allreduce(torch.ones(4, device=dev), average=False)
        out.update({"size": hvd.size(), "job_rank": hvd.rank(),
                    "allreduce": t.tolist(),
                    "on_card": t.device.type == dev.type})
        hvd.shutdown()
    # Every rank of the world, in the job or not, leaves together.
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(argv[0], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _job_cli(torch):
    """The launcher's CLI and fail-fast supervision: a relaunch under
    ``--restarts``, a crashed rank classified, and the elastic flags
    (:func:`_elastic_cli`)."""
    import os
    import tempfile

    from horovod_tpu_torch.run import launch_job

    env = dict(os.environ, OMP_NUM_THREADS="1")
    cli = [sys.executable, "-m", "horovod_tpu_torch.run"]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        marker = os.path.join(tmp, "attempted")
        script = ("import os, sys; m = sys.argv[1]\n"
                  "if os.environ['HOROVOD_RANK'] == '0' and not "
                  "os.path.exists(m):\n"
                  "    open(m, 'w').close(); sys.exit(7)\n")
        t0 = time.perf_counter()
        p = subprocess.run(cli + ["-np", "2", "--restarts", "1", "--",
                                  sys.executable, "-c", script, marker],
                           env=env, capture_output=True, text=True,
                           timeout=120)
        res["restarts"] = {"rc": p.returncode,
                           "relaunches": p.stderr.count("relaunching"),
                           "seconds": time.perf_counter() - t0}
        check(p.returncode == 0 and res["restarts"]["relaunches"] == 1
              and os.path.exists(marker),
              f"job: --restarts 1 over a first-attempt failure gave rc "
              f"{p.returncode} after {res['restarts']['relaunches']} "
              f"relaunches: {p.stderr[-2000:]}")
    t0 = time.perf_counter()
    jr = launch_job([sys.executable, "-c",
                     "import os, sys, time\n"
                     "if os.environ['HOROVOD_RANK'] == '1': sys.exit(1)\n"
                     "time.sleep(120)"], np=2, env=env)
    res["fail_fast"] = {"trigger_rank": jr.trigger.rank if jr.trigger
                        else None, "category": jr.category,
                        "exit_codes": jr.exit_codes,
                        "teardown_s": jr.teardown_s,
                        "seconds": time.perf_counter() - t0}
    check(jr.trigger is not None and jr.trigger.rank == 1
          and jr.category == "crashed" and jr.pre_kill_codes == {1: 1}
          and res["fail_fast"]["seconds"] < 60,
          f"job: the fail-fast job gave {jr.describe()} in "
          f"{res['fail_fast']['seconds']:.1f} s")
    res["elastic_cli"] = _elastic_cli()
    return res


def _job_comm():
    """``init(comm=JOB_COMM)`` in a JOB_COMM_WORLD-rank world started by
    ``launch_job``, every rank a process of this script."""
    import os
    import tempfile

    from horovod_tpu_torch.run import launch_job

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        jr = launch_job([sys.executable, os.path.join(here, "chip_smoke.py"),
                         "--comm-rank", tmp], np=JOB_COMM_WORLD,
                        env=dict(os.environ, OMP_NUM_THREADS="1"))
        seconds = time.perf_counter() - t0
        check(jr.trigger is None, f"job: the comm world failed: "
              f"{jr.describe()}")
        ranks = []
        for r in range(JOB_COMM_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r in ranks:
        if r["rank"] in JOB_COMM:
            want = {"size": len(JOB_COMM),
                    "job_rank": JOB_COMM.index(r["rank"]),
                    "allreduce": [float(len(JOB_COMM))] * 4,
                    "on_card": True}
            check({k: r.get(k) for k in want} == want,
                  f"job: comm rank {r['rank']} gave {r}, expected {want}")
        else:
            check("does not include this process" in r.get("excluded", ""),
                  f"job: rank {r['rank']} outside comm gave {r}")
    return {"comm": JOB_COMM, "world": JOB_COMM_WORLD, "ranks": ranks,
            "seconds": seconds}


def job_phase(torch, np, card):
    """Phase 16 (module docstring): the Horovod job through the port's
    launcher: the training job of ``run()``, the CLI and the comm
    subset."""
    import chip_smoke
    from horovod_tpu_torch.run import run

    t0 = time.perf_counter()
    started = time.time()
    ranks = run(chip_smoke.job_task, np=JOB_RANKS, start_timeout=120.0,
                run_timeout=JOB_TIMEOUT_S)
    train_s = time.perf_counter() - t0
    r0 = ranks[0]
    plan, per_exchange = r0["buckets"], r0["exchange_collectives"]
    for r in ranks:
        who = f"job: rank {r['rank']}"
        check(all(map(math.isfinite, r["losses"]))
              and r["losses"][-1] < r["losses"][0],
              f"{who}: losses {r['losses']} are not finite and falling")
        check(r["digests"] == r0["digests"],
              f"{who}: parameters differ from rank 0's after the "
              f"broadcast or a step ({r['digests']} vs {r0['digests']})")
        for name, n in r["launches"].items():
            check(JOB_DEVICE != "cuda" or n == JOB_LAYERS * JOB_STEPS,
                  f"{who}: {name} launched {n} times, expected {JOB_LAYERS} "
                  f"layers x {JOB_STEPS} passes")
        # value_and_grad's exchange and the transform's, each a step.
        check(r["collectives"] == 2 * per_exchange * JOB_STEPS,
              f"{who}: {r['collectives']} bucket collectives, expected 2 "
              f"exchanges of {per_exchange} ({plan} buckets) x "
              f"{JOB_STEPS} steps")
        check(r["residuals"] == 0, f"{who}: residuals without a ladder")
    check(r0["grad_rel_max"] <= JOB_GRAD_RTOL,
          f"job: step 1's averaged gradient is off the mean of the local "
          f"ones by {r0['grad_rel_max']:.3e} of a leaf's largest entry "
          f"(tolerance {JOB_GRAD_RTOL:.3e})")
    cli = _job_cli(torch)
    comm = _job_comm()
    cards = max(1, min(torch.cuda.device_count(), JOB_RANKS)) \
        if JOB_DEVICE == "cuda" else 0
    step_ms = [r["step_ms"] for r in ranks]
    res = {
        "ranks": JOB_RANKS, "backend": r0["backend"], "cards": cards,
        "card": card,
        "model": {"layers": JOB_LAYERS, "d_model": D_MODEL, "heads": HEADS,
                  "vocab": VOCAB, "seq": FLASH_L, "seqs_per_rank": JOB_SEQS,
                  "dtype": "bfloat16", "attention": "flash (K1-K3)"},
        "losses": [r["losses"] for r in ranks],
        "step_ms": step_ms,
        "tokens_per_sec_per_card": JOB_RANKS * JOB_SEQS * FLASH_L
        / (max(ms[-1] for ms in step_ms) / 1e3) / max(cards, 1),
        "grad_rel_max": r0["grad_rel_max"], "grad_rtol": JOB_GRAD_RTOL,
        "params_bit_identical_steps": len(r0["digests"]) - 1,
        "launches": [r["launches"] for r in ranks],
        "collectives": [r["collectives"] for r in ranks],
        "buckets": plan, "exchange_collectives": per_exchange,
        "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
        "spawn_to_task_s": [r["entered"] - started for r in ranks],
        "run_s": train_s,
        "restarts": cli["restarts"], "fail_fast": cli["fail_fast"],
        "elastic_cli": cli["elastic_cli"],
        "comm_subset": comm,
        "caveat": JOB_CAVEAT if r0["backend"] == "gloo" else None,
    }
    res["phase_s"] = time.perf_counter() - t0
    log(f"job: {JOB_RANKS} ranks over {res['backend']} on {cards} card(s) "
        f"through run(): losses {res['losses'][0]}, step ms "
        f"{[[round(x, 1) for x in ms] for ms in step_ms]}, grad rel "
        f"{res['grad_rel_max']:.2e}, launches {r0['launches']}, "
        f"{r0['collectives']} collectives ({plan} buckets, "
        f"{per_exchange} an exchange); spawn-to-task "
        f"s {[round(x, 2) for x in res['spawn_to_task_s']]}; restarts "
        f"{cli['restarts']['relaunches']}, fail-fast teardown "
        f"{cli['fail_fast']['teardown_s']:.3f} s; comm {JOB_COMM} of "
        f"{JOB_COMM_WORLD} ok; phase passed in {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ phase 17


ELASTIC_RANKS = 2
# The elastic jobs' LM: the training width, 2 of its 12 layers (the
# phase's depth cut, which pays toward phases 13b, 21 and 22; the phase
# starts five ranks at once; each draws and steps its own copy).
ELASTIC_LAYERS = 2
# Part (a): 2 sequences a rank a step over 2 ranks; part (b): 8 on one.
ELASTIC_SEQS = 2
ELASTIC_WIN_SEQS = 8
ELASTIC_STEPS = 4
ELASTIC_EVERY = 2
ELASTIC_WINDOW = 2
ELASTIC_SEED = 17
ELASTIC_LR = 1e-4
ELASTIC_DEVICE = "cuda"
ELASTIC_TIMEOUT_S = 600.0
ELASTIC_KILL = "kill:rank=1,step=3"
ELASTIC_PREEMPT = "preempt:rank=0,step=2"
ELASTIC_CAVEAT = ("2 ranks share one card over gloo: each collective "
                  "stages through the host, so the step ms measure host "
                  "copies, not a fabric")


def _elastic_tokens(np, seqs):
    """Every rank's sequences for all the steps, from one seed: the
    ShardedBatchSource cuts them into shards."""
    n = seqs * ELASTIC_RANKS * ELASTIC_STEPS
    return np.random.default_rng(ELASTIC_SEED).integers(
        0, VOCAB, (n, FLASH_L))


def _elastic_digest(torch, state):
    """SHA-256 over every state leaf's bytes, in the JAX package's leaf
    order: equal digests are bit-identical states."""
    import hashlib

    from horovod_tpu_torch._pytree import flatten

    h = hashlib.sha256()
    for leaf in flatten(state)[0]:
        h.update(leaf.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _elastic_model(torch, dev, attn_fn, seed=ELASTIC_SEED, layers=LAYERS):
    """GPT-2-small at the training width, its weights drawn on the card
    from ``seed`` by torch's generator at the LM's own scales (the same
    on every rank and attempt): the LM's numpy draws of 136M
    weights take ~6 s a process on the host, 15-20 s with five rank
    processes starting at once."""
    import math

    from torch import nn

    from horovod_tpu_torch.models.transformer import TransformerLM

    class OnCard(TransformerLM):
        def _init_weights(self, seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            with torch.no_grad():
                for mod in self.modules():
                    if isinstance(mod, nn.Embedding):
                        mod.weight.normal_(
                            0.0, 1.0 / math.sqrt(mod.num_embeddings),
                            generator=g)
                    elif isinstance(mod, nn.Linear):
                        mod.weight.normal_(
                            0.0, 1.0 / math.sqrt(mod.in_features),
                            generator=g)
                        if mod.bias is not None:
                            mod.bias.zero_()
                    elif hasattr(mod, "scale"):       # the LM's LayerNorm
                        mod.scale.fill_(1.0)
                        mod.bias.zero_()

    return OnCard(vocab_size=VOCAB, num_layers=layers, num_heads=HEADS,
                  embed_dim=D_MODEL, max_len=FLASH_L, dtype=torch.bfloat16,
                  attn_fn=attn_fn, seed=seed, device=dev)


def _elastic_lm(torch, np, dev, seqs, rank, size):
    """GPT-2-small at the training width, ``ELASTIC_LAYERS`` deep, on
    K1-K3, as a functional step
    over a state pytree: ``(state, step_fn, source)``. The state is
    ``{"params", "m", "v", "step"}`` (the LM's float32 weights, bf16
    compute, and Adam's moments of the weights' dtype);
    the step is ``hvd.value_and_grad`` over ``torch.func.functional_call``,
    ``allreduce_gradients_transform`` and a functional Adam on dicts
    (``torch.optim.Adam`` makes its state at the first step, so it gives
    no restore template before it)."""
    import functools

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.models.train import next_token_loss
    from horovod_tpu_torch.ops import attention as fa

    model = _elastic_model(torch, dev, functools.partial(
        fa.flash_attention, causal=True, bwd_impl="kernel"),
        layers=ELASTIC_LAYERS)
    params = {n: p.detach() for n, p in model.named_parameters()}
    state = {"params": params,
             "m": {n: torch.zeros_like(p) for n, p in params.items()},
             "v": {n: torch.zeros_like(p) for n, p in params.items()},
             "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def loss_fn(p, toks):
        return next_token_loss(
            torch.func.functional_call(model, p, (toks,)), toks)

    vg = hvd.value_and_grad(loss_fn)
    tx = hvd.allreduce_gradients_transform()
    tx_state = tx.init(params)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step_fn(st, batch):
        toks = batch["tokens"].to(dev, non_blocking=True)
        loss, grads = vg(st["params"], toks)
        grads, _ = tx.update(grads, tx_state, st["params"])
        t = (st["step"] + 1).float()
        c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        new = {"params": {}, "m": {}, "v": {}, "step": st["step"] + 1}
        for n, p in st["params"].items():
            g = grads[n].float()
            m = st["m"][n].float() * b1 + g * (1 - b1)
            v = st["v"][n].float() * b2 + g * g * (1 - b2)
            upd = (m / c1) / ((v / c2).sqrt() + eps)
            new["params"][n] = (p.float() - ELASTIC_LR * upd).to(p.dtype)
            new["m"][n] = m.to(p.dtype)
            new["v"][n] = v.to(p.dtype)
        return new, {"loss": loss}

    source = elastic.ShardedBatchSource(
        {"tokens": _elastic_tokens(np, seqs)}, batch_size=seqs, rank=rank,
        size=size, shuffle=False, seed=ELASTIC_SEED)
    return state, step_fn, source


def elastic_rank(argv):
    """``--elastic-rank MODE OUT CKPT``: one rank of the elastic phase,
    started by ``hvdrun-torch --elastic``. ``MODE`` ``dp``: part (a),
    ELASTIC_SEQS sequences a step, plain steps, over gloo on the card
    when the ranks share it; ``win``: part (b), one rank, ELASTIC_WIN_SEQS
    sequences, windows of ELASTIC_WINDOW captured steps over NCCL. It
    appends ``attempt step repr(loss) captured K1 K2 K3`` (the step
    calls made while a graph captured, and the kernels' launches) to
    ``OUT/rank<R>.traj`` after every window and writes
    ``OUT/rank<R>.a<ATTEMPT>.json`` at the end. On the card only."""
    import os

    entered = time.time()
    mode, out_dir, ckpt_dir = argv[:3]
    import numpy as np
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.ops import attention as fa

    marks = {"imports": time.time()}
    if ELASTIC_DEVICE == "cuda" and not torch.cuda.is_available():
        raise SmokeFailure("elastic: --elastic-rank runs on the card and "
                           "there is none")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    attempt = int(os.environ["HOROVOD_ELASTIC_RESTART"])
    on_card = ELASTIC_DEVICE == "cuda"
    own = on_card and torch.cuda.device_count() >= world
    dev = (torch.device("cuda", int(os.environ["LOCAL_RANK"]) if own else 0)
           if on_card else torch.device("cpu"))
    if on_card:
        torch.cuda.set_device(dev)
    if not own:
        dist.init_process_group("gloo", init_method="env://")
    hvd.init(device=dev)
    marks["init"] = time.time()
    seqs = ELASTIC_SEQS if mode == "dp" else ELASTIC_WIN_SEQS
    k = 1 if mode == "dp" else ELASTIC_WINDOW
    state, step_fn, source = _elastic_lm(torch, np, dev, seqs, rank, world)
    marks["model"] = time.time()
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kern in kernels:
        kern.launches = 0
    first = {}
    step_ms = []
    captured = [0]

    def timed_step(st, batch):
        first.setdefault("t", time.time())
        if on_card and torch.cuda.is_current_stream_capturing():
            captured[0] += 1
        return step_fn(st, batch)

    os.makedirs(out_dir, exist_ok=True)
    traj = open(os.path.join(out_dir, f"rank{rank}.traj"), "a")
    last = [time.perf_counter()]

    def on_step(step, metrics):
        loss = float(metrics["loss"])         # syncs the window
        now = time.perf_counter()
        step_ms.append((now - last[0]) * 1e3 / k)
        last[0] = now
        traj.write(f"{attempt} {step} {loss!r} {captured[0]} "
                   + " ".join(str(kern.launches) for kern in kernels)
                   + "\n")
        traj.flush()

    # One directory for the job: the manager is collective over the
    # world (every process writes its own shard, process 0 commits the
    # step once all have landed), so each rank restores its own shard.
    manager = CheckpointManager(ckpt_dir, backend="numpy")
    snap = elastic.Snapshotter(manager, every=ELASTIC_EVERY, spill_every=1)
    state, metrics, resumed = elastic.run_elastic(
        timed_step, state, source.batch_at, ELASTIC_STEPS,
        snapshotter=snap, steps_per_dispatch=k, on_step=on_step)
    traj.close()
    if on_card:
        torch.cuda.synchronize()
    rec = {"rank": rank, "attempt": attempt, "mode": mode,
           "backend": dist.get_backend(), "resumed": resumed,
           "steps_run": ELASTIC_STEPS - resumed,
           "digest": _elastic_digest(torch, state),
           "launches": {kern.__name__: kern.launches for kern in kernels},
           "captured_calls": captured[0], "step_ms": step_ms,
           "startup_s": {name: t - entered for name, t in
                         {**marks, "first_step": first.get("t", entered)}
                         .items()},
           "snapshot_stats": snap.stats,
           "state_bytes": sum(
               t.nbytes for t in torch.utils._pytree.tree_leaves(state)),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
           if on_card else 0}
    hvd.shutdown()
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.a{attempt}.json"),
              "w") as f:
        json.dump(rec, f)


def _elastic_start(tmp, tag, np_ranks, mode, fault, max_restarts):
    """Start one ``hvdrun-torch --elastic`` job of this script's
    ``--elastic-rank`` processes, its output to files under ``tmp``."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    job = {"tag": tag, "out": os.path.join(tmp, f"{tag}-out"),
           "metrics": os.path.join(tmp, f"{tag}-metrics.tsv"),
           "stderr": os.path.join(tmp, f"{tag}.err")}
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
           str(np_ranks), "--elastic", "--max-restarts", str(max_restarts),
           "--metrics-file", job["metrics"]]
    if fault:
        cmd += ["--fault-plan", fault]
    cmd += ["--", sys.executable, os.path.join(here, "chip_smoke.py"),
            "--elastic-rank", mode, job["out"],
            os.path.join(tmp, f"{tag}-ckpt")]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    with open(job["stderr"], "w") as err:
        job["proc"] = subprocess.Popen(cmd, env=env, cwd=here,
                                       stdout=subprocess.DEVNULL,
                                       stderr=err)
    job["t0"] = time.perf_counter()
    return job


def _elastic_stop(job):
    """Stop a job still running: SIGINT makes its launcher kill and reap
    its ranks (``launch_job``'s KeyboardInterrupt path), SIGKILL if it
    has not ended 30 s later."""
    p = job["proc"]
    if p.poll() is None:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _elastic_finish(job, deadline):
    """Wait for a started job: its rc, seconds, stderr and supervisor
    record; the job is stopped at the deadline."""
    import os

    p = job["proc"]
    try:
        p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        _elastic_stop(job)
        raise SmokeFailure(f"elastic: the {job['tag']} job ran past "
                           f"{ELASTIC_TIMEOUT_S:.0f} s")
    job["seconds"] = time.perf_counter() - job["t0"]
    job["rc"] = p.returncode
    with open(job["stderr"]) as f:
        job["err"] = f.read()
    check(job["rc"] == 0, f"elastic: the {job['tag']} job exited "
          f"{job['rc']}: {job['err'][-3000:]}")
    job["supervisor"] = None
    if os.path.exists(job["metrics"]):
        with open(job["metrics"]) as f:
            job["supervisor"] = json.loads(
                f.read().strip().split("\t", 2)[2])["elastic"]
    job["relaunches"] = job["err"].count("relaunching all")
    return job


def _elastic_ranks(out, ranks):
    """Each rank's records by attempt (a killed or preempted attempt
    writes none), its last-write-wins trajectory ``{step: repr(loss)}``,
    and each attempt's lines ``(step, K1-K3 launches, captured)``."""
    import os

    res = []
    for r in range(ranks):
        attempts = {}
        for name in sorted(os.listdir(out)):
            if name.startswith(f"rank{r}.a") and name.endswith(".json"):
                with open(os.path.join(out, name)) as f:
                    rec = json.load(f)
                attempts[rec["attempt"]] = rec
        traj, lines = {}, {}
        with open(os.path.join(out, f"rank{r}.traj")) as f:
            for line in f:
                a, step, loss, captured, *launches = line.split()
                traj[int(step)] = loss
                lines.setdefault(int(a), []).append(
                    (int(step), [int(x) for x in launches],
                     int(captured)))
        res.append({"attempts": attempts, "traj": traj, "lines": lines})
    return res


def _elastic_async(torch, np, state, step_fn, source):
    """Part (c): the async snapshot under captured replay, in this
    process. A sync snapshot at a window boundary gives the step's
    digest; ``take()`` async; one more captured window overwrites the
    state's buffers in place; ``latest`` must still hash to the digest.
    Then a spill and a restore of that snapshot, timed."""
    import tempfile

    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.distributed.window import stack_batches
    from horovod_tpu_torch.elastic.loop import _in_place_window

    k = ELASTIC_WINDOW
    buffers, window = _in_place_window(step_fn, state, k)

    def stacked(at):
        batch = stack_batches([source.batch_at(s) for s in
                               range(at, at + k)])
        return {n: t.to("cuda") for n, t in batch.items()}

    window(stacked(0))                         # warm-up + capture
    torch.cuda.synchronize()
    snap = elastic.Snapshotter(every=k)
    snap.take(0, buffers, sync=True)           # allocates the buffers
    t0 = time.perf_counter()
    snap.take(k, buffers, sync=True)
    sync_ms = (time.perf_counter() - t0) * 1e3
    step, host = snap.latest
    want = _elastic_digest(torch, host)
    check(step == k and int(host["step"]) == k,
          f"elastic: the sync snapshot holds step {int(host['step'])}")
    t0 = time.perf_counter()
    snap.take(k, buffers)                      # async, the same state
    take_ms = (time.perf_counter() - t0) * 1e3
    window(stacked(k))                         # captured replays
    t0 = time.perf_counter()
    step, host = snap.latest
    commit_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    got = _elastic_digest(torch, host)
    check(window.step.replays >= k and window.step.captures == 1,
          f"elastic: the window ran {window.step.captures} captures and "
          f"{window.step.replays} replays, expected 1 capture and a "
          f"window of replays")
    check(int(buffers["step"]) == 2 * k,
          f"elastic: the captured window left the state at step "
          f"{int(buffers['step'])}, expected {2 * k}")
    check(step == k and got == want,
          f"elastic: the async snapshot of step {k} hashes to {got}, "
          f"not the state it was taken from ({want}): the window's "
          "in-place writes reached it")
    check(snap.staging_bytes > 0 and snap.pinned_bytes ==
          2 * snap.staging_bytes,
          f"elastic: the async snapshot went around the staging buffer "
          f"({snap.staging_bytes} staging, {snap.pinned_bytes} pinned "
          "bytes)")
    nbytes = sum(t.nbytes for t in torch.utils._pytree.tree_leaves(host))
    with tempfile.TemporaryDirectory() as tmp:
        mngr = CheckpointManager(tmp, backend="numpy")
        t0 = time.perf_counter()
        mngr.save(k, host)
        spill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = mngr.restore(k, template=buffers)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(_elastic_digest(torch, back) == want,
              "elastic: the restored snapshot differs from the state")
        del back
    return {"async_take_host_ms": take_ms, "commit_wait_ms": commit_ms,
            "sync_snapshot_ms": sync_ms, "snapshot_bytes": nbytes,
            "sync_gb_per_s": nbytes / sync_ms / 1e6,
            "spill_ms": spill_ms, "restore_ms": restore_ms,
            "staging_bytes": snap.staging_bytes,
            "pinned_bytes": snap.pinned_bytes,
            "digest_kept": got == want}


def _elastic_eager(torch, np, state, step_fn, source):
    """Part (b)'s comparator: ELASTIC_STEPS eager steps (K = 1) of the
    windowed job's model and batches in this process's NCCL world of
    one. The step is functional: ``state`` stays as it was."""
    from horovod_tpu_torch import elastic

    eager, metrics, _ = elastic.run_elastic(
        step_fn, state, source.batch_at, ELASTIC_STEPS, world_size=1,
        rank=0)
    return (_elastic_digest(torch, eager),
            {s: repr(float(m["loss"])) for s, m in metrics})


def _elastic_cli():
    """Part (d): a malformed ``--fault-plan`` exits 2; ``--elastic`` over
    a trivial command exits 0."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1")
    cli = [sys.executable, "-m", "horovod_tpu_torch.run"]
    bad = subprocess.run(cli + ["-np", "2", "--elastic", "--fault-plan",
                                "explode:rank=0", "--", "true"], env=env,
                         capture_output=True, text=True, timeout=60)
    check(bad.returncode == 2 and "fault plan" in bad.stderr,
          f"elastic: a malformed --fault-plan gave rc {bad.returncode}: "
          f"{bad.stderr[-1000:]}")
    ok = subprocess.run(cli + ["-np", "2", "--elastic", "--", "true"],
                        env=env, capture_output=True, text=True,
                        timeout=60)
    check(ok.returncode == 0,
          f"elastic: --elastic over `true` gave rc {ok.returncode}: "
          f"{ok.stderr[-1000:]}")
    return {"bad_plan_rc": bad.returncode, "elastic_true_rc": ok.returncode}


def _elastic_check_job(ranks, clean, what):
    """Part (a)/(b)'s rank checks against the clean records: final
    digests, trajectories and K1-K3 launches a step on every attempt."""
    for r, (got, want) in enumerate(zip(ranks, clean)):
        last = max(got["attempts"])
        final = got["attempts"][last]
        check(final["digest"] == want["digest"],
              f"elastic: {what} rank {r}'s final state differs from the "
              f"clean run's ({final['digest']} vs {want['digest']})")
        check(got["traj"] == want["traj"],
              f"elastic: {what} rank {r}'s loss trajectory "
              f"{got['traj']} differs from the clean one {want['traj']}")
    return [ranks[r]["attempts"][max(ranks[r]["attempts"])]["resumed"]
            for r in range(len(ranks))]


def _elastic_summary(job):
    """One job's figures for the ``{"elastic"}`` line."""
    ranks = job["ranks"]
    sup = job["supervisor"] or {}

    def each(key):
        return [[r["attempts"][a][key] for a in sorted(r["attempts"])]
                for r in ranks]

    first = ranks[0]["attempts"][min(ranks[0]["attempts"])]
    return {
        "rc": job["rc"], "relaunches": job["relaunches"],
        "classes": sup.get("restarts_by_class"),
        "relaunch_s": sup.get("relaunch_s"), "wall_s": sup.get("wall_s"),
        "world": sup.get("world"), "seconds": job["seconds"],
        "resumed": each("resumed"), "startup_s": each("startup_s"),
        "step_ms": each("step_ms"), "launches": each("launches"),
        "snapshot_ms": [[s["last_ms"] for s in per]
                        for per in each("snapshot_stats")],
        "peak_memory_bytes": [max(p) for p in each("peak_memory_bytes")],
        "lines": [{a: lines[-1] for a, lines in r["lines"].items()}
                  for r in ranks],
        "backend": first["backend"], "state_bytes": first["state_bytes"],
    }


def _elastic_jobs(torch, np, rate):
    """Parts (a)-(c) in this process's NCCL world of one: the three jobs
    started at once (5 rank processes on the card, 9-20 GB each, their
    steps sharing its host's cores), part (b)'s eager comparator here
    while they run, their checks, then part (c), timed, alone."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        deadline = time.perf_counter() + ELASTIC_TIMEOUT_S
        started = []
        try:
            for args in (("kill", ELASTIC_RANKS, "dp", ELASTIC_KILL, 1),
                         ("preempt", 1, "win", ELASTIC_PREEMPT, 0),
                         ("clean", ELASTIC_RANKS, "dp", None, 1)):
                started.append(_elastic_start(tmp, *args))
                time.sleep(1.0)    # distinct free ports for each world
            state, step_fn, source = _elastic_lm(torch, np, "cuda",
                                                 ELASTIC_WIN_SEQS, 0, 1)
            eager_digest, eager_losses = _elastic_eager(torch, np, state,
                                                        step_fn, source)
            jobs = {j["tag"]: _elastic_finish(j, deadline)
                    for j in started}
        finally:
            for job in started:
                _elastic_stop(job)
        for tag, j in jobs.items():
            j["ranks"] = _elastic_ranks(j["out"], 1 if tag == "preempt"
                                        else ELASTIC_RANKS)
    # (a) a lost rank, against the same job without the plan.
    clean = [r["attempts"][0] for r in jobs["clean"]["ranks"]]
    for r, cl in enumerate(clean):
        cl["traj"] = jobs["clean"]["ranks"][r]["traj"]
    kill = jobs["kill"]
    check(jobs["clean"]["relaunches"] == 0 and kill["relaunches"] == 1
          and "crashed" in kill["err"],
          f"elastic: the kill job relaunched {kill['relaunches']} times: "
          f"{kill['err'][-2000:]}; the clean one "
          f"{jobs['clean']['relaunches']}")
    check(len(set(cl["digest"] for cl in clean)) == 1,
          "elastic: the clean job's ranks ended with different states")
    resumed = _elastic_check_job(kill["ranks"], clean, "part (a)")
    check(resumed[1] == ELASTIC_EVERY,
          f"elastic: rank 1 resumed from step {resumed[1]}, expected "
          f"{ELASTIC_EVERY}")
    replayed = []
    for r, rank in enumerate(kill["ranks"] + jobs["clean"]["ranks"]):
        for a, lines in rank["lines"].items():
            start = rank["attempts"].get(a, {}).get(
                "resumed", min(s for s, _, _ in lines) - 1)
            for s, launches, _ in lines:
                check(all(n == ELASTIC_LAYERS * (s - start)
                          for n in launches),
                      f"elastic: rank {r % ELASTIC_RANKS} attempt {a} "
                      f"shows K1-K3 launches {launches} after step {s} "
                      f"from {start}, expected {ELASTIC_LAYERS} a step")
        if r < ELASTIC_RANKS:
            first_max = max(s for s, _, _ in rank["lines"][0])
            replayed.append(first_max - rank["attempts"][1]["resumed"])
    # (b) a preemption through a captured window, on one rank.
    pre = jobs["preempt"]
    win = pre["ranks"][0]
    classes = (pre["supervisor"] or {}).get("restarts_by_class")
    check(pre["relaunches"] == 1 and "preempted" in pre["err"]
          and classes == {"preempted": 1},
          f"elastic: the preempt job's supervisor saw {classes}: "
          f"{pre['err'][-2000:]}")
    final = win["attempts"][1]
    check(final["resumed"] == ELASTIC_EVERY,
          f"elastic: the preempted rank resumed from {final['resumed']}, "
          f"expected the manifest of step {ELASTIC_EVERY}")
    for a, lines in win["lines"].items():
        step, launches, captured = lines[-1]
        check(captured == 1
              and all(n == 2 * ELASTIC_LAYERS for n in launches),
              f"elastic: the preempt job's attempt {a} captured "
              f"{captured} step calls with K1-K3 wrapper calls {launches} "
              f"by step {step}, expected one capture after one eager "
              f"warm-up step ({2 * ELASTIC_LAYERS} each)")
    check(final["digest"] == eager_digest,
          f"elastic: the preempted windowed job ended at "
          f"{final['digest']}, the eager run at {eager_digest}")
    # (c) the async snapshot under replay.
    part_c = _elastic_async(torch, np, state, step_fn, source)
    part_c["d2d_copy_gb_per_s"] = rate / 1e9
    return {
        "clean": _elastic_summary(jobs["clean"]),
        "kill": _elastic_summary(kill), "kill_plan": ELASTIC_KILL,
        "steps_replayed": replayed, "preempt": _elastic_summary(pre),
        "preempt_plan": ELASTIC_PREEMPT, "window": ELASTIC_WINDOW,
        "eager_digest_equal": True, "eager_losses": eager_losses,
        "async_snapshot": part_c,
        "launches": {tag: [[r["lines"][a][-1][1] for a in sorted(r["lines"])]
                           for r in jobs[tag]["ranks"]]
                     for tag in ("clean", "kill", "preempt")},
    }


def elastic_phase(torch, np, card, rate, cli=None):
    """Phase 17 (module docstring): elastic training on the card — a
    lost rank (a), a preemption through a captured window (b), the async
    snapshot under replay (c) and the CLI (d: the job phase's, ``cli``,
    where it ran)."""
    from horovod_tpu_torch import distributed as hvd

    t0 = time.perf_counter()
    res = {"card": card, "model": {
        "layers": ELASTIC_LAYERS, "d_model": D_MODEL, "heads": HEADS,
        "vocab": VOCAB, "seq": FLASH_L, "dtype": "bfloat16 compute, "
        "float32 weights and moments",
        "attention": "flash (K1-K3, bwd kernel)",
        "optimizer": f"functional Adam {ELASTIC_LR}"},
        "steps": ELASTIC_STEPS, "snapshot_every": ELASTIC_EVERY,
        "spill_every": 1, "caveat": ELASTIC_CAVEAT}
    torch.cuda.empty_cache()
    hvd.init()
    try:
        res.update(_elastic_jobs(torch, np, rate))
    finally:
        hvd.shutdown()
        torch.cuda.empty_cache()
    res["cli"] = cli or _elastic_cli()
    res["phase_s"] = time.perf_counter() - t0
    snap = res["async_snapshot"]
    log(f"elastic: kill job rc 0 after {res['kill']['relaunches']} "
        f"relaunch (resumed {res['kill']['resumed']}, "
        f"{res['steps_replayed']} steps replayed), digests and "
        f"trajectories equal to the clean job; preempt job rc 0 "
        f"({res['preempt']['classes']}), equal to eager; async take "
        f"{snap['async_take_host_ms']:.2f} ms host, commit wait "
        f"{snap['commit_wait_ms']:.1f} ms, sync snapshot "
        f"{snap['sync_snapshot_ms']:.1f} ms of {snap['snapshot_bytes']} "
        f"bytes ({snap['sync_gb_per_s']:.1f} GB/s; the card's device copy "
        f"{rate / 1e9:.0f} GB/s), spill {snap['spill_ms']:.0f} ms, restore "
        f"{snap['restore_ms']:.0f} ms; phase passed in "
        f"{res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ phase 18


# The training loop: GPT-2-small at the training width on K1-K3 (the
# elastic phase's model, weights drawn on the card), FLASH_B sequences a
# step, Adam 1e-4 with capturable=True and the LR a tensor on the card,
# under create_distributed_optimizer in this process's NCCL world of one.
# LOOP_EPOCHS epochs of LOOP_WINDOWS windows of LOOP_K captured steps.
LOOP_EPOCHS, LOOP_WINDOWS, LOOP_K = 2, 2, 2
# The loop's LM: the training width, 2 of its 12 layers (the phase's
# depth cut, which pays toward phases 13b, 21 and 22).
LOOP_LAYERS = 2
LOOP_STEPS = LOOP_EPOCHS * LOOP_WINDOWS * LOOP_K
LOOP_LR = 1e-4
LOOP_SEED, LOOP_OTHER_SEED, LOOP_DATA_SEED = 18, 19, 180
LOOP_PREEMPT_STEP = LOOP_STEPS + 1


def _loop_multiplier(epoch):
    """Run A's schedule: a new LR at every window."""
    return 0.5 ** epoch


def _loop_lm(torch, seed):
    """GPT-2-small on K1-K3 with its optimizer and live TrainState, and
    one training step: the next-token loss, ``backward()`` (the
    wrapper's gradient hooks issue the NCCL buckets), then
    ``apply_gradients`` over ``.grad`` (the exchange's tail, Adam)."""
    import functools

    from horovod_tpu_torch import training
    from horovod_tpu_torch.models.train import (TrainState,
                                                apply_gradients,
                                                next_token_loss)
    from horovod_tpu_torch.ops import attention as fa

    model = _elastic_model(torch, "cuda", functools.partial(
        fa.flash_attention, causal=True, bwd_impl="kernel"), seed=seed,
        layers=LOOP_LAYERS)
    opt = training.create_distributed_optimizer(
        torch.optim.Adam(model.parameters(),
                         lr=torch.tensor(LOOP_LR, device="cuda"),
                         capturable=True),
        named_parameters=model.named_parameters())
    state = TrainState.from_model(model, opt)

    def one(tokens):
        opt.zero_grad()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        apply_gradients(opt, state)
        return {"loss": loss.detach()}

    one.model, one.optimizer = model, opt
    return state, one


def _loop_lrs():
    """The closed form of run A's LR at each window: the optimizer's
    float32 1e-4, times the multiplier at epoch + window / windows, as
    float32."""
    import numpy as np

    base = float(np.float32(LOOP_LR))
    return [float(np.float32(base * _loop_multiplier(
        e + b / LOOP_WINDOWS))) for e in range(LOOP_EPOCHS)
        for b in range(LOOP_WINDOWS)]


class _LoopTimer:
    """CUDA events around each window of a run: its device span."""

    def __init__(self, torch):
        self.torch = torch
        self.spans = []

    def __call__(self, fn):
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        self.spans.append((a, b))
        return out

    def step_ms(self):
        """ms a step over the windows after the first (which holds the
        warm-up step and the capture)."""
        self.torch.cuda.synchronize()
        ms = [a.elapsed_time(b) / LOOP_K for a, b in self.spans[1:]]
        return sum(ms) / len(ms)


def _loop_run(torch, windows, mode, callbacks_for):
    """One run of the loop from LOOP_SEED's weights. ``mode``:
    ``captured`` (the window replays one captured step), ``profiled``
    (captured, and the replayed windows after the second traced in one
    profiler session: the second window, all replays, is its traced and
    dropped warm-up, since a trace that begins with a graph replay can
    lose the replay's first kernels), ``eager`` (each window's steps run
    eagerly, accumulated as the window does). Returns the state, the
    loop, the window, the timer, the trace's counts and the LRs the loop
    applied."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from horovod_tpu_torch import training
    from horovod_tpu_torch.distributed.window import windowed
    from horovod_tpu_torch.ops import attention as fa
    from horovod_tpu_torch.training import callbacks as cbs

    state, one = _loop_lm(torch, LOOP_SEED)
    opt = one.optimizer
    if mode == "eager":
        window = None

        def run(stacked):
            return _window_mean(torch, [one(stacked[i])
                                        for i in range(stacked.shape[0])])
    else:
        window = windowed(one, LOOP_K)
        run = window
    timer, lrs = _LoopTimer(torch), []
    last = LOOP_EPOCHS * LOOP_WINDOWS - 1
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                   ) if mode == "profiled" else None

    def step(st, stacked):
        if prof is None:
            return st, timer(lambda: run(stacked))
        at = len(lrs) - 1                  # this window (the LR log's)
        if at == 1:
            prof.start()
        out = run(stacked)
        if at in (1, last):
            torch.cuda.synchronize()
            prof.step()
        if at == last:
            prof.stop()
        return st, out

    class LR(cbs.Callback):
        def on_batch_begin(self, batch, logs=None):
            lr = cbs.get_hyperparam(self.loop.state["opt_state"],
                                    "learning_rate")
            check(lr is opt.param_groups[0]["lr"] and lr.is_cuda,
                  "loop: the schedule's lr is not the optimizer's tensor "
                  "on the card")
            lrs.append(float(lr))

    for k in (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        k.launches = 0
    loop = training.TrainLoop(
        state, step, lambda e: windows[e * LOOP_WINDOWS:
                                       (e + 1) * LOOP_WINDOWS],
        callbacks=[*callbacks_for(state), LR()])
    loop.fit(LOOP_EPOCHS)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches
                for k in (fa.flash_forward, fa.flash_bwd_dq,
                          fa.flash_bwd_dkv)}
    traced = None if prof is None else _trace_counts(
        _device_events(prof), ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv"))
    return {"state": state, "one": one, "loop": loop, "window": window,
            "timer": timer, "traced": traced, "lrs": lrs,
            "launches": launches}


def _loop_history(run):
    """A run's epoch metrics as floats (the metric average leaves
    tensors in them)."""
    return [{k: float(v) for k, v in h.items()}
            for h in run["loop"].history]


def _loop_release(torch, run):
    """Drop a run's graph, gradients and state so the next fits."""
    run["one"].optimizer.zero_grad(set_to_none=True)
    run.clear()
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _loop_persistence(torch, tmp, run, windows, digest, ckpt, snap_dir,
                      saves):
    """Run A's final state: ``save_model`` and ``load_model`` into a
    fresh model's TrainState, the checkpoint's and the snapshot's
    restores, a preempted further fit of the loaded copy, and one more
    step of A against it."""
    import os

    from horovod_tpu_torch import elastic, training
    from horovod_tpu_torch.checkpoint import CheckpointManager

    state, out = run["state"], {}
    path = os.path.join(tmp, "model.msgpack")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    training.save_model(path, state)
    out["save_model_ms"] = (time.perf_counter() - t0) * 1e3
    out["save_model_bytes"] = os.path.getsize(path)
    out["save_model_mb_per_s"] = (out["save_model_bytes"]
                                  / out["save_model_ms"] / 1e3)
    copy, one_copy = _loop_lm(torch, LOOP_OTHER_SEED)
    check(_elastic_digest(torch, copy) != digest,
          "loop: the fresh model already holds run A's state")
    t0 = time.perf_counter()
    back = training.load_model(path, copy)
    torch.cuda.synchronize()
    out["load_model_ms"] = (time.perf_counter() - t0) * 1e3
    check(back is copy and _elastic_digest(torch, copy) == digest,
          "loop: load_model did not restore run A's state into the "
          "fresh TrainState")
    step = ckpt.latest_step()
    t0 = time.perf_counter()
    restored = ckpt.restore(step, template=state)
    torch.cuda.synchronize()
    out["checkpoint_restore_ms"] = (time.perf_counter() - t0) * 1e3
    check(step == LOOP_STEPS and _elastic_digest(torch, restored) == digest,
          f"loop: the CheckpointCallback's step {step} does not restore to "
          "the last epoch's digest")
    del restored
    snap = elastic.Snapshotter(CheckpointManager(snap_dir, max_to_keep=1,
                                                 backend="numpy"))
    restored, manifest = snap.restore(state)
    check(manifest.step == LOOP_STEPS
          and _elastic_digest(torch, restored) == digest,
          f"loop: the last snapshot (step {manifest.step}) does not "
          "restore to the final digest")
    del restored
    out["checkpoint_save_ms"] = saves
    # A further fit of the loaded copy, preempted at step 9: the
    # callback's epilogue snapshots, spills and exits 75.
    handler = elastic.PreemptionHandler(install=False)
    losses = []

    class Trigger(training.Callback):
        def on_batch_end(self, batch, logs=None):
            losses.append(repr(float(logs["loss"])))
            if int(self.loop.state["step"]) == LOOP_PREEMPT_STEP:
                handler.trigger()

    further = training.TrainLoop(
        copy, lambda st, b: (st, one_copy(b)),
        lambda e: [windows[0][0], windows[0][1]],
        callbacks=[Trigger(), training.ElasticSnapshotCallback(
            elastic.Snapshotter(CheckpointManager(
                snap_dir, max_to_keep=1, backend="numpy"), every=100),
            preemption=handler)])
    code = None
    try:
        further.fit(1)
    except SystemExit as e:
        code = e.code
    latest = elastic.latest_manifest(snap_dir)
    check(code == elastic.EXIT_PREEMPTED == 75 and latest.step ==
          LOOP_PREEMPT_STEP and int(copy["step"]) == LOOP_PREEMPT_STEP,
          f"loop: the preempted fit exited {code} with the manifest at "
          f"{latest and latest.step}, expected 75 at {LOOP_PREEMPT_STEP}")
    more = repr(float(run["one"](windows[0][0])["loss"]))
    check(losses == [more] and int(state["step"]) == LOOP_PREEMPT_STEP,
          f"loop: one more step from run A gives loss {more}, from its "
          f"saved and loaded copy {losses}")
    check(_elastic_digest(torch, state) == _elastic_digest(torch, copy),
          "loop: run A and its loaded copy differ after one more step")
    out.update({"preempt_exit": code, "preempt_manifest_step": latest.step,
                "one_more_step_loss": more, "losses_equal_by_repr": True,
                "load_model_digest_equal": True,
                "checkpoint_digest_equal": True,
                "snapshot_digest_equal": True})
    return out


def loop_phase(torch, np, card):
    """Phase 18 (module docstring): the training loop on the card."""
    import tempfile

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch import elastic, training
    from horovod_tpu_torch.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    hvd.init()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(LOOP_DATA_SEED)
    windows = [torch.tensor(rng.integers(0, VOCAB, (LOOP_K, FLASH_B,
                                                    FLASH_L)),
                            device="cuda")
               for _ in range(LOOP_EPOCHS * LOOP_WINDOWS)]
    res = {"card": card, "model": {
        "layers": LOOP_LAYERS, "d_model": D_MODEL, "heads": HEADS,
        "vocab": VOCAB, "seq": FLASH_L, "batch": FLASH_B,
        "dtype": "bfloat16 compute, float32 weights and moments",
        "attention": "flash (K1-K3, bwd kernel)",
        "optimizer": f"Adam {LOOP_LR}, capturable, lr a tensor on the "
                     "card, create_distributed_optimizer"},
        "epochs": LOOP_EPOCHS, "windows_an_epoch": LOOP_WINDOWS,
        "window_steps": LOOP_K}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = CheckpointManager(f"{tmp}/ckpt", max_to_keep=1,
                                     backend="numpy")
            saves, digests, made = [], {}, {}
            save = ckpt.save

            def timed_save(step, state):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                save(step, state)
                saves.append((time.perf_counter() - s0) * 1e3)
                return True

            ckpt.save = timed_save

            class EpochDigest(training.Callback):
                def on_epoch_end(self, epoch, logs=None):
                    if epoch == LOOP_EPOCHS - 1:
                        digests["epoch_end"] = _elastic_digest(
                            torch, self.loop.state)

            def run_a_callbacks(state):
                made["snap"] = elastic.Snapshotter(
                    CheckpointManager(f"{tmp}/snap", max_to_keep=1,
                                      backend="numpy"),
                    every=LOOP_K, spill_every=2)
                return [
                    training.BroadcastGlobalVariablesCallback(0),
                    training.MetricAverageCallback(),
                    training.LearningRateScheduleCallback(
                        _loop_multiplier, staircase=False,
                        steps_per_epoch=LOOP_WINDOWS),
                    training.CheckpointCallback(
                        ckpt, step_counter=lambda s: int(s["step"])),
                    training.ElasticSnapshotCallback(
                        made["snap"], preemption=elastic.PreemptionHandler(
                            install=False)),
                    EpochDigest()]

            a = _loop_run(torch, windows, "profiled", run_a_callbacks)
            digest = digests["epoch_end"]
            check(_elastic_digest(torch, a["state"]) == digest,
                  "loop: run A's state moved after its last epoch")
            check(a["lrs"] == _loop_lrs(),
                  f"loop: run A applied the LRs {a['lrs']}, the schedule's "
                  f"closed form is {_loop_lrs()}")
            check(int(a["state"]["step"]) == LOOP_STEPS,
                  f"loop: the state reads step {int(a['state']['step'])}, "
                  f"expected {LOOP_STEPS}")
            ws = a["window"].step
            check(ws.captures == 1 and ws.replays == LOOP_STEPS - 1,
                  f"loop: run A captured {ws.captures} times and replayed "
                  f"{ws.replays} steps, expected 1 and {LOOP_STEPS - 1}")
            traced_steps = (LOOP_EPOCHS * LOOP_WINDOWS - 2) * LOOP_K
            check(all(n == LOOP_LAYERS * traced_steps
                      for n in a["traced"].values()),
                  f"loop: the {traced_steps} replayed steps of the traced "
                  f"windows hold K1-K3 {a['traced']}, expected "
                  f"{LOOP_LAYERS * traced_steps} each ({LOOP_LAYERS} a step)")
            check(all(n == 2 * LOOP_LAYERS for n in a["launches"].values()),
                  f"loop: run A's wrappers launched {a['launches']}, "
                  f"expected {2 * LOOP_LAYERS} each (warm-up and capture)")
            history_a = _loop_history(a)
            res["run_a"] = {
                "lr_per_window": a["lrs"], "lr_closed_form": _loop_lrs(),
                "history": history_a,
                "captures": ws.captures, "replays": ws.replays,
                "capture_s": ws.capture_s, "warmup_s": ws.warmup_s,
                "launches": a["launches"], "traced": a["traced"],
                "traced_replayed_steps": traced_steps, "digest": digest,
                "snapshots": dict(made.pop("snap").stats)}
            res.update(_loop_persistence(
                torch, tmp, a, windows, digest, ckpt, f"{tmp}/snap",
                saves))
            _loop_release(torch, a)

            b = _loop_run(torch, windows, "eager", lambda s: [
                training.LearningRateScheduleCallback(
                    _loop_multiplier, staircase=False,
                    steps_per_epoch=LOOP_WINDOWS)])
            digest_b = _elastic_digest(torch, b["state"])
            check(digest_b == digest and _loop_history(b) == history_a,
                  f"loop: the captured run A ({digest}, {history_a}) and "
                  f"the eager run B ({digest_b}, {_loop_history(b)}) "
                  "differ")
            check(all(n == LOOP_STEPS * LOOP_LAYERS
                      for n in b["launches"].values()),
                  f"loop: run B's wrappers launched {b['launches']}")
            res["run_b"] = {"digest_equal_a": True,
                            "step_ms_eager": b["timer"].step_ms(),
                            "launches": b["launches"]}
            _loop_release(torch, b)

            c = _loop_run(torch, windows, "captured", lambda s: [
                training.BroadcastGlobalVariablesCallback(0),
                training.MetricAverageCallback(),
                training.LearningRateScheduleCallback(
                    1.0, staircase=False, steps_per_epoch=LOOP_WINDOWS)])
            digest_c = _elastic_digest(torch, c["state"])
            check(digest_c != digest and c["lrs"] == [_loop_lrs()[0]] * len(
                c["lrs"]),
                  "loop: the constant-LR run C ends at run A's digest: "
                  "the schedule's LR did not reach the replayed graph")
            res["run_c"] = {"digest_differs_a": True,
                            "step_ms_captured": c["timer"].step_ms(),
                            "launches": c["launches"],
                            "replays": c["window"].step.replays}
            _loop_release(torch, c)
    finally:
        hvd.shutdown()
        torch.cuda.empty_cache()
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    res["phase_s"] = time.perf_counter() - t0
    log(f"loop: LRs {res['run_a']['lr_per_window']} reached the replayed "
        f"graph (A == B eager, A != C constant); step ms captured "
        f"{res['run_c']['step_ms_captured']:.1f}, eager "
        f"{res['run_b']['step_ms_eager']:.1f}; save_model "
        f"{res['save_model_ms']:.0f} ms for {res['save_model_bytes']} "
        f"bytes ({res['save_model_mb_per_s']:.0f} MB/s), load_model "
        f"{res['load_model_ms']:.0f} ms; checkpoint saves "
        f"{[round(s) for s in res['checkpoint_save_ms']]} ms, restore "
        f"{res['checkpoint_restore_ms']:.0f} ms; snapshots "
        f"{res['run_a']['snapshots']['snapshots']}; preempted at step "
        f"{res['preempt_manifest_step']} exit {res['preempt_exit']}; "
        f"phase passed in {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ phase 19


# HOROVOD_AUTOTUNE on the LM step: GPT-2-small at the training width on
# K1-K3 (weights drawn on the card), FLASH_B sequences a step cycling over
# AUTOTUNE_BATCHES fixed batches, Adam 1e-4 (capturable) under
# DistributedOptimizer in this process's NCCL world of one. The tuner
# scores windows of AUTOTUNE_WINDOW dispatches; one host cannot ladder,
# so its space is the 9 flat thresholds, and EI stops after
# AUTOTUNE_PROBES probes, each a warm-up and a scored window. Every run
# takes the steps that run C (windows of AUTOTUNE_K captured steps, one
# dispatch each) needs to converge, and one window more, which captures
# the winner's plan.
AUTOTUNE_WINDOW, AUTOTUNE_K, AUTOTUNE_PROBES = 2, 4, 6
AUTOTUNE_BATCHES = 4
AUTOTUNE_STEPS = (2 * AUTOTUNE_PROBES * AUTOTUNE_WINDOW + 1) * AUTOTUNE_K
AUTOTUNE_LR = 1e-4
# The tuned LM: the training width, 2 of its 12 layers (the phase's depth
# cut, which pays toward phases 13b, 21 and 22).
AUTOTUNE_LAYERS = 2
AUTOTUNE_SEED, AUTOTUNE_DATA_SEED = 19, 190
# Card memory the re-captures may add over the first capture's, after
# the allocator's cache is emptied: a graph replaced but not freed would
# keep its pool (GBs of a step's activations) reserved.
AUTOTUNE_MEM_SLACK = 1 << 30


def _autotune_lm(torch, hvd):
    """GPT-2-small on K1-K3, its ``DistributedOptimizer`` and one step
    (the next-token loss, ``backward()`` with the hooks issuing the
    buckets, ``step()``: the tuner's dispatch)."""
    import functools

    from horovod_tpu_torch.models.train import next_token_loss
    from horovod_tpu_torch.ops import attention as fa

    model = _elastic_model(torch, "cuda", functools.partial(
        fa.flash_attention, causal=True, bwd_impl="kernel"),
        seed=AUTOTUNE_SEED, layers=AUTOTUNE_LAYERS)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=AUTOTUNE_LR,
                         capturable=True),
        named_parameters=model.named_parameters())

    def one(tokens):
        opt.zero_grad()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    one.model, one.optimizer = model, opt
    return one


def _flash_launches(fa, reset=False):
    kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    if reset:
        for k in kernels:
            k.launches = 0
    return {k.__name__: k.launches for k in kernels}


def _params(model):
    return [p.detach() for p in model.parameters()]


def _same(a, b):
    return len(a) == len(b) and all(bool((x == y).all())
                                    for x, y in zip(a, b))


def _autotune_eager(torch, hvd, fa, batches, tuner, snaps):
    """``AUTOTUNE_STEPS`` eager steps from fresh weights. Under a
    ``tuner``, put a copy of the parameters into ``snaps`` after each
    step at which its generation moved; without one, hold the parameters
    against ``snaps`` at those steps. Returns the step, the losses, the
    launches, the seconds and the steps of the moves."""
    one = _autotune_lm(torch, hvd)
    _flash_launches(fa, reset=True)
    gen = None if tuner is None else tuner.generation
    losses, moves = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(AUTOTUNE_STEPS):
        losses.append(one(batches[i % AUTOTUNE_BATCHES])["loss"])
        if tuner is not None and tuner.generation != gen:
            gen = tuner.generation
            moves.append(i + 1)
            snaps[i + 1] = [p.clone() for p in _params(one.model)]
        elif tuner is None and i + 1 in snaps:
            check(_same(_params(one.model), snaps[i + 1]),
                  f"autotune: run B's parameters after step {i + 1} "
                  "differ from run A's after its move there")
            moves.append(i + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return one, [float(x) for x in losses], _flash_launches(fa), wall, moves


def autotune_phase(torch, np, card):
    """Phase 19 (module docstring): ``HOROVOD_AUTOTUNE`` on the card."""
    import os
    import tempfile

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.autotune import StepAutotuner
    from horovod_tpu_torch.distributed.fusion import plan_buckets
    from horovod_tpu_torch.distributed.window import windowed
    from horovod_tpu_torch.ops import attention as fa

    t0 = time.perf_counter()
    rng = np.random.default_rng(AUTOTUNE_DATA_SEED)
    res = {"card": card, "model": {
        "layers": AUTOTUNE_LAYERS, "d_model": D_MODEL, "heads": HEADS,
        "vocab": VOCAB, "seq": FLASH_L, "batch": FLASH_B,
        "dtype": "bfloat16 compute, float32 weights and moments",
        "attention": "flash (K1-K3, bwd kernel)",
        "optimizer": f"Adam {AUTOTUNE_LR}, capturable, "
                     "DistributedOptimizer"},
        "tuner_window": AUTOTUNE_WINDOW, "steps": AUTOTUNE_STEPS}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HOROVOD_AUTOTUNE"] = "1"
        os.environ["HOROVOD_AUTOTUNE_LOG"] = f"{tmp}/a.tsv"
        try:
            hvd.init()
        finally:
            del os.environ["HOROVOD_AUTOTUNE"]
            del os.environ["HOROVOD_AUTOTUNE_LOG"]
        try:
            cfg = basics.config()
            default = cfg.fusion_threshold
            batches = [torch.tensor(rng.integers(0, VOCAB, (FLASH_B,
                                                            FLASH_L)),
                                    device="cuda")
                       for _ in range(AUTOTUNE_BATCHES)]
            # Run A: eager (K = 1), tuned from the env knob, until past
            # convergence.
            tuner = basics._state.autotuner
            check(isinstance(tuner, StepAutotuner),
                  "autotune: HOROVOD_AUTOTUNE=1 made no StepAutotuner")
            tuner.window = AUTOTUNE_WINDOW
            check(len(tuner.candidates) == 9
                  and not any(h for _, h in tuner.candidates)
                  and tuner.max_probes == AUTOTUNE_PROBES
                  and tuner._strategy_resolved == "ei",
                  f"autotune: the tuner's space {tuner.candidates}, "
                  f"{tuner.max_probes} probes, {tuner._strategy_resolved}")
            snaps = {}
            one, losses_a, launches_a, wall_a, moves_a = _autotune_eager(
                torch, hvd, fa, batches, tuner, snaps)
            with open(f"{tmp}/a.tsv") as f:
                tsv = [ln.split("\t") for ln in f.read().splitlines()]
            check(tuner.converged and len(tuner.probed) == AUTOTUNE_PROBES
                  and len(moves_a) == AUTOTUNE_PROBES
                  and tuner.generation == AUTOTUNE_PROBES + 1,
                  f"autotune: run A probed {len(tuner.probed)}, moved at "
                  f"steps {moves_a}, converged {tuner.converged}")
            check([ln[1] for ln in tsv] == ["warmup", "sample"]
                  * AUTOTUNE_PROBES + ["converged"],
                  f"autotune: run A's log {[ln[1] for ln in tsv]}")
            trainable = [p for p in one.model.parameters()
                         if p.requires_grad]
            want = plan_buckets(trainable, tuner.best_threshold)
            ex = one.optimizer._hvd_exchange
            check(cfg.fusion_threshold == tuner.best_threshold
                  and (ex.plan == want if ex is not None
                       else len(want) == 1),
                  f"autotune: after convergence the optimizer runs "
                  f"{None if ex is None else len(ex.plan)} buckets, "
                  f"plan_buckets at the winner {tuner.best_threshold} has "
                  f"{len(want)}")
            steps_k = AUTOTUNE_LAYERS * AUTOTUNE_STEPS
            check(all(n == steps_k for n in launches_a.values()),
                  f"autotune: run A's wrappers launched {launches_a}, "
                  f"expected {steps_k} each")
            check(all(math.isfinite(x) for x in losses_a)
                  and losses_a[-1] < losses_a[0],
                  f"autotune: run A's losses {losses_a[0]} .. "
                  f"{losses_a[-1]}")
            final_a = [p.clone() for p in _params(one.model)]
            res["run_a"] = {
                "probed_steps_per_s": {str(t): v for (t, _), v in
                                       tuner.probed.items()},
                "winner": tuner.best_threshold,
                "winner_steps_per_s": tuner.best_score,
                "probes": len(tuner.probed), "moves_at_step": moves_a,
                "buckets_at_winner": len(want),
                "log": ["\t".join(ln) for ln in tsv],
                "wall_s": wall_a, "launches": launches_a,
                "loss_first_last": [losses_a[0], losses_a[-1]]}
            del one, trainable, ex
            # Run B: untuned, the same weights, batches and steps.
            basics._state.autotuner.close()
            basics._state.autotuner = None
            cfg.fusion_threshold = default
            one, losses_b, launches_b, wall_b, held = _autotune_eager(
                torch, hvd, fa, batches, None, snaps)
            check(held == moves_a and losses_b == losses_a,
                  f"autotune: run B held {held} of A's moves {moves_a}, "
                  "or its losses differ from run A's")
            check(_same(_params(one.model), final_a),
                  "autotune: run B's final parameters differ from run A's")
            check(all(n == steps_k for n in launches_b.values()),
                  f"autotune: run B's wrappers launched {launches_b}")
            del one
            res["run_b"] = {"wall_s": wall_b, "launches": launches_b,
                            "equal_a_at_steps": held, "equal_a_final": True}
            # Run C: windows of AUTOTUNE_K captured steps, tuned anew.
            tuner_c = basics._state.autotuner = StepAutotuner(
                cfg, log_path=f"{tmp}/c.tsv", window=AUTOTUNE_WINDOW)
            one = _autotune_lm(torch, hvd)
            win = windowed(one, AUTOTUNE_K)
            _flash_launches(fa, reset=True)
            memory, captures = [], 0
            torch.cuda.synchronize()
            tc = time.perf_counter()
            for j in range(AUTOTUNE_STEPS // AUTOTUNE_K):
                win(torch.stack([batches[(j * AUTOTUNE_K + i)
                                         % AUTOTUNE_BATCHES]
                                 for i in range(AUTOTUNE_K)]))
                if win.step.captures != captures:
                    captures = win.step.captures
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    memory.append({"capture": captures,
                                   "allocated": torch.cuda.memory_allocated(),
                                   "reserved": torch.cuda.memory_reserved()})
            torch.cuda.synchronize()
            wall_c = time.perf_counter() - tc
            launches_c = _flash_launches(fa)
            moves_c = tuner_c.generation - 1
            check(tuner_c.converged and captures == moves_c + 1,
                  f"autotune: run C captured {captures} times over "
                  f"{moves_c} moves (converged {tuner_c.converged})")
            check(win.step.replays == AUTOTUNE_STEPS - captures,
                  f"autotune: run C replayed {win.step.replays} steps")
            check(_same(_params(one.model), final_a),
                  "autotune: run C's parameters differ from run A's")
            check(all(n == 2 * AUTOTUNE_LAYERS * captures
                      for n in launches_c.values()),
                  f"autotune: run C's wrappers launched {launches_c}, "
                  f"expected {2 * AUTOTUNE_LAYERS * captures} each "
                  "(warm-up and capture)")
            grew = max(m["reserved"] for m in memory) - memory[0]["reserved"]
            check(grew <= AUTOTUNE_MEM_SLACK,
                  f"autotune: the card's reserved memory grew {grew} bytes "
                  f"over {captures} captures: {memory}")
            res["run_c"] = {
                "probed_steps_per_s": {str(t): v * AUTOTUNE_K
                                       for (t, _), v in
                                       tuner_c.probed.items()},
                "winner": tuner_c.best_threshold,
                "probes": len(tuner_c.probed), "captures": captures,
                "replays": win.step.replays, "moves": moves_c,
                "memory_after_each_capture": memory,
                "reserved_growth_bytes": grew, "wall_s": wall_c,
                "launches": launches_c, "equal_a": True}
            del one, win, snaps, final_a
        finally:
            hvd.shutdown()
            torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    a, c = res["run_a"], res["run_c"]
    log(f"autotune: run A probed {a['probes']} thresholds, winner "
        f"{a['winner']} at {a['winner_steps_per_s']:.3f} steps/s "
        f"({a['buckets_at_winner']} buckets), moves at steps "
        f"{a['moves_at_step']}; run B (untuned) and run C ({c['captures']} "
        f"captures, winner {c['winner']}, reserved memory +{c['reserved_growth_bytes']} "
        f"bytes) equal A bit for bit; phase passed in {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------ phase 20

ZOO_STEPS = 3
# Inception V3 at its published input (the bench lane's other defaults:
# 64 images a card, 1000 classes, bf16, SGD 0.01 momentum 0.9).
INCEPTION_SIZE = 299
# Fused (K5) against unfused (cuDNN 1x1 convs, statistics as a separate
# pass) Inception V3, same weights, batch and dropout mask (one seed, one
# generator), one bf16 forward + backward: RESNET_PARITY_TOL's argument
# (a y rounding one bf16 ulp the other way now and then, carried along),
# over 94 ConvBNs instead of 53 and without the identity paths through
# which a fresh ResNet's blocks pass most of the signal, so twice its
# bounds for the loss and the gradient norm. A running mean is held to
# one bf16 ulp (2^-8) of its layer's largest: under zero-mean images the
# stem's and the first blocks' channel means sit near 0, so the layer's
# largest is small against the per-element roundings that move it
# (1.86e-3 measured on an H100 at 700 W). Wrong statistics move a
# layer's running mean by its whole scale.
INCEPTION_PARITY_TOL = {"loss": 2e-3, "running_mean": 2.0 ** -8,
                        "grad_norm": 2e-2}
MNIST_B = 64
# Cross-replica BatchNorm: ResNet-50 (fused, 224^2) on 2 ranks of 16
# images with axis_name="hvd" against one rank of all 32 without it, in
# float32 (the K5 float32 kernel): in bf16 cuDNN's other algorithms at
# batch 16 and 32 round some y the other way, which moved near-zero
# running means by 4.0e-3 of their layer's largest and the summed
# gradients by 2.4e-2 (on an H100 at 700 W), too close to what a fault
# moves.
SYNCBN_RANKS, SYNCBN_B = 2, 32
SYNCBN_TIMEOUT_S = 300.0
# float32 without TF32 (the port's policy, _device.py): the same values
# summed in another order (other algorithms at batch 16 and 32, the
# statistics in two parts and then across the ranks): the loss (the
# ranks' summed to the whole batch's) within 1e-5 and each layer's new
# running mean within 1e-4 of its largest (0 and 2.0e-6 measured on an
# H100 at 700 W). cuDNN's float32 backward takes algorithms at the two
# batch sizes whose transforms round differently: the summed gradients
# moved by 5.6e-4 of their norm (relative L2, same card), so they are
# held to 1e-2. Statistics left per rank move a layer's mean by its
# whole scale; a cotangent left per rank (the psum's backward returning
# its input) moved the gradients by 0.34 (ResNet-50 at 64^2, 4 images a
# rank, float32, on the CPU).
SYNCBN_TOL = {"loss": 1e-5, "running_mean": 1e-4, "grad": 1e-2}


def _zoo_batch(torch, np, seed, b, size, channels=3, classes=CLASSES):
    rng = np.random.default_rng(seed)
    return {"image": torch.tensor(rng.standard_normal(
                (b, size, size, channels), dtype=np.float32), device="cuda"),
            "label": torch.tensor(rng.integers(0, classes, b),
                                  device="cuda")}


def _conv_bns(model):
    from horovod_tpu_torch.models import resnet

    return [m for m in model.modules() if isinstance(m, resnet.ConvBN)]


def _inception_parity(torch, batch):
    """One forward + backward of the same Inception V3 weights with fused
    and with unfused BatchNorm: loss, gradient norm, new running means."""
    from horovod_tpu_torch.models.inception import InceptionV3
    from horovod_tpu_torch.models.train import cross_entropy_loss

    out = {}
    for fused in (True, False):
        model = InceptionV3(fused_bn=fused, seed=0, device="cuda")
        loss = cross_entropy_loss(model(batch["image"]), batch["label"])
        loss.backward()
        out[fused] = {"loss": float(loss.detach()),
                      "grad_norm": _grad_norm(torch, model),
                      "means": [m.mean.clone() for m in _conv_bns(model)]}
        del model, loss
        torch.cuda.empty_cache()
    res = {}
    for key in ("loss", "grad_norm"):
        f, u = out[True][key], out[False][key]
        rel = abs(f - u) / abs(u)
        res[key] = {"fused": f, "unfused": u, "rel_diff": rel}
        check(math.isfinite(f) and math.isfinite(u)
              and rel <= INCEPTION_PARITY_TOL[key],
              f"zoo: Inception V3 fused and unfused {key} differ by "
              f"{rel:.3e} (fused {f}, unfused {u}; rtol "
              f"{INCEPTION_PARITY_TOL[key]})")
    worst = max(float((f - u).abs().max() / u.abs().max().clamp_min(1e-30))
                for f, u in zip(out[True]["means"], out[False]["means"]))
    res["running_mean"] = {"layers": len(out[True]["means"]),
                           "worst_rel_diff": worst}
    check(len(out[True]["means"]) == 94
          and worst <= INCEPTION_PARITY_TOL["running_mean"],
          f"zoo: Inception V3 fused and unfused running means differ by "
          f"{worst:.3e} of a layer's largest over "
          f"{len(out[True]['means'])} layers (tol "
          f"{INCEPTION_PARITY_TOL['running_mean']})")
    return res


def _zoo_train(torch, name, model, batch):
    """``ZOO_STEPS`` bench-lane steps (SGD 0.01 momentum 0.9 under
    ``DistributedOptimizer``, ``average_loss=False``) on one fixed batch:
    the losses are finite and fall, the bucket collectives are the plan's
    each step; the step times, rate, peak memory and K5's launches."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.distributed.fusion import fused_reduce
    from horovod_tpu_torch.models.train import (create_train_state,
                                                make_image_train_step)
    from horovod_tpu_torch.ops import conv_bn as cb

    n_params = sum(p.numel() for p in model.parameters())
    opt = create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        device="cuda")
    step = make_image_train_step(model, opt, average_loss=False)
    plan = hvd.plan_buckets(list(model.parameters()),
                            basics.config().fusion_threshold)
    summary = hvd.plan_summary(plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.bn_stats_forward.launches = 0
    cb.bn_stats_forward.prologue_launches = 0
    fused_reduce.collectives = 0
    losses, times = [], []
    for _ in range(ZOO_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res = {"params": n_params, "plan": summary,
           "launches": cb.bn_stats_forward.launches,
           "prologue_launches": cb.bn_stats_forward.prologue_launches,
           "collectives": fused_reduce.collectives, "losses": losses,
           "step_s": times,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    check(all(math.isfinite(x) for x in losses),
          f"zoo: {name}: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"zoo: {name}: the loss did not fall on a fixed batch: {losses}")
    check(res["collectives"] == len(plan) * ZOO_STEPS,
          f"zoo: {name}: {res['collectives']} bucket collectives, expected "
          f"{len(plan)} buckets x {ZOO_STEPS} steps")
    b = batch["image"].shape[0]
    res["median_step_s"] = sorted(times[1:])[len(times[1:]) // 2]
    res["img_per_s"] = b / res["median_step_s"]
    log(f"zoo: {name}: {n_params} parameters, plan {summary}, losses "
        f"{losses}, step s {[round(t, 4) for t in times]}, median "
        f"{res['median_step_s']:.4f} s = {res['img_per_s']:.1f} img/s per "
        f"card, peak memory {res['peak_memory_bytes'] / 2**30:.2f} GiB, K5 "
        f"{res['launches']} ({res['prologue_launches']} with the "
        f"prologue), {res['collectives']} bucket collectives")
    del opt, step
    return res


def _mnist_run(torch, np):
    """MNISTNet: one bench-lane step and one ``make_eval_step`` call over
    the live train state, float32."""
    from horovod_tpu_torch.models.mnist import MNISTNet
    from horovod_tpu_torch.models.train import (TrainState,
                                                create_train_state,
                                                make_eval_step,
                                                make_image_train_step)

    model = MNISTNet(seed=0, device="cuda")
    opt = create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        device="cuda")
    batch = _zoo_batch(torch, np, 9, MNIST_B, 28, channels=1, classes=10)
    loss = float(make_image_train_step(model, opt, average_loss=False)(
        batch)["loss"])
    ev = make_eval_step(model)(TrainState.from_model(model, opt), batch)
    ev = {k: float(v) for k, v in ev.items()}
    check(math.isfinite(loss) and math.isfinite(ev["loss"])
          and ev["count"] == MNIST_B and 0 <= ev["correct"] <= MNIST_B
          and model.training,
          f"zoo: MNISTNet: step loss {loss}, eval {ev}")
    log(f"zoo: MNISTNet: step loss {loss:.4f}, eval {ev}")
    return {"step_loss": loss, "eval": ev}


def _syncbn_inputs(torch, np, dev, axis_name=None):
    from horovod_tpu_torch.models import resnet

    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal(
        (SYNCBN_B, IMG_SIZE, IMG_SIZE, 3), dtype=np.float32), device=dev)
    y = torch.tensor(rng.integers(0, CLASSES, SYNCBN_B), device=dev)
    model = resnet.build("resnet50", fused_bn=True, axis_name=axis_name,
                         dtype=torch.float32, seed=0, device=dev)
    return model, x, y


def _syncbn_step(torch, model, x, y):
    """One train-mode forward and backward of ``sum(CE) / SYNCBN_B``: the
    loss, the new running means (CPU) and the flat float32 gradient
    (CPU)."""
    from horovod_tpu_torch.ops import conv_bn as cb

    model.train()
    cb.bn_stats_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logp = torch.log_softmax(model(x).float(), -1)
    loss = -logp[torch.arange(len(y), device=x.device), y].sum() / SYNCBN_B
    loss.backward()
    torch.cuda.synchronize()
    return {"loss": float(loss.detach()),
            "step_s": time.perf_counter() - t0,
            "launches": cb.bn_stats_forward.launches,
            "means": [m.mean.cpu() for m in _conv_bns(model)],
            "grad": torch.cat([p.grad.float().reshape(-1)
                               for p in model.parameters()]).cpu()}


def syncbn_rank(argv):
    """``--syncbn-rank RANK WORLD PORT DIR``: one rank of the zoo phase's
    sync-BN world (its own card over NCCL when there are WORLD cards,
    else the first card over gloo): its share of the batch through
    ResNet-50 with ``axis_name="hvd"``; saves its step to
    ``DIR/rank<R>.pt`` and prints ``SYNCBN_RESULT {json}`` last."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port = (int(a) for a in argv[:3])
    own = torch.cuda.device_count() >= world
    dev = torch.device("cuda", rank if own else 0)
    torch.cuda.set_device(dev)
    backend = "nccl" if own else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from horovod_tpu_torch import distributed as hvd

    hvd.init(device=dev)
    try:
        model, x, y = _syncbn_inputs(torch, np, dev, axis_name="hvd")
        rows = slice(rank * SYNCBN_B // world,
                     (rank + 1) * SYNCBN_B // world)
        res = _syncbn_step(torch, model, x[rows], y[rows])
        torch.save(res, os.path.join(argv[3], f"rank{rank}.pt"))
    finally:
        hvd.shutdown()
        dist.destroy_process_group()
    print("SYNCBN_RESULT " + json.dumps(
        {"rank": rank, "backend": backend, "device": str(dev),
         "step_s": res["step_s"], "launches": res["launches"]}), flush=True)


def _syncbn(torch, np):
    """Sync-BN on the card: 2 ranks of 16 images against one of 32."""
    import tempfile

    ref = {}

    def parent():
        model, x, y = _syncbn_inputs(torch, np, "cuda")
        ref.update(_syncbn_step(torch, model, x, y))
        del model, x, y
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ranks = _rank_world("--syncbn-rank", SYNCBN_RANKS, SYNCBN_TIMEOUT_S,
                            tmp, "SYNCBN", parent=parent)
        steps = [torch.load(f"{tmp}/rank{r}.pt") for r in range(SYNCBN_RANKS)]
    loss = sum(s["loss"] for s in steps)
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    mean_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for s in steps for a, b in zip(s["means"], ref["means"]))
    grad = sum(s["grad"].double() for s in steps)
    grad_rel = float((grad - ref["grad"].double()).norm()
                     / ref["grad"].double().norm())
    res = {"ranks": ranks, "batch": SYNCBN_B, "loss": loss,
           "single_loss": ref["loss"], "loss_rel_diff": loss_rel,
           "layers": len(ref["means"]), "running_mean_worst_rel": mean_rel,
           "grad_rel_l2": grad_rel, "single_step_s": ref["step_s"],
           "single_launches": ref["launches"], "tol": SYNCBN_TOL}
    check(all(r["launches"] == 36 for r in ranks) and ref["launches"] == 36,
          f"zoo: sync-BN: K5 launches {[r['launches'] for r in ranks]} "
          f"on the ranks, {ref['launches']} on the single rank, not 36")
    check(math.isfinite(loss) and loss_rel <= SYNCBN_TOL["loss"]
          and mean_rel <= SYNCBN_TOL["running_mean"]
          and grad_rel <= SYNCBN_TOL["grad"],
          f"zoo: sync-BN over {SYNCBN_RANKS} ranks against one rank of "
          f"{SYNCBN_B}: loss {loss} vs {ref['loss']} ({loss_rel:.3e}), "
          f"running means {mean_rel:.3e}, gradients {grad_rel:.3e} "
          f"(tol {SYNCBN_TOL})")
    log(f"zoo: sync-BN, ResNet-50 over {SYNCBN_RANKS} {ranks[0]['backend']} "
        f"ranks of {SYNCBN_B // SYNCBN_RANKS} images against one rank of "
        f"{SYNCBN_B}: loss rel {loss_rel:.3e}, running means {mean_rel:.3e} "
        f"of a layer's largest, summed gradients {grad_rel:.3e} (rel L2)")
    return res


def zoo_phase(torch, np, card):
    """Phase 20: the rest of the model zoo through the image bench lane's
    step at published widths, an NCCL world of one, bf16: Inception V3
    (299^2, fused against unfused, then 3 fused steps with K5 40 times a
    step and never with the prologue), VGG-16 and ViT-B/16 (224^2, 3
    steps each), MNISTNet (one step and one eval step); then
    cross-replica BatchNorm on ResNet-50."""
    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models import build

    t0 = time.perf_counter()
    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"zoo: expected an NCCL world of one, got {dist.get_backend()} x "
          f"{hvd.size()}")
    res = {"card": card, "batch": IMG_B}
    batch = _zoo_batch(torch, np, 10, IMG_B, INCEPTION_SIZE)
    parity = _inception_parity(torch, batch)
    log(f"zoo: Inception V3 fused vs unfused BatchNorm, one step at batch "
        f"{IMG_B}, {INCEPTION_SIZE}^2: {json.dumps(parity)}")
    inc = _zoo_train(torch, "Inception V3", build(
        "inception_v3", fused_bn=True, seed=0, device="cuda"), batch)
    check(inc["launches"] == 40 * ZOO_STEPS and inc["prologue_launches"] == 0,
          f"zoo: Inception V3: K5 launched {inc['launches']} times "
          f"({inc['prologue_launches']} with the prologue), expected 40 x "
          f"{ZOO_STEPS} (0)")
    res["inception_v3"] = {"image_size": INCEPTION_SIZE, "parity": parity,
                           **inc}
    del batch
    torch.cuda.empty_cache()
    batch = _zoo_batch(torch, np, 11, IMG_B, IMG_SIZE)
    for name in ("vgg16", "vit_b16"):
        res[name] = {"image_size": IMG_SIZE, **_zoo_train(
            torch, name, build(name, image_size=IMG_SIZE, seed=0,
                                      device="cuda"), batch)}
        torch.cuda.empty_cache()
    del batch
    res["mnist"] = _mnist_run(torch, np)
    hvd.shutdown()
    torch.cuda.empty_cache()
    res["sync_bn"] = _syncbn(torch, np)
    res["phase_s"] = time.perf_counter() - t0
    log(f"zoo: phase passed in {res['phase_s']:.1f} s")
    return res



# ------------------------------------------------------------- phase 21

#: The harness phase: steps of each momentum dtype on one ResNet-50
#: batch, and the bound their losses are held to, the JAX package's own
#: (tests/test_models.py::test_bf16_momentum_tracks_fp32: bf16 tracks
#: float32 within rtol 0.1 over 5 steps).
HARNESS_STEPS = 4
HARNESS_LOSS_RTOL = 0.1
#: The image lane's SGD.
HARNESS_LR, HARNESS_MOMENTUM = 0.01, 0.9
#: The bfloat16 momentum's update held to its plain version: each step's
#: update over the lane's own gradients against optax's, as a relative
#: norm. The bound lies between the readings it must separate: a sound
#: update differs by float32 arithmetic and rare flips of the stored
#: trace's bfloat16 rounding, while rounding the trace before the update
#: (torch's SGD over a bfloat16 buffer) differs by a bfloat16 rounding of
#: each update, and dropping the momentum by the momentum itself. Both
#: controls run through the same measurement and must exceed it.
HARNESS_UPDATE_RTOL = 1e-4
#: One supervised bench call's limit (a child's CUDA start, the build of
#: its kernels and its steps).
HARNESS_CLI_TIMEOUT_S = 300.0


def _bench_cli(args, env=None):
    """``python -m horovod_tpu_torch.bench ARGS`` as a user runs it, its
    supervisor on: the exit code must be 0 and stdout one JSON record.
    Returns ``(record, stderr, seconds)``."""
    import os

    env = dict(os.environ, **(env or {}))
    for k in ("HOROVOD_RANK", "RANK", "HVD_BENCH_NO_SUPERVISOR"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", *args], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=HARNESS_CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          f"harness: bench {args} exited {proc.returncode} with "
          f"{len(lines)} stdout lines: {proc.stdout[-500:]} "
          f"{proc.stderr[-2000:]}")
    return json.loads(lines[0]), proc.stderr, secs


def _harness_cli():
    """The supervised bench on the card: the probe's record, and a lane
    that fails deterministically (tried once, one record, rc 0); the
    second runs while the first measures, since it fails before it
    touches the card."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        probe = pool.submit(_bench_cli, ["--probe-only"])
        fail = pool.submit(_bench_cli, ["--model", "transformer_lm",
                                        "--fused-bn"],
                           {"HVD_BENCH_ATTEMPTS": "3",
                            "HVD_BENCH_BACKOFF": "1"})
        (prec, _, psecs), (frec, ferr, fsecs) = probe.result(), \
            fail.result()
    check(prec["metric"] == "chip_probe_tflops"
          and prec["unit"] == "TFLOP/s" and prec["value"] is not None
          and prec["value"] > 0 and prec["device"] == "cuda",
          f"harness: the probe's record {prec}")
    check(frec["value"] is None and frec["metric"] == "tokens/sec"
          and "deterministic" in frec["error"]
          and "ValueError" in frec["error"]
          and ferr.count("attempt 1/3") == 1 and "attempt 2/" not in ferr,
          f"harness: the failing lane's record {frec}, stderr "
          f"{ferr[-1500:]}")
    log(f"harness: probe {prec['value']} TFLOP/s on {prec['card']} "
        f"({psecs:.1f} s); the failing lane: one attempt, {frec['error']} "
        f"({fsecs:.1f} s)")
    return {"probe": prec, "probe_s": psecs, "failing_lane": frec,
            "failing_lane_s": fsecs}


def _momentum_steps(torch, batch, bf16):
    """``HARNESS_STEPS`` eager steps of ResNet-50 ``--fused-bn`` (the
    image lane's SGD 0.01 momentum 0.9 under ``DistributedOptimizer``),
    the momentum in bfloat16 (``training.optim.SGD``) or float32
    (``torch.optim.SGD``, the lane without the flag): losses, K5's
    launches, the optimizer state's dtypes and bytes, and each step's
    gradients as the optimizer took them."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models.train import make_image_train_step
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.training import optim

    model = _resnet(torch, True)
    kw = {"lr": HARNESS_LR, "momentum": HARNESS_MOMENTUM}
    sgd = (optim.SGD(model.parameters(), momentum_dtype=torch.bfloat16,
                     **kw) if bf16 else
           torch.optim.SGD(model.parameters(), **kw))
    opt = hvd.DistributedOptimizer(sgd)
    step = make_image_train_step(model, opt, average_loss=False)
    torch.cuda.synchronize()
    cb.bn_stats_forward.launches = 0
    losses, secs, grads = [], [], []
    for _ in range(HARNESS_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        grads.append([p.grad.clone() for p in model.parameters()
                      if p.grad is not None])
    later = sorted(secs[1:])
    res = {"losses": losses, "launches": cb.bn_stats_forward.launches,
           "state": optim.state_bytes(opt), "step_s": secs,
           # the first step builds and tunes: the median of the rest
           "median_step_ms": later[len(later) // 2] * 1e3, "grads": grads}
    del model, opt, step
    torch.cuda.empty_cache()
    return res


def _update_errors(torch, grads, make_opt):
    """Each step's relative error (a norm over every parameter) of an
    optimizer's update over the recorded ``grads`` (one list a step)
    against ``optax.sgd(lr, momentum, accumulator_dtype=bfloat16)``'s.
    The parameters are set to zero before each step, so the step leaves
    ``-lr * update`` in them as float32 holds it, with no parameter's own
    rounding in the way. The plain version runs in float64: the new trace
    from the stored bfloat16 trace and the gradient, the decay rounded to
    bfloat16 (JAX's weakly typed scalar), this step's update the
    unrounded trace, the trace stored rounded."""
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads[0]]
    opt = make_opt(params)
    decay = float(torch.tensor(HARNESS_MOMENTUM, dtype=torch.bfloat16))
    trace = [torch.zeros_like(g, dtype=torch.bfloat16) for g in grads[0]]
    errs = []
    for gs in grads:
        with torch.no_grad():
            for p, g in zip(params, gs):
                p.zero_()
                p.grad = g
        opt.step()
        num = den = 0
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, gs)):
                new = decay * trace[i].double() + g.double()
                trace[i] = new.to(torch.bfloat16)
                num = num + (p.double() / -HARNESS_LR - new).pow(2).sum()
                den = den + new.pow(2).sum()
        errs.append(math.sqrt(float(num / den)))
    return errs


def _update_check(torch, grads):
    """The port's bfloat16-momentum SGD held to optax's update on the
    ResNet-50 lane's gradients, within ``HARNESS_UPDATE_RTOL`` at every
    step, and two wrong updates measured alike that must exceed it:
    torch's SGD over a bfloat16 buffer (the trace rounded before the
    update) and SGD without momentum."""
    from horovod_tpu_torch.training import optim

    kw = {"lr": HARNESS_LR, "momentum": HARNESS_MOMENTUM}

    def rounded_first(params):
        sgd = torch.optim.SGD(params, foreach=False, **kw)
        for p in params:
            sgd.state[p]["momentum_buffer"] = torch.zeros_like(
                p, dtype=torch.bfloat16)
        return sgd

    errs = {
        "port": _update_errors(torch, grads, lambda ps: optim.SGD(
            ps, momentum_dtype=torch.bfloat16, **kw)),
        "rounded_before_update": _update_errors(torch, grads,
                                                rounded_first),
        "no_momentum": _update_errors(torch, grads, lambda ps:
                                      torch.optim.SGD(ps, lr=HARNESS_LR)),
    }
    worst = {k: max(v) for k, v in errs.items()}
    check(worst["port"] <= HARNESS_UPDATE_RTOL
          and worst["rounded_before_update"] > HARNESS_UPDATE_RTOL
          and worst["no_momentum"] > HARNESS_UPDATE_RTOL,
          f"harness: the bf16 momentum's update against optax's, relative "
          f"error by step {errs} (bound {HARNESS_UPDATE_RTOL}: the port "
          f"within, both controls beyond)")
    log(f"harness: bf16 momentum update against optax's, worst step: port "
        f"{worst['port']:.3e}, rounded before the update "
        f"{worst['rounded_before_update']:.3e}, no momentum "
        f"{worst['no_momentum']:.3e} (bound {HARNESS_UPDATE_RTOL})")
    return {"by_step": errs, "worst": worst, "rtol": HARNESS_UPDATE_RTOL}


def _lm_bf16_build(torch, flash, zero):
    """The LM lane with ``--bf16-momentum`` at ``WINDOW_LAYERS`` depth:
    Adam with a bfloat16 first moment, capturable, under hooks or
    ZeRO."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models.train import make_train_step
    from horovod_tpu_torch.training import optim

    def build():
        model = _lm(torch, flash, layers=WINDOW_LAYERS)
        adam = optim.Adam(model.parameters(), lr=1e-4,
                          mu_dtype=torch.bfloat16, capturable=True)
        opt = (hvd.sharded_distributed_optimizer(adam) if zero
               else hvd.DistributedOptimizer(adam, overlap="on"))
        return model, make_train_step(model, opt)

    return build


def _dropout_replays(torch):
    """A captured step that draws one dropout mask: each replay draws a
    fresh mask from the module's generator, registered with the graph,
    and the warm-up and replays draw what eager draws from the same
    seed do, bit for bit; the same step captured without the generator
    registered raises, naming the module."""
    from horovod_tpu_torch._graphs import (CapturedStep, CaptureError,
                                           module_generators)
    from horovod_tpu_torch.models.resnet import Dropout

    x = torch.ones(1 << 16, device="cuda")
    model = torch.nn.Sequential(Dropout(0.5, seed=(21,))).train()
    step = CapturedStep(lambda t: model(t) != 0,
                        generators=module_generators(model), name="dropout")
    masks = [step(x).clone() for _ in range(4)]
    ref = Dropout(0.5, seed=(21,)).train()
    eager = [ref(x) != 0 for _ in range(4)]
    fresh = [bool((masks[i] != masks[i + 1]).any()) for i in range(3)]
    same = [bool(torch.equal(a, b)) for a, b in zip(masks, eager)]
    check(step.captures == 1 and step.replays == 3 and all(fresh)
          and all(same),
          f"harness: dropout under a captured step: {step.captures} "
          f"captures, {step.replays} replays, successive masks differ "
          f"{fresh}, equal to eager draws {same}")
    bare = torch.nn.Sequential(Dropout(0.5, seed=(22,))).train()
    raised = None
    try:
        CapturedStep(lambda t: bare(t), name="bare")(x)
    except CaptureError as e:
        raised = str(e)
    check(raised is not None and "Dropout" in raised,
          f"harness: a capture over an unregistered generator did not "
          f"raise naming the module: {raised}")
    log(f"harness: dropout replays: masks fresh {fresh}, equal to eager "
        f"draws {same}; unregistered: {raised[:160]}")
    return {"fresh_each_replay": fresh, "equal_to_eager": same,
            "keep_share": [float(m.float().mean()) for m in masks],
            "unregistered_raises": raised[:300]}


def harness_phase(torch, np, card, cli=None):
    """Phase 21: the bench's harness and ``--bf16-momentum`` on the card,
    an NCCL world of one: the supervised probe and a deterministically
    failing lane (subprocesses; ``cli``, when the caller ran them
    already); ResNet-50 ``--fused-bn`` at batch 64, bfloat16 against
    float32 momentum over ``HARNESS_STEPS`` steps (the losses within
    ``HARNESS_LOSS_RTOL``, the momentum's bytes halved, K5 36 times a
    step, the update on the lane's gradients within
    ``HARNESS_UPDATE_RTOL`` of optax's), then its bfloat16 window of 2
    against eager steps bit for bit; the LM on flash at ``WINDOW_LAYERS`` depth with Adam's
    first moment in bfloat16, under hooks and under ZeRO, windows against
    eager bit for bit with K1-K3's launches; dropout under a captured
    step, then VGG-16's window of 2 against eager steps bit for bit."""
    import functools

    import torch.distributed as dist

    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.models import build
    from horovod_tpu_torch.models.train import (TrainState,
                                                make_image_train_step)
    from horovod_tpu_torch.ops import attention as fa
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.training import optim

    t0 = time.perf_counter()
    res = {"card": card, **(cli or _harness_cli())}
    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"harness: expected an NCCL world of one, got "
          f"{dist.get_backend()} x {hvd.size()}")
    rng = np.random.default_rng(12)
    batch = {"image": torch.tensor(rng.standard_normal(
                 (IMG_B, IMG_SIZE, IMG_SIZE, 3), dtype=np.float32),
                 device="cuda"),
             "label": torch.tensor(rng.integers(0, CLASSES, IMG_B),
                                   device="cuda")}
    f32 = _momentum_steps(torch, batch, bf16=False)
    b16 = _momentum_steps(torch, batch, bf16=True)
    err = max(abs(a - b) / abs(b) for a, b in zip(b16["losses"],
                                                   f32["losses"]))
    check(all(math.isfinite(x) for x in b16["losses"] + f32["losses"])
          and err <= HARNESS_LOSS_RTOL and b16["losses"][-1]
          < b16["losses"][0],
          f"harness: ResNet-50 losses, bf16 momentum {b16['losses']} "
          f"against float32 {f32['losses']}: rel err {err:.3e} (bound "
          f"{HARNESS_LOSS_RTOL}), or bf16 did not fall")
    check(b16["state"]["dtypes"] == {"momentum_buffer": "bfloat16"}
          and f32["state"]["dtypes"] == {"momentum_buffer": "float32"}
          and 2 * b16["state"]["momentum_buffer"]
          == f32["state"]["momentum_buffer"],
          f"harness: momentum state bf16 {b16['state']} against float32 "
          f"{f32['state']}")
    check(b16["launches"] == f32["launches"] == 36 * HARNESS_STEPS,
          f"harness: K5 launched {b16['launches']} / {f32['launches']} "
          f"times, expected 36 x {HARNESS_STEPS}")
    update = _update_check(torch, b16.pop("grads"))
    del f32["grads"]
    res["resnet"] = {"batch": IMG_B, "steps": HARNESS_STEPS,
                     "bf16": b16, "float32": f32, "loss_rel_err": err,
                     "loss_rtol": HARNESS_LOSS_RTOL, "update": update}
    log(f"harness: ResNet-50 bf16 momentum losses {b16['losses']} against "
        f"float32 {f32['losses']} (rel err {err:.3e}), momentum bytes "
        f"{b16['state']['momentum_buffer']} against "
        f"{f32['state']['momentum_buffer']}, K5 {b16['launches']}")

    def build_resnet():
        model = _resnet(torch, True)
        opt = hvd.DistributedOptimizer(optim.SGD(
            model.parameters(), lr=HARNESS_LR, momentum=HARNESS_MOMENTUM,
            momentum_dtype=torch.bfloat16))
        return model, make_image_train_step(model, opt, average_loss=False)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ab = _window_ab(torch, "resnet bf16 momentum", build_resnet, batch,
                        (cb.bn_stats_forward,),
                        ("conv_bn_bf16_kernel", "nccl"))
        w = ab["window"]
        check(w["launches"] == {"bn_stats_forward": 2 * 36}
              and w["profile"]["counts"]["conv_bn_bf16_kernel"]
              == 36 * WINDOW_K,
              f"harness: resnet bf16 window: K5 wrapper launches "
              f"{w['launches']}, traced {w['profile']['counts']}")
        res["resnet"]["window"] = ab
        del batch
        torch.cuda.empty_cache()

        flash = functools.partial(fa.flash_attention, causal=True,
                                  bwd_impl="kernel")
        tokens = torch.tensor(np.random.default_rng(13).integers(
            0, VOCAB, (FLASH_B, FLASH_L)), device="cuda")
        kernels = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        for lane, zero in (("lm_bf16_mu", False), ("lm_zero_bf16_mu", True)):
            lane_build = _lm_bf16_build(torch, flash, zero)
            model, step = lane_build()
            state = TrainState.from_model(model, step.optimizer)
            leaves = (state["opt_state"]["zero"].values() if zero else
                      [v for k, v in state["opt_state"].items()
                       if isinstance(v, dict)])
            dtypes = sorted({str(st["exp_avg"].dtype) for st in leaves})
            nbytes = optim.state_bytes(step.optimizer)
            check(dtypes == ["torch.bfloat16"]
                  and 2 * nbytes["exp_avg"] == nbytes["exp_avg_sq"],
                  f"harness[{lane}]: first moment {dtypes}, bytes {nbytes}")
            del model, step, state, leaves
            ab = _window_ab(torch, lane, lane_build, tokens, kernels,
                            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            steps = WINDOWS * WINDOW_K
            want = {k.__name__: 2 * WINDOW_LAYERS for k in kernels}
            check(ab["window"]["launches"] == want
                  and ab["eager"]["launches"] == {
                      k: steps * WINDOW_LAYERS for k in want},
                  f"harness[{lane}]: K1-K3 wrapper launches window "
                  f"{ab['window']['launches']} (expected {want}), eager "
                  f"{ab['eager']['launches']} ({steps} x {WINDOW_LAYERS})")
            if zero:
                check(ab["window"]["zero_collectives"] == 2 * 2,
                      f"harness[{lane}]: {ab['window']['zero_collectives']}"
                      " ZeRO collectives issued, expected 2 for each of "
                      "the warm-up and the capture")
            ab["state_bytes"] = nbytes
            res[lane] = ab
            torch.cuda.empty_cache()
        del tokens

        res["dropout"] = _dropout_replays(torch)
        rng = np.random.default_rng(14)
        batch = {"image": torch.tensor(rng.standard_normal(
                     (IMG_B, IMG_SIZE, IMG_SIZE, 3), dtype=np.float32),
                     device="cuda"),
                 "label": torch.tensor(rng.integers(0, CLASSES, IMG_B),
                                       device="cuda")}

        def build_vgg():
            model = build("vgg16", image_size=IMG_SIZE, seed=0,
                          device="cuda")
            opt = hvd.DistributedOptimizer(torch.optim.SGD(
                model.parameters(), lr=0.01, momentum=0.9))
            return model, make_image_train_step(model, opt,
                                                average_loss=False)

        res["vgg16_dropout_window"] = _window_ab(
            torch, "vgg16 dropout", build_vgg, batch, (), ("nccl",))
        del batch
    finally:
        torch.backends.cudnn.deterministic = deterministic
    hvd.shutdown()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    log(f"harness: phase passed in {res['phase_s']:.1f} s")
    return res


# ------------------------------------------------------------- phase 22

#: Each example at its smoke size (the CPU tests' flags): the module,
#: its arguments, and its rank count (None: one process).
EXAMPLES = (
    # 2 ranks of 32: the JAX test's global batch, 8 virtual devices of 8.
    ("mnist", ["--epochs", "3", "--batch-size", "32", "--train-size",
               "2048", "--test-size", "512"], 2),
    ("synthetic_benchmark", ["--num-warmup-batches", "1",
                             "--num-batches-per-iter", "1",
                             "--num-iters", "1"], None),
    ("imagenet_resnet50", ["--smoke", "--epochs", "2",
                           "--steps-per-epoch", "3"], 2),
    ("transformer_zero", ["--smoke"], 2),
    ("word2vec", ["--smoke"], 2),
    ("long_context_ring_attention", ["--smoke"], 2),
    ("gpt_parallel", ["--smoke"], 4),
)
#: The examples that run a second time and resume: the arguments added.
RESUMES = {"imagenet_resnet50": ["--epochs", "3"], "transformer_zero": []}
EXAMPLES_TIMEOUT_S = 400.0
EXAMPLES_CAVEAT = ("the ranks of a multi-rank example share one card over "
                   "gloo when the machine has fewer cards than ranks: "
                   "their seconds time host-staged collectives")


def _example_cmd(name, args, ranks, tmp):
    import os

    if name == "imagenet_resnet50":
        args = args + ["--checkpoint", os.path.join(tmp, "ck.msgpack")]
    if name == "transformer_zero":
        args = args + ["--ckpt-dir", os.path.join(tmp, "zck")]
    cmd = [sys.executable, "-m", f"horovod_tpu_torch.examples.{name}",
           *args]
    if ranks:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
               str(ranks), "--", *cmd]
    return cmd


#: K1-K3's launches in the ring attention example's Ulysses check, on
#: each rank: its smoke model has 2 layers, K1 runs twice a layer (the
#: loss, then the logits) and K2 and K3 once.
EXAMPLE_ULYSSES_LAUNCHES = {"flash_forward": 4, "flash_bwd_dq": 2,
                            "flash_bwd_dkv": 2}


def examples_phase(torch, card):
    """Phase 22: every example at its smoke size on the card, each with
    its own assertions (an example that fails exits non-zero), started
    a second apart: the multi-rank ones under ``python -m
    horovod_tpu_torch.run``, each rank on the card (NCCL when the
    machine has a card a rank, else gloo ranks sharing one); the two
    that resume (ResNet-50's callbacks, ZeRO's checkpoint) run again as
    soon as their first run ends, and must resume. The ring attention
    example's Ulysses check must launch K1-K3
    (``EXAMPLE_ULYSSES_LAUNCHES``). The phase is host-bound (process
    starts), so ``main`` runs it beside the zoo and harness phases."""
    import os
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("HOROVOD_RANK", "RANK", "HVD_BENCH_NO_SUPERVISOR"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    res = {"card": card, "cards": torch.cuda.device_count(),
           "caveat": EXAMPLES_CAVEAT}

    gate = threading.Lock()
    last = [0.0]

    def run(name, args, ranks, tmp):
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        # Launches a second apart: each launcher takes a free port for
        # its rendezvous, and launchers a second apart take distinct
        # ones (the elastic phase staggers its worlds alike).
        with gate:
            time.sleep(max(0.0, last[0] + 1.0 - time.perf_counter()))
            last[0] = time.perf_counter()
        started = time.perf_counter()
        proc = subprocess.Popen(
            _example_cmd(name, args, ranks, d), cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        try:
            out, err = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        return proc.returncode, out, err, time.perf_counter() - started

    def passed(name, got):
        rc, out, err, secs = got
        check(rc == 0, f"examples[{name}]: exit {rc}\n{out[-1500:]}\n"
                       f"{err[-8000:]}")
        log(f"examples[{name}]: passed in {secs:.1f} s: "
            f"{out.strip()[-200:]}")
        return out, err, secs

    def run_and_resume(name, args, ranks, tmp):
        first = run(name, args, ranks, tmp)
        again = (run(name, args + RESUMES[name], ranks, tmp)
                 if name in RESUMES and first[0] == 0 else None)
        return first, again

    runs = {}
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(EXAMPLES)) as pool:
        # The two that run twice start first.
        jobs = {name: pool.submit(run_and_resume, name, args, ranks, tmp)
                for name, args, ranks in sorted(
                    EXAMPLES, key=lambda e: e[0] not in RESUMES)}
        for name, args, ranks in EXAMPLES:
            first, again = jobs[name].result()
            out, err, secs = passed(name, first)
            runs[name] = {"ranks": ranks or 1, "seconds": secs,
                          "stdout_tail": out.strip().splitlines()[-3:]}
            if name in RESUMES:
                rout, rerr, rsecs = passed(f"{name} resumed", again)
                resumed = ("Resuming from epoch 2" in rout
                           if name == "imagenet_resnet50"
                           else "resuming from step 6" in rerr)
                check(resumed, f"examples[{name}]: the second run did not "
                               f"resume:\n{rout[-1000:]}\n{rerr[-1000:]}")
                runs[name]["resume_seconds"] = rsecs
            if name == "long_context_ring_attention":
                line = [l for l in out.splitlines()
                        if l.startswith("ulysses kernel launches ")]
                got = json.loads(line[0].split("launches ", 1)[1]) \
                    if line else None
                check(got == EXAMPLE_ULYSSES_LAUNCHES,
                      f"examples[{name}]: the Ulysses check launched "
                      f"K1-K3 {got} times on rank 0, expected "
                      f"{EXAMPLE_ULYSSES_LAUNCHES}")
                runs[name]["ulysses_launches"] = got
            if name == "mnist":
                accs = [float(line.split("test_acc=")[1].split()[0])
                        for line in out.splitlines() if "test_acc=" in line]
                check(len(accs) == 3 and accs[-1] >= 0.9,
                      f"examples[mnist]: test accuracy {accs}")
                runs[name]["test_acc"] = accs
        rec = json.loads(runs["synthetic_benchmark"]["stdout_tail"][-1])
        check(rec["metric"] == "img/sec" and rec["value"] > 0
              and rec["model"] == "resnet50" and rec["device"] == "cuda"
              and rec["probe_tflops"] is not None,
              f"examples[synthetic_benchmark]: record {rec}")
        runs["synthetic_benchmark"]["record"] = rec
    res["runs"] = runs
    res["phase_s"] = time.perf_counter() - t0
    log(f"examples: phase passed in {res['phase_s']:.1f} s")
    return res


def _ab_summary(ab):
    """A window-against-eager result's numbers: step ms, idle share,
    peak memory, launches, captures and the difference."""
    out = {"max_abs_diff": ab["max_abs_diff"]}
    for kind in ("eager", "window"):
        r = ab[kind]
        out[kind] = {"means": r["means"], "step_ms": r["step_ms"],
                     "idle_share": r["profile"]["idle_share"],
                     "traced": r["profile"]["counts"],
                     "launches": r["launches"],
                     "peak_memory_bytes": r["peak_memory_bytes"],
                     **{k: r[k] for k in ("captures", "replays",
                                          "capture_s", "warmup_s")
                        if k in r}}
    return out


def _harness_summary(res):
    """The ``{"harness"}`` line: the probe, the failing lane, the
    momentum comparison, the windows' numbers and the dropout checks."""
    out = dict(res)
    out["resnet"] = dict(res["resnet"],
                         window=_ab_summary(res["resnet"]["window"]))
    for lane in ("lm_bf16_mu", "lm_zero_bf16_mu"):
        out[lane] = dict(_ab_summary(res[lane]),
                         state_bytes=res[lane]["state_bytes"])
    out["vgg16_dropout_window"] = _ab_summary(res["vgg16_dropout_window"])
    return out


def harness_only(torch, np, card):
    """``--harness-only``: the build and the harness phase."""
    build_phase()
    print(json.dumps({"harness": _harness_summary(
        harness_phase(torch, np, card))}), flush=True)


def examples_only(torch, np, card):
    """``--examples-only``: the build and the examples phase."""
    build_phase()
    print(json.dumps({"examples": examples_phase(torch, card)}), flush=True)


def profile_phase(torch, params, prompts, waves):
    """``--profile``: the engine phase's workload again, per mode, captured
    and eager, and with speculation (captured paged, the half- and the
    full-depth draft), under ``torch.profiler``: device busy time (the sum of
    kernel and copy times; one stream, so they do not overlap), the idle
    share of the profiled wall time, and the kernels that take the most
    device time. The profiler's own host overhead lengthens the wall
    time, so the idle share here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    runs = [(_run_name(m, c), m, c, {}) for m, c in ENGINE_RUNS] + [
        ("spec_paged", "paged", True, {"speculate_k": SPEC_K}),
        ("spec_full_paged", "paged", True,
         {"speculate_k": SPEC_K, "draft_layers": ENGINE_LAYERS})]
    for name, mode, capture, knobs in runs:
        eng = _warm_engine(torch, params, prompts, mode, capture, **knobs)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _serve(torch, eng, waves)
        dev = _device_averages(prof)
        busy_us = sum(e.self_device_time_total for e in dev)
        check(busy_us > 0, f"profile[{name}]: no device events traced")
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = {
            "wall_s": wall, "steps": eng.steps,
            "device_busy_s": busy_us / 1e6,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in top],
        }
        log(f"profile[{name}]: wall {wall:.3f} s, device busy "
            f"{busy_us / 1e6:.3f} s, idle share "
            f"{out[name]['idle_share']:.3f}")
    print(json.dumps({"profile": out}), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- main


def _paged_record(kres, rate, runs, fleet, disagg, tpres, tfres, ptxas,
                  card):
    """The kernels line's entry of K4: launches from the engine phase (the
    captured engine's wrapper calls, counted from its construction: the
    warm-up step and the capture; the eager engine's; and the kernels a
    captured run's trace holds), the times and errors of the f32 serving
    shapes at the top level, bf16 and the long-context geometry beside
    them, and ptxas's registers and spills of each instance of the two
    kernels."""
    paged = runs["paged"]
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bytes", "flops")
    serving, long = kres["serving"], kres["long"]
    f32 = serving["float32"]
    return {
        "name": "paged_attention_decode", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/paged_attention.cu",
        "replaces": "horovod_tpu/ops/paged_attention.py:55",
        "launches": paged["warm_launches"] + paged["launches"],
        "launches_eager": runs["paged_eager"]["launches"],
        "replay_launches": paged["replay_launches"],
        # The speculative lane's draft scan (k = 4, 2 draft layers): the
        # eager run's launches, the captured run's wrapper calls (warm-up
        # + capture) and the kernels its trace holds, with the live ticks.
        "spec_launches_eager": runs["spec_paged_eager"]["launches"],
        "spec_live_ticks_eager": runs["spec_paged_eager"]["live_steps"],
        "spec_launches": (runs["spec_paged"]["warm_launches"]
                          + runs["spec_paged"]["launches"]),
        "spec_replay_launches": runs["spec_paged"]["replay_launches"],
        # The fleet phase: the in-process fleet's wrapper calls (each
        # replica's warm-up step and capture, the relaunched replica's and
        # both rolls' captures) and per replica through the clean run,
        # and the K4 kernels one replayed fleet tick's trace holds.
        "fleet_launches": fleet["inproc"]["fleet_launches"],
        "fleet_launches_per_replica":
            fleet["inproc"]["launches_per_replica"],
        "fleet_tick_replay_launches":
            fleet["inproc"]["tick_trace"]["counts"]["paged_split"],
        # each worker incarnation's own count (warm-up step + capture)
        "fleet_worker_launches":
            [p["decode_launches"] for p in fleet["process"]["worker_decode"]],
        # The disagg phase: the in-process pools fleet's wrapper calls
        # (the decode replica's warm-up step and capture; the relaunched
        # decode replica's after the decode-side tear), the kernels one
        # replayed decode-pool tick's trace holds, and each worker's own
        # count (the prefill worker never decodes).
        "disagg_launches": disagg["launches"]["inproc"],
        "disagg_launches_per_replica":
            disagg["launches"]["inproc_per_replica"],
        "disagg_tick_replay_launches": disagg["launches"]["tick_replay"],
        "disagg_worker_launches": disagg["launches"]["worker"],
        # The tp phase: each rank's launches over its 3-head shard (eager:
        # 12 a live decode tick), with the live ticks.
        "tp_launches_per_rank": tpres["k4_launches"],
        "tp_live_ticks_per_rank": tpres["lane_ticks"],
        # Over NCCL, the captured TP lane's wrapper calls on every rank
        # (warm-up + capture; None over gloo, where it cannot run).
        "tp_captured_launches_per_rank":
            tpres["captured"].get("wrapper_launches"),
        # The tp_fleet phase: the pools' ranks' launches and live ticks
        # over the clean run (prefill ranks, then decode ranks).
        "tp_fleet_launches_per_rank": [
            c["decode_launches"] for r in tfres["rank_delta"] for c in r],
        "tp_fleet_live_ticks_per_rank": [
            c["lane_ticks"] for r in tfres["rank_delta"] for c in r],
        "captured": "the decode lane is one CUDA graph; wrapper calls count "
                    "its warm-up step and capture, replay_launches the "
                    "split kernels a captured run's trace holds",
        **{k: f32[k] for k in keys},
        # ms spans the call (host gaps included); device_ms is the split
        # and merge kernels alone, as the profiler traces them.
        "design": "split-K decode: chunks of R key rows a block (one head "
                  "a block), 16-byte loads by lane groups, every row of a "
                  "chunk in flight at once, exp2 online softmax in "
                  "registers; the chunks' float32 partials merged in chunk "
                  "order by a second kernel, no atomics",
        "dtype": "float32", "shape": serving["shape"],
        "copy_GBps": rate / 1e9,
        "bfloat16": {k: serving["bfloat16"][k] for k in keys},
        "long_context": {"shape": long["shape"],
                         "float32": {k: long["float32"][k] for k in keys},
                         "bfloat16": {k: long["bfloat16"][k] for k in keys}},
        # A tensor-parallel rank's head shard: 6 heads (tp = 2), 3 (tp = 4).
        "tp_shapes": {name: {"shape": kres[name]["shape"],
                             **{d: {k: kres[name][d][k] for k in keys}
                                for d in ("float32", "bfloat16")}}
                      for name, _, heads in K4_SHAPES if heads != HEADS},
        "ptxas": ptxas, "card": card,
    }


def _flash_records(fres, tres, wres, hres, spres, jres, elres, lres,
                   ares, hares, exres, card):
    """The kernels line's entries of K1-K3: launches from the training
    phase, and from the window phase the wrapper calls of a window's
    warm-up and capture and the kernels one replayed window's trace
    holds, from the hier phase rank 0's launches in each variant's
    timed steps, from the sp phase every rank's in the Ulysses step,
    from the job phase every rank's in its steps, from the elastic
    phase every rank's in each attempt of each job (the preempted
    window's: one warm-up step and one capture), and from the loop
    phase run A's wrapper calls (warm-up and capture) and its replayed
    windows' traces, run B's (eager) and run C's, from the autotune phase
    runs A and B (eager) and run C's wrapper calls (a warm-up and a
    capture each), from the harness phase the bfloat16-moment LM's eager
    steps, its window's wrapper calls and one replayed window's trace,
    under hooks and under ZeRO, from the examples phase rank 0's in the
    ring attention example's Ulysses check; times and errors from the
    flash phase at the slice shapes."""
    win = wres["lm_hooks"]["window"]
    traced = {"flash_forward": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
              "flash_bwd_dkv": "flash_bwd_dkv"}
    rows = [("flash_forward", ":179", ("out", "lse")),
            ("flash_bwd_dq", ":533", ("dq",)),
            ("flash_bwd_dkv", ":599", ("dk", "dv"))]
    out = []
    for i, (name, line, outs) in enumerate(rows):
        # bf16 K1-K3 run the tensor-core designs (float32 the CUDA-core
        # ones).
        design = ("wgmma m64n64k16 tensor-core forward: 128 query rows a "
                  "block, online softmax in registers, cp.async K/V ring"
                  if name == "flash_forward"
                  else "wgmma m64n64k16 + cp.async ring")
        r = fres[name]
        out.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"horovod_tpu/ops/attention.py{line}",
            "launches": tres["launches"][name],
            "launches_remat_step": tres["remat"]["launches"][name],
            "launches_window": win["launches"][name],
            "replay_launches": win["profile"]["counts"][traced[name]],
            "replay_window_steps": WINDOW_K,
            "launches_hier_rank0": {
                v: r["launches"][name]
                for v, r in hres.get("variants", {}).items()},
            "launches_sp_ulysses": [l[name] for l in
                                    spres["ulysses"]["launches"]],
            "sp_ulysses_shape": spres["ulysses"]["k1_shape"],
            "launches_job": [l[name] for l in jres["launches"]],
            "launches_elastic": {
                tag: [[a[i] for a in rank] for rank in runs]
                for tag, runs in elres["launches"].items()},
            "launches_loop": {
                "run_a_wrapper_calls": lres["run_a"]["launches"][name],
                "run_a_traced": lres["run_a"]["traced"][traced[name]],
                "run_a_traced_replayed_steps":
                    lres["run_a"]["traced_replayed_steps"],
                "run_b_eager": lres["run_b"]["launches"][name],
                "run_c_wrapper_calls": lres["run_c"]["launches"][name]},
            "launches_autotune": {
                "run_a_eager": ares["run_a"]["launches"][name],
                "run_b_eager": ares["run_b"]["launches"][name],
                "run_c_wrapper_calls": ares["run_c"]["launches"][name],
                "run_c_captures": ares["run_c"]["captures"]},
            "launches_harness": {
                lane: {"eager": hares[lane]["eager"]["launches"][name],
                       "window_wrapper_calls":
                           hares[lane]["window"]["launches"][name],
                       "window_traced": hares[lane]["window"]["profile"][
                           "counts"][traced[name]]}
                for lane in ("lm_bf16_mu", "lm_zero_bf16_mu")},
            "launches_examples": exres["runs"][
                "long_context_ring_attention"]["ulysses_launches"][name],
            "sp_ulysses_max_abs_err": max(
                spres["ulysses"]["kernel_check"]["max_abs_err"][o]
                for o in outs),
            "max_abs_err": max(r["max_abs_err"][o] for o in outs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"library_covers": "flash_bwd_dq + flash_bwd_dkv"}
               if name != "flash_forward" else {}),
            "design": design, "dtype": "bfloat16",
            "shape": {"B": FLASH_B, "L": FLASH_L, "H": HEADS,
                      "D": HEAD_DIM, "causal": True},
            "flops": r["flops"], "bytes": r["bytes"], "card": card,
        })
    return out


def _conv_bn_record(cres, rres, wres, zres, hares, card):
    """The kernels line's entry of K5: launches from the ResNet phase (36
    a step), from the window phase (a window's warm-up and capture, and
    one replayed window's trace) and from the harness phase (each
    momentum dtype's eager steps, and the bfloat16 window's wrapper calls
    and trace), the times and the bound summed over
    one step's 36 launches at the ResNet-50 shapes, each shape's own
    numbers beside them; the same for Inception V3's geometry (40
    launches a step in the zoo phase, at its 299^2 shapes)."""
    st = cres["step"]
    win = wres["resnet"]["window"]
    return {
        "name": "bn_stats_forward", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/conv_bn.cu",
        "replaces": "horovod_tpu/ops/conv_bn.py:77",
        "launches": rres["launches"],
        "max_abs_err": st["max_abs_err"],
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": st["library_ms"],
        # ms spans the calls (host gaps included); device_ms is K5's two
        # kernels alone, as the profiler traces them.
        "device_ms": st["device_ms"],
        "library": "torch.matmul + y.float().sum(0) + "
                   "y.float().square().sum(0), behind the prologue's "
                   "relu(x*a+b)",
        "times_cover": "one ResNet-50 training step's 36 launches "
                       "(batch 64, 224^2, bf16)",
        "prologue_launches": rres["prologue_launches"],
        "launches_window": win["launches"]["bn_stats_forward"],
        "replay_launches": win["profile"]["counts"]["conv_bn_bf16_kernel"],
        "replay_window_steps": WINDOW_K,
        "launches_harness": {
            "bf16_momentum_eager": hares["resnet"]["bf16"]["launches"],
            "float32_momentum_eager": hares["resnet"]["float32"]["launches"],
            "eager_steps": HARNESS_STEPS,
            "bf16_window_wrapper_calls":
                hares["resnet"]["window"]["window"]["launches"][
                    "bn_stats_forward"],
            "bf16_window_traced":
                hares["resnet"]["window"]["window"]["profile"]["counts"][
                    "conv_bn_bf16_kernel"]},
        "design": "wgmma m64nBNk16 tensor-core kernel: 128-row M tiles of "
                  "two warpgroups, 64-deep swizzled K slices through a "
                  "cp.async ring, the prologue applied in shared memory, "
                  "y staged and stored in 16-byte chunks",
        "dtype": "bfloat16", "flops": st["flops"], "bytes": st["bytes"],
        "shapes": cres["shapes"], "card": card,
        "inception_v3": {
            "launches": zres["inception_v3"]["launches"],
            "prologue_launches": zres["inception_v3"]["prologue_launches"],
            "times_cover": "one Inception V3 training step's 40 launches "
                           "(batch 64, 299^2, bf16)",
            **{k: cres["inception_v3"]["step"][k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "flops", "bytes")},
            "shapes": cres["inception_v3"]["shapes"]},
    }


def _window_summary(wres, runs, card):
    """Eager against captured on the card: each training lane's step ms,
    idle share (one profiled window of each), peak memory, and the
    window's capture and warm-up seconds; the engine's tokens/s, TTFT and
    per-token latency per attention mode."""
    out = {"card": card, "steps_per_window": WINDOW_K}
    for lane, ab in wres.items():
        e, w = ab["eager"], ab["window"]
        out[lane] = {
            "step_ms": {"eager": e["step_ms"], "window": w["step_ms"]},
            "idle_share": {"eager": e["profile"]["idle_share"],
                           "window": w["profile"]["idle_share"]},
            "peak_memory_bytes": {"eager": e["peak_memory_bytes"],
                                  "window": w["peak_memory_bytes"]},
            "capture_s": w["capture_s"], "warmup_s": w["warmup_s"],
            "max_abs_diff": ab["max_abs_diff"]}
    for name, r in runs.items():
        st = r["stats"]
        out[f"engine_{name}"] = {
            "tokens_per_sec": st["tokens_per_sec_per_chip"],
            "ttft_ms": st["ttft_ms"], "tbt_ms": st["tbt_ms"],
            "wall_s": r["wall"], "capture_s": r.get("capture_s")}
    return out


def engine_only(torch, np):
    """``--engine-only [RUNS]``: the engine phase RUNS times."""
    args = sys.argv[sys.argv.index("--engine-only") + 1:]
    runs = int(args[0]) if args and args[0].isdigit() else 3
    out = []
    for _ in range(runs):
        res, params, prompts, waves = engine_phase(torch, np)
        out.append({name: {
            "tokens_per_sec": r["stats"]["tokens_per_sec_per_chip"],
            "ttft_ms": r["stats"]["ttft_ms"], "tbt_ms": r["stats"]["tbt_ms"],
            "wall_s": r["wall"], "steps": r["steps"],
            "launches": r["launches"], "replays": r.get("replays")}
            for name, r in res.items()})
    print(json.dumps({"engine_runs": out}), flush=True)
    if "--profile" in sys.argv[1:]:
        profile_phase(torch, params, prompts, waves)


def fleet_only(torch, np, card):
    """``--fleet-only [RUNS]``: the fleet phase RUNS times, beside one
    captured paged engine run at the same geometry."""
    from horovod_tpu_torch.models.parallel_lm import init_lm_params

    args = sys.argv[sys.argv.index("--fleet-only") + 1:]
    n = int(args[0]) if args and args[0].isdigit() else 1
    build_phase()
    params = init_lm_params(0, VOCAB, LMAX, FLEET_LAYERS, HEADS, HEAD_DIM, FFN,
                            device="cuda")
    prompts, waves = _requests(np)
    _, single = _serve_run(torch, params, prompts, waves, "paged", "paged",
                           True)
    out = [fleet_phase(torch, np, params, prompts, waves, single, card)[0]
           for _ in range(n)]
    print(json.dumps({"fleet_runs": out}), flush=True)


def disagg_only(torch, np, card):
    """``--disagg-only [RUNS]``: the disagg phase RUNS times, beside one
    captured paged engine run at the same geometry; the colocated
    in-process fleet runs inside each."""
    from horovod_tpu_torch.models.parallel_lm import init_lm_params

    args = sys.argv[sys.argv.index("--disagg-only") + 1:]
    n = int(args[0]) if args and args[0].isdigit() else 1
    build_phase()
    params = init_lm_params(0, VOCAB, LMAX, FLEET_LAYERS, HEADS, HEAD_DIM, FFN,
                            device="cuda")
    prompts, waves = _requests(np)
    _, single = _serve_run(torch, params, prompts, waves, "paged", "paged",
                           True)
    out = [disagg_phase(torch, np, params, prompts, waves, single, card)
           for _ in range(n)]
    print(json.dumps({"disagg_runs": out}), flush=True)


def hier_only(torch, np, card):
    """``--hier-only``: the build and the hier phase."""
    build_phase()
    print(json.dumps({"hier": hier_phase(torch, np, card)}), flush=True)


def tp_only(torch, np, card):
    """``--tp-only``: the build, the reference runs and the tp phase."""
    prompts, waves, ref = _tp_only_references(torch, np)
    res = tp_phase(torch, np, prompts, waves, card, ref)
    print(json.dumps({"tp": res}), flush=True)


def _tp_only_references(torch, np):
    """The build, the requests and the TP phases' reference runs, for
    ``--tp-only`` and ``--tp-fleet-only``."""
    build_phase()
    prompts, waves = _requests(np)
    return prompts, waves, tp_references(torch, np, prompts, waves)


def tp_fleet_only(torch, np, card):
    """``--tp-fleet-only``: the build, the reference runs and phase 13b."""
    prompts, waves, ref = _tp_only_references(torch, np)
    res = tp_fleet_phase(torch, np, prompts, waves, ref, card)
    print(json.dumps({"tp_fleet": res}), flush=True)


def sp_only(torch, np, card):
    """``--sp-only``: the build and the sp/pp phase."""
    build_phase()
    print(json.dumps({"sp": sp_phase(torch, np, card)}), flush=True)


def ep_only(torch, np, card):
    """``--ep-only``: the build and the ep phase."""
    build_phase()
    print(json.dumps({"ep": ep_phase(torch, np, card)}), flush=True)


def job_only(torch, np, card):
    """``--job-only``: the build and the job phase."""
    build_phase()
    print(json.dumps({"job": job_phase(torch, np, card)}), flush=True)


def loop_only(torch, np, card):
    """``--loop-only``: the build and the loop phase."""
    build_phase()
    print(json.dumps({"loop": loop_phase(torch, np, card)}), flush=True)


def zoo_only(torch, np, card):
    """``--zoo-only``: the build and the zoo phase."""
    build_phase()
    print(json.dumps({"zoo": zoo_phase(torch, np, card)}), flush=True)


def autotune_only(torch, np, card):
    """``--autotune-only``: the build and the autotune phase."""
    build_phase()
    print(json.dumps({"autotune": autotune_phase(torch, np, card)}),
          flush=True)


def elastic_only(torch, np, card):
    """``--elastic-only``: the build and the elastic phase."""
    build_phase()
    rate = _copy_rate(torch)
    print(json.dumps({"elastic": elastic_phase(torch, np, card, rate)}),
          flush=True)


def main():
    if "--hier-rank" in sys.argv[1:]:
        return hier_rank(sys.argv[sys.argv.index("--hier-rank") + 1:])
    if "--tp-rank" in sys.argv[1:]:
        return tp_rank(sys.argv[sys.argv.index("--tp-rank") + 1:])
    if "--sp-rank" in sys.argv[1:]:
        return sp_rank(sys.argv[sys.argv.index("--sp-rank") + 1:])
    if "--ep-rank" in sys.argv[1:]:
        return ep_rank(sys.argv[sys.argv.index("--ep-rank") + 1:])
    if "--comm-rank" in sys.argv[1:]:
        return comm_rank(sys.argv[sys.argv.index("--comm-rank") + 1:])
    if "--elastic-rank" in sys.argv[1:]:
        return elastic_rank(sys.argv[sys.argv.index("--elastic-rank") + 1:])
    if "--syncbn-rank" in sys.argv[1:]:
        return syncbn_rank(sys.argv[sys.argv.index("--syncbn-rank") + 1:])
    import numpy as np
    import torch

    card = device_phase(torch)
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script "
                           f"({e}); run from the root of a checkout")
    if "--engine-only" in sys.argv[1:]:
        return engine_only(torch, np)
    if "--fleet-only" in sys.argv[1:]:
        return fleet_only(torch, np, card)
    if "--disagg-only" in sys.argv[1:]:
        return disagg_only(torch, np, card)
    if "--hier-only" in sys.argv[1:]:
        return hier_only(torch, np, card)
    if "--tp-only" in sys.argv[1:]:
        return tp_only(torch, np, card)
    if "--tp-fleet-only" in sys.argv[1:]:
        return tp_fleet_only(torch, np, card)
    if "--sp-only" in sys.argv[1:]:
        return sp_only(torch, np, card)
    if "--ep-only" in sys.argv[1:]:
        return ep_only(torch, np, card)
    if "--job-only" in sys.argv[1:]:
        return job_only(torch, np, card)
    if "--elastic-only" in sys.argv[1:]:
        return elastic_only(torch, np, card)
    if "--loop-only" in sys.argv[1:]:
        return loop_only(torch, np, card)
    if "--autotune-only" in sys.argv[1:]:
        return autotune_only(torch, np, card)
    if "--zoo-only" in sys.argv[1:]:
        return zoo_only(torch, np, card)
    if "--harness-only" in sys.argv[1:]:
        return harness_only(torch, np, card)
    if "--examples-only" in sys.argv[1:]:
        return examples_only(torch, np, card)
    profile = "--profile" in sys.argv[1:]
    t_start = t_phase = time.perf_counter()

    def timed(name, result):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase:.1f} s")
        t_phase = now
        return result

    ptxas = timed("build", build_phase())
    kres, rate = timed("kernels", kernel_phase(torch, np))
    fres = timed("flash", flash_phase(torch, np))
    cres = timed("conv_bn", conv_bn_phase(torch, np))
    tres = timed("training", training_phase(torch, np, profile))
    rres = timed("resnet", resnet_phase(torch, np, profile))
    wres = timed("window", window_phase(torch, np))
    runs, params, prompts, waves = timed("engine",
                                         engine_phase(torch, np))
    tpref = timed("tp_references", tp_references(torch, np, prompts,
                                                 waves))
    cut = tpref["old"]["params"]
    fleet, colo_reqs = timed("fleet", fleet_phase(
        torch, np, cut, prompts, waves, tpref["old"], card))
    disagg = timed("disagg", disagg_phase(
        torch, np, cut, prompts, waves, tpref["old"], card,
        colocated={"reqs": colo_reqs, "inproc": fleet["inproc"]["clean"],
                   "process": fleet["process"]["clean"]}))
    del cut
    hres = timed("hier", hier_phase(torch, np, card))
    tpres = timed("tp", tp_phase(torch, np, prompts, waves, card, tpref))
    tfres = timed("tp_fleet", tp_fleet_phase(torch, np, prompts, waves,
                                             tpref, card))
    del tpref["old"]["params"], tpref
    spres = timed("sp", sp_phase(torch, np, card))
    epres = timed("ep", ep_phase(torch, np, card))
    jres = timed("job", job_phase(torch, np, card))
    elres = timed("elastic", elastic_phase(torch, np, card, rate,
                                           cli=jres["elastic_cli"]))
    lres = timed("loop", loop_phase(torch, np, card))
    ares = timed("autotune", autotune_phase(torch, np, card))
    # The harness's supervised probe first, on a quiet card; then the
    # host-bound examples (process starts) run beside the zoo and the
    # rest of the harness, whose checks hold whatever the load (their
    # step times are taken beside the examples).
    from concurrent.futures import ThreadPoolExecutor

    cli = timed("harness_cli", _harness_cli())
    with ThreadPoolExecutor(1) as beside:
        examples = beside.submit(examples_phase, torch, card)
        zres = timed("zoo", zoo_phase(torch, np, card))
        hares = timed("harness", harness_phase(torch, np, card, cli=cli))
        exres = timed("examples (the rest)", examples.result())
    if profile:
        profile_phase(torch, params, prompts, waves)
    print(json.dumps({"window": _window_summary(wres, runs, card)}),
          flush=True)
    print(json.dumps({"training": {
        k: v for k, v in tres.items() if not k.startswith("profile")}}),
        flush=True)
    print(json.dumps({"resnet": {k: v for k, v in rres.items()
                                 if k != "profile"}}), flush=True)
    print(json.dumps({"fleet": fleet}), flush=True)
    print(json.dumps({"disagg": disagg}), flush=True)
    print(json.dumps({"hier": hres}), flush=True)
    print(json.dumps({"tp": tpres}), flush=True)
    print(json.dumps({"tp_fleet": tfres}), flush=True)
    print(json.dumps({"sp": spres}), flush=True)
    print(json.dumps({"ep": epres}), flush=True)
    print(json.dumps({"job": jres}), flush=True)
    print(json.dumps({"elastic": elres}), flush=True)
    print(json.dumps({"loop": lres}), flush=True)
    print(json.dumps({"autotune": ares}), flush=True)
    print(json.dumps({"zoo": zres}), flush=True)
    print(json.dumps({"harness": _harness_summary(hares)}), flush=True)
    print(json.dumps({"examples": exres}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    record = {"kernels": [
        _paged_record(kres, rate, runs, fleet, disagg, tpres, tfres,
                      ptxas.get("paged_attention", {}), card),
        *_flash_records(fres, tres, wres, hres, spres, jres, elres, lres,
                        ares, hares, exres, card),
        _conv_bn_record(cres, rres, wres, zres, hares, card)]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
