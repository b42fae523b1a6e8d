"""Training benchmark of the port: the transformer_lm and image lanes of
the JAX package's ``bench.py``, on the card.

    python -m horovod_tpu_torch.bench --model transformer_lm \\
        [--attention dense|flash] [--seq-len 2048] [--batch-size 8] ...
    python -m horovod_tpu_torch.bench --model resnet50 [--fused-bn] \\
        [--image-size 224] [--batch-size 64] ...
    python -m horovod_tpu_torch.bench --model inception_v3|vgg16|vit_b16 ...

One process per card (``torchrun`` sets the world; alone it is a world of
one). The reference's timing discipline: ``--num-warmup-batches`` steps,
then ``--num-iters`` windows of ``--num-batches-per-iter`` steps with one
``torch.cuda.synchronize()`` per window. Prints one JSON line: the rate
per card (the mean over the windows, with the 1.96-sigma spread and the
best window), the step time, the peak memory, the bucket plan, whether
every rank ends with the same parameters, and the card's name and power
limit.

* ``transformer_lm`` (the default): ``TransformerLM`` at the JAX lane's
  defaults (GPT-2-small width: 12 layers, d_model 768, 12 heads, vocab
  32000, seq 2048, 8 sequences per card, bfloat16 compute, float32
  parameters), ``torch.optim.Adam(lr=1e-4)`` under
  ``DistributedOptimizer``, the mean next-token loss, on one fixed batch
  of random tokens from a numpy seed; tokens/s per card. The JAX lane's
  step flags: ``--fused-ce`` (the chunked fused cross-entropy, no
  ``[B, L, V]`` logits), ``--zero`` (ZeRO-1 optimizer-state sharding;
  ``--overlap`` does not apply), ``--remat`` (each block recomputed in
  the backward pass), and with flash attention ``--flash-bwd
  {auto,scan,pallas,kernel}`` (``pallas`` is the JAX spelling of
  ``kernel``). ``--attention auto`` takes flash at every length, the
  H100's measured crossover (:func:`resolve_attention`).
* the image models of the zoo (``models.build``: ``resnet18|34|50|101|
  152``, ``inception_v3`` (alias ``inception3``), ``vgg11|13|16|19``,
  ``vit_s16|vit_b16``): the JAX lane's image defaults (224x224x3
  synthetic images and 1000 classes from a numpy seed, 64 images per
  card, bfloat16 compute with float32 parameters and BatchNorm
  statistics, ``torch.optim.SGD(lr=0.01, momentum=0.9)`` under
  ``DistributedOptimizer``, the per-rank loss as with the JAX lane's
  ``average_loss=False``); images/s per card. ``--fused-bn`` (the ResNet
  and Inception families) runs every training-mode 1x1 ConvBN through
  kernel K5.

Both lanes take ``--steps-per-dispatch K``: each timed iteration runs
``--num-batches-per-iter`` windows of K steps (the warm-up
``--num-warmup-batches`` windows), each step a CUDA graph replay of one
captured step (:mod:`horovod_tpu_torch.distributed.window`; Adam is built
with ``capturable=True`` on the card), and the units count the K steps.
Its metric and unit carry the JAX lane's ``_winK`` suffix
(``tokens/sec_win10``, ``img/sec/card_win10``) and the record stamps
``"window": K``, so a window record never stands where a per-step record
should; ``K = 1`` is the per-step lane and its record as they were.

Both lanes take ``--hierarchical auto|on|off`` (each gradient bucket as
the intra-host reduce-scatter / inter-host exchange / intra-host
all-gather ladder; the inner size is ``HOROVOD_HIERARCHICAL_INNER_SIZE``,
else the ranks per host) and ``--compression int8|fp8`` (the ladder's
inter-host leg quantized, with error feedback; lossless where no ladder
runs). The record carries ``"hierarchical": {"mode", "inner"}`` and
``"wire"``, the ladder's per-leg bytes (``fusion.hier_wire_summary``;
null where the ladder does not engage, and both null under ``--zero``),
and the same line goes to stderr as in the JAX lane::

    torchrun --nproc_per_node 8 -m horovod_tpu_torch.bench \
        --hierarchical on --compression int8

``--snapshot-every N`` measures the elastic snapshot's cost before the
timed windows: the min over three synchronous host-RAM snapshots
(:class:`horovod_tpu_torch.elastic.Snapshotter`) of the model's
parameters and the optimizer's state tensors, and stamps
``{"snapshot": {"every", "ms_per_snapshot", "overhead_pct"}}``, the
overhead as a share of N steps' time (``{"snapshot": null}`` when off).

``--bf16-momentum`` keeps the optimizer's momentum in bfloat16, as the
JAX lanes' ``accumulator_dtype``/``mu_dtype`` do
(:mod:`horovod_tpu_torch.training.optim`): the image lane's SGD momentum
buffer and the LM lane's Adam first moment (its second moment stays
float32); the parameters stay float32. Every record stamps
``"opt_state_dtype"`` (``{"momentum": ...}`` or ``{"mu": ..., "nu":
...}``) and ``"opt_state_bytes"``, this rank's optimizer state.

The harness around the lanes, as in the JAX ``bench.py``:

* **the supervisor** (:func:`supervise`): run alone, the command runs the
  measurement in a child process (``--_child --_emit FILE``, in a session
  of its own) with an attempt timeout, retries and a doubling backoff
  (``HVD_BENCH_ATTEMPTS`` 4, ``HVD_BENCH_ATTEMPT_TIMEOUT`` 600 s,
  ``HVD_BENCH_BACKOFF`` 20 s). The child sorts its own failure: exit 3
  where a retry would fail the same way (a usage error of the lane, CUDA
  out of memory, any error not named transient), exit 1 where it might
  not; it leaves its exception's text in ``FILE.err``. Neither exit 2
  (argparse) nor 3 is retried. SIGTERM or SIGINT kills the child's
  process group. Every outcome prints exactly one JSON line on stdout
  and exits 0: on failure ``"value": null`` with an ``"error"`` and the
  metric and unit the success would have carried
  (:func:`metric_contract`). Under a launcher (``HOROVOD_RANK``, or
  torchrun's ``RANK``) and with ``HVD_BENCH_NO_SUPERVISOR`` set the lane
  runs in the process itself, as before;
* **the chip probe** (:func:`probe_chip`): chained bfloat16 ``n^3``
  matmuls, the marginal rate over two chain lengths (4096, 25 and 100 on
  the card, timed with CUDA events; 512, 2 and 6 on the CPU), stamped as
  ``"probe_tflops"`` in every record after the timed windows (``null``
  when the longer chain did not take longer); ``--probe-only`` prints a
  ``chip_probe_tflops`` record alone;
* ``--mesh dp=8,tp=4``: parsed as argparse reads it
  (``parallel.logical.parse_mesh_config``), stamped in its canonical
  spelling as ``"mesh"`` (``null`` when not given, error records
  included); an invalid config is a usage error;
* ``--compile-only``: builds the lane (its CUDA kernels are built at
  their first launch, in the first step), times one first step as
  ``<model>_first_step_secs`` (unit ``secs``, with ``_winK`` for a
  window) and exits;
* the aliases ``--d-model`` (for ``--lm-dim``) and ``--flash-attention``
  (for ``--attention flash``);
* ``--device cuda|cpu`` (default ``cuda``): where the lane runs; nothing
  falls back to the CPU by itself.

Flags of one lane given to the other raise, as in the JAX ``bench.py``;
so do the flash-only flags without flash. The JAX flags the port has not
taken (``--scan-layers``, and ``--flash-full-grid``: K1-K3 have no
full-grid mode) are parsed and raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from horovod_tpu_torch import models
from horovod_tpu_torch._device import DeviceLike, resolve_device
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.distributed.compression import Compression
from horovod_tpu_torch.distributed.fusion import (hier_wire_summary,
                                                  plan_buckets, plan_summary,
                                                  resolve_hierarchical)
from horovod_tpu_torch.distributed.mpi_ops import allgather
from horovod_tpu_torch.distributed.window import stage_synthetic_window
from horovod_tpu_torch.distributed.zero import shard_info
from horovod_tpu_torch.models.train import (create_train_state,
                                            make_image_train_step,
                                            make_train_step)
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.ops.attention import (flash_attention,
                                             flash_grid_info,
                                             resolve_bwd_impl)
from horovod_tpu_torch.parallel.logical import (format_mesh_config,
                                                parse_mesh_config)
from horovod_tpu_torch.training import optim

#: Exit code of a supervised child whose failure a retry would repeat.
RC_DETERMINISTIC = 3
#: Words of an exception's text that mark a failure a retry may cure.
TRANSIENT_MARKERS = ("unavailable", "deadline", "timed out", "timeout",
                     "connect", "nccl")


LM = "transformer_lm"
IMAGE_MODELS = sorted(k for k in models._FAMILY if k != LM)


class _Parser(argparse.ArgumentParser):
    """Fills the lane-dependent defaults: 8 sequences or 64 images per
    card, and dense attention for the LM."""

    def parse_known_args(self, args=None, namespace=None):
        ns, rest = super().parse_known_args(args, namespace)
        if ns.flash_attention:
            if ns.attention not in (None, "flash"):
                self.error(f"--flash-attention conflicts with --attention "
                           f"{ns.attention}")
            ns.attention = "flash"
        if ns.batch_size is None:
            ns.batch_size = 8 if ns.model == LM else 64
        if ns.attention is None and ns.model == LM:
            ns.attention = "dense"
        return ns, rest


def _mesh_config(text: str) -> str:
    """argparse type of ``--mesh``: the canonical spelling of a valid
    config; an invalid one is a usage error."""
    try:
        return format_mesh_config(parse_mesh_config(text))
    except Exception as e:
        raise argparse.ArgumentTypeError(str(e))


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default=LM, choices=[LM, *IMAGE_MODELS])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the lane runs (default the card)")
    p.add_argument("--mesh", default=None, type=_mesh_config,
                   help="the logical mesh config this lane ran under, "
                        "e.g. 'dp=8,tp=4': stamped in its canonical "
                        "spelling as the record's \"mesh\"")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=None,
                   help="sequences (default 8) or images (default 64) per "
                        "card")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--fused-bn", action="store_true",
                   help="ResNet and Inception families: BatchNorm "
                        "statistics in the 1x1 convs' matmul epilogue "
                        "(kernel K5)")
    p.add_argument("--lm-layers", type=int, default=12)
    p.add_argument("--lm-dim", type=int, default=768)
    p.add_argument("--d-model", dest="lm_dim", type=int,
                   default=argparse.SUPPRESS, help="alias for --lm-dim")
    p.add_argument("--lm-heads", type=int, default=12)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--attention", default=None,
                   choices=["dense", "flash", "auto"],
                   help="transformer_lm attention (default dense)")
    p.add_argument("--flash-attention", action="store_true",
                   help="alias for --attention flash")
    p.add_argument("--fp32", action="store_true",
                   help="float32 compute (default bfloat16)")
    p.add_argument("--fused-ce", action="store_true",
                   help="transformer_lm: chunked fused cross-entropy "
                        "(ops/xent.py), no [B, L, vocab] logits")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 optimizer-state sharding over the ranks "
                        "(distributed/zero.py); --overlap does not apply")
    p.add_argument("--remat", action="store_true",
                   help="transformer_lm: recompute each block in the "
                        "backward pass")
    p.add_argument("--flash-bwd", default=None,
                   choices=["auto", "scan", "pallas", "kernel"],
                   help="transformer_lm + flash: the backward (pallas is "
                        "the JAX spelling of kernel, K2 + K3; auto takes "
                        "the H100's measured crossover)")
    p.add_argument("--overlap", default=None, choices=["auto", "on", "off"],
                   help="HOROVOD_OVERLAP for the gradient buckets; on "
                        "starts each bucket from gradient hooks during "
                        "the backward pass")
    p.add_argument("--compression", default="none",
                   choices=["none", "fp16", "bf16", "int8", "fp8"],
                   help="gradient wire compression: fp16/bf16 cast every "
                        "leg; int8/fp8 quantize only the hierarchical "
                        "inter-host leg (lossless without the ladder)")
    p.add_argument("--hierarchical", default=None,
                   choices=["auto", "on", "off"],
                   help="HOROVOD_HIERARCHICAL for the gradient buckets: "
                        "the intra-host / inter-host ladder; the record "
                        "stamps its inner size and per-leg wire bytes")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K steps a window, each a CUDA graph replay of "
                        "one captured step (distributed/window.py); the "
                        "metric and unit carry _winK")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="measure the elastic snapshot's cost at this "
                        "cadence (steps between host-RAM snapshots) and "
                        "stamp {'every', 'ms_per_snapshot', "
                        "'overhead_pct'} as 'snapshot'; 0 (default) = off")
    p.add_argument("--bf16-momentum", action="store_true",
                   help="keep the SGD momentum (image lane) or Adam's "
                        "first moment (LM lane) in bfloat16; parameters "
                        "stay float32 (training/optim.py)")
    p.add_argument("--compile-only", action="store_true",
                   help="build the lane and time one first step (metric "
                        "<model>_first_step_secs), then exit")
    p.add_argument("--probe-only", action="store_true",
                   help="print only the chip probe's record (metric "
                        "chip_probe_tflops)")
    # The JAX lane's flags that the port does not take: parsed, and each
    # raises NotImplementedError naming its ROADMAP.md item.
    p.add_argument("--scan-layers", action="store_true")
    p.add_argument("--flash-full-grid", action="store_true")
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    # The supervisor's plumbing: a supervised attempt, and the file it
    # writes its record to.
    p.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--_emit", default="", help=argparse.SUPPRESS)
    return p


def card_description(dev: torch.device) -> str:
    """``name, power limit`` as ``nvidia-smi`` reports them (the card's
    name alone when nvidia-smi is missing); ``"cpu"`` on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return torch.cuda.get_device_name(dev)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else \
        torch.cuda.get_device_name(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: The JAX lane's flags the port does not take: (set?, flag, the
#: ROADMAP.md item that says why).
_LATER = (
    (lambda a: a.scan_layers, "--scan-layers",
     "ROADMAP.md Queue 1: XLA's compile-time layer scan has no eager "
     "PyTorch counterpart"),
    (lambda a: a.flash_full_grid, "--flash-full-grid",
     "ROADMAP.md Queue 2, TPU kernels: K1-K3 always skip the tiles above "
     "the causal diagonal and have no full-grid mode"),
)


def snapshot_state(model, optimizer) -> dict:
    """What an elastic snapshot of this lane holds: the model's
    parameters and the optimizer's state tensors."""
    return {"params": dict(model.named_parameters()),
            "opt": [t for st in optimizer.state.values()
                    for t in st.values() if isinstance(t, torch.Tensor)]}


def measure_snapshot_ms(state, log, samples: int = 3) -> float:
    """Measured cost of ONE elastic host-RAM snapshot of ``state`` (a
    synchronous device-to-host copy through
    :class:`horovod_tpu_torch.elastic.Snapshotter`), in ms: the min over
    ``samples`` takes, so the pinned buffers' one-off allocation in the
    first stays out of the steady-state cost the cadence amortizes."""
    from torch.utils._pytree import tree_leaves

    from horovod_tpu_torch.elastic.signals import drain
    from horovod_tpu_torch.elastic.snapshot import Snapshotter

    drain(state)
    snap = Snapshotter(every=1)
    times = []
    for i in range(samples):
        t0 = time.perf_counter()
        snap.take(i + 1, state, sync=True)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = min(times)
    nbytes = sum(t.nbytes for t in tree_leaves(state)
                 if isinstance(t, torch.Tensor))
    log(f"Snapshot probe: {ms:.2f} ms per sync host-RAM snapshot of "
        f"{nbytes} bytes (min of {samples})", file=sys.stderr)
    return ms


def snapshot_field(args, snap_ms, mean, units_per_step) -> dict:
    """The ``"snapshot"`` stamp: the cadence, ms a snapshot and the
    overhead as a percentage of ``args.snapshot_every`` steps' time.
    ``mean`` is the measured rate in units/sec; ``units_per_step``
    converts it to a step time."""
    if snap_ms is None:
        return {"snapshot": None}
    field = {"every": args.snapshot_every,
             "ms_per_snapshot": round(snap_ms, 3)}
    if mean and mean > 0:
        step_secs = units_per_step / mean
        overhead = (100.0 * (snap_ms / 1e3)
                    / (args.snapshot_every * step_secs))
        # 3 significant digits at any magnitude: fixed-decimal rounding
        # would floor a tiny but real overhead to exactly 0.0.
        field["overhead_pct"] = float(f"{overhead:.3g}")
    else:
        field["overhead_pct"] = None
    return {"snapshot": field}


def resolve_attention(args) -> str:
    """``dense``/``flash``, with ``auto`` resolved by the H100's measured
    crossover (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 7, c1c and c5):
    this lane at 16,384 tokens a step (``--seq-len L --batch-size
    16384/L``) runs faster on flash at every length measured, 32
    (1.008x) to 4096 (3.31x), and dense runs out of memory at 8192; so
    ``auto`` is flash at every length. The JAX package's crossover, dense
    below 4096, was measured on a TPU."""
    return "flash" if args.attention == "auto" else args.attention


def resolve_compression(args):
    """The Compression class the lane runs (and stamps)."""
    return getattr(Compression, args.compression or "none")


def wire_leaves(leaves, compression):
    """The leaves ``fused_reduce`` buckets: each at its
    ``compression.plan_dtype`` (the cast compressors plan floating leaves
    at the wire dtype; none/int8/fp8 plan them as they are), as ``meta``
    tensors."""
    return [torch.empty(tuple(leaf.shape),
                        dtype=compression.plan_dtype(leaf.dtype),
                        device="meta") for leaf in leaves]


def wire_stamp(args, model, log=print) -> dict:
    """The ``"hierarchical"``/``"wire"`` fields of the record: the
    resolved ladder (mode and inner size) and its per-leg bytes over the
    model's trainable parameters (``fusion.hier_wire_summary``); wire is
    null where the ladder does not engage, and both are null under
    ``--zero``."""
    if args.zero:
        return {"hierarchical": None, "wire": None}
    mode = args.hierarchical or basics.config().hierarchical
    n = basics.size()
    inner = resolve_hierarchical(args.hierarchical, n)
    if not inner:
        return {"hierarchical": {"mode": mode, "inner": 0}, "wire": None}
    comp = resolve_compression(args)
    plan = plan_buckets(
        wire_leaves([p for p in model.parameters() if p.requires_grad],
                    comp), basics.config().fusion_threshold)
    wire = hier_wire_summary(plan, n, inner, comp)
    log(f"Hierarchical wire split: inner {inner}, ICI {wire['ici_mb']} "
        f"MB, DCN {wire['dcn_mb']} MB @ {wire['dtype']} "
        f"(x{wire['ratio']} vs uncompressed)", file=sys.stderr)
    return {"hierarchical": {"mode": mode, "inner": inner}, "wire": wire}


def _check_flags(args) -> None:
    """The JAX lane's errors for flags of the other lane and for the
    flash-only flags without flash; then the flags not taken yet
    raise."""
    if args.model == LM:
        if args.fused_bn:
            raise ValueError("--fused-bn applies to the ResNet and "
                             f"Inception families (got --model {LM})")
        if resolve_attention(args) != "flash":
            for flag, on in (("--flash-full-grid", args.flash_full_grid),
                             ("--flash-bwd", args.flash_bwd is not None)):
                if on:
                    raise ValueError(
                        f"{flag} requires the flash attention path "
                        "(--attention flash or auto)")
    else:
        if args.attention is not None:
            raise ValueError(f"--attention applies to {LM} only (got "
                             f"--model {args.model})")
        for flag, on in (("--fused-ce", args.fused_ce),
                         ("--remat", args.remat),
                         ("--flash-bwd", args.flash_bwd is not None),
                         ("--flash-full-grid", args.flash_full_grid)):
            if on:
                raise ValueError(f"{flag} applies to {LM} only (got "
                                 f"--model {args.model})")
        if args.fused_bn and not args.model.lower().startswith(
                ("resnet", "inception")):
            raise ValueError(
                "--fused-bn applies to the ResNet and Inception families")
    if args.steps_per_dispatch < 1:
        raise ValueError(f"--steps-per-dispatch must be >= 1, got "
                         f"{args.steps_per_dispatch}")
    for is_set, flag, item in _LATER:
        if is_set(args):
            raise NotImplementedError(f"{flag} is not ported yet ({item})")


def _lm_lane(args, dev):
    """The LM, its step on one fixed batch per rank (no host sync: it
    returns the loss tensor), and the units a step."""
    L, B = args.seq_len, args.batch_size
    attention = resolve_attention(args)
    attn_fn, flash_grid = None, None
    if attention == "flash":
        bwd = "kernel" if args.flash_bwd == "pallas" else args.flash_bwd
        attn_fn = functools.partial(flash_attention, causal=True,
                                    bwd_impl=bwd)
        flash_grid = flash_grid_info(
            L, L, causal=True,
            head_dim=args.lm_dim // args.lm_heads,
            batch_heads=B * args.lm_heads, dtype_bytes=4 if args.fp32 else 2)
        flash_grid["bwd"] = resolve_bwd_impl(bwd, L)
    model = TransformerLM(
        vocab_size=args.vocab, num_layers=args.lm_layers,
        num_heads=args.lm_heads, embed_dim=args.lm_dim,
        max_len=max(L, 2048),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        attn_fn=attn_fn, remat=args.remat, seed=42, device=dev)
    # A window captures the step into a CUDA graph, which needs Adam's
    # step counts on the card; the per-step lane keeps torch's default.
    capturable = args.steps_per_dispatch > 1 and dev.type == "cuda"
    adam = (optim.Adam(model.parameters(), lr=1e-4, mu_dtype=torch.bfloat16,
                       capturable=capturable) if args.bf16_momentum else
            torch.optim.Adam(model.parameters(), lr=1e-4,
                             capturable=capturable))
    opt = create_train_state(
        model, adam, compression=resolve_compression(args),
        overlap=args.overlap, hierarchical=args.hierarchical, device=dev,
        zero=args.zero)
    step = make_train_step(model, opt, fused_ce=args.fused_ce)
    # One global batch of B sequences per rank, each rank its own rows
    # (the JAX lane's sharded [B * n, L] batch).
    n, r = basics.size(), basics.rank()
    tokens = torch.tensor(np.random.default_rng(42).integers(
        0, args.vocab, (B * n, L))[r * B:(r + 1) * B], device=dev)
    fields = {"seq_len": L, "layers": args.lm_layers,
              "d_model": args.lm_dim, "heads": args.lm_heads,
              "vocab": args.vocab, "attention": attention,
              "flash_grid": flash_grid, "fused_ce": args.fused_ce,
              "remat": args.remat}
    return model, opt, step, tokens, B * L, fields


def _image_lane(args, dev):
    """The zoo's image model, its step on one fixed batch of synthetic
    images per rank, and the units (images) a step."""
    kwargs = {"fused_bn": True} if args.fused_bn else {}
    if "image_size" in inspect.signature(
            models.constructor(args.model)).parameters:
        # VGG's flatten and ViT's pos_embed are sized at the input's.
        kwargs["image_size"] = args.image_size
    model = models.build(
        args.model, num_classes=1000,
        dtype=torch.float32 if args.fp32 else torch.bfloat16, seed=42,
        device=dev, **kwargs)
    sgd = (optim.SGD(model.parameters(), lr=0.01, momentum=0.9,
                     momentum_dtype=torch.bfloat16) if args.bf16_momentum
           else torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9))
    opt = create_train_state(
        model, sgd, compression=resolve_compression(args),
        overlap=args.overlap, hierarchical=args.hierarchical, device=dev,
        zero=args.zero)
    step = make_image_train_step(model, opt, average_loss=False)
    n, r, B, S = basics.size(), basics.rank(), args.batch_size, \
        args.image_size
    rng = np.random.default_rng(42)
    rows = slice(r * B, (r + 1) * B)
    batch = {
        "image": torch.tensor(rng.standard_normal(
            (B * n, S, S, 3), dtype=np.float32)[rows], device=dev),
        "label": torch.tensor(rng.integers(0, 1000, B * n)[rows],
                              device=dev)}
    fields = {"image_size": S, "fused_bn": args.fused_bn}
    return model, opt, step, batch, B, fields


def probe_chip(dev: torch.device, log=print):
    """The card's sustained bfloat16 matmul rate in TFLOP/s, stamped in
    every record as ``probe_tflops``, so a low rate reads as a loaded or
    throttled card rather than a regression: chains of ``n x n`` matmuls,
    each feeding the next (the device, not the dispatch, is timed), over
    an orthogonal matrix so the values stay finite; the rate is the
    marginal one between two chain lengths, which cancels each chain's
    fixed launch and sync cost. On the card ``n, n1, n2 = 4096, 25,
    100``, each chain timed by CUDA events (``_timing.time_cold_ms``); on
    the CPU the JAX bench's token sizes, 512, 2 and 6, on the host clock.
    ``None`` when the longer chain did not take longer (noise on a
    loaded host would otherwise stamp an absurd rate)."""
    on_card = dev.type == "cuda"
    n, n1, n2 = (4096, 25, 100) if on_card else (512, 2, 6)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, device=dev))
    x = q.to(torch.bfloat16)

    def chain(iters):
        y = x
        for _ in range(iters):
            y = y @ x
        return y

    if on_card:
        from horovod_tpu_torch._timing import flush_buffer, time_cold_ms

        flush = flush_buffer(dev)
        t1, t2 = (time_cold_ms(lambda: chain(k), flush, iters=3,
                               warmup=1) / 1e3 for k in (n1, n2))
    else:
        chain(1)

        def host(k):
            t0 = time.perf_counter()
            chain(k)
            return time.perf_counter() - t0

        # The least of three: a shared host's noise only adds time.
        t1, t2 = (min(host(k) for _ in range(3)) for k in (n1, n2))
    if t2 <= t1:
        log(f"Chip probe UNRELIABLE: chain({n2}) {t2:.6f} s <= chain({n1})"
            f" {t1:.6f} s", file=sys.stderr)
        return None
    tflops = 2 * n ** 3 * (n2 - n1) / (t2 - t1) / 1e12
    log(f"Chip probe: {tflops:.1f} TFLOP/s (bf16 {n}^3 matmuls, marginal "
        f"over {n1}->{n2} chained, {dev.type})", file=sys.stderr)
    return round(tflops, 1)


def metric_contract(args):
    """``(metric, unit)`` of the record, known before the lane runs, so
    an error record carries what the success would have: the probe's
    ``chip_probe_tflops``; ``<model>_first_step_secs`` for
    ``--compile-only``; else ``tokens/sec`` or ``img/sec`` per card; each
    with the ``_winK`` suffix for a window of K steps."""
    if getattr(args, "probe_only", False):
        return "chip_probe_tflops", "TFLOP/s"
    k = getattr(args, "steps_per_dispatch", 1)
    suffix = f"_win{k}" if k > 1 else ""
    if getattr(args, "compile_only", False):
        return f"{args.model}_first_step_secs{suffix}", "secs"
    if args.model == LM:
        return "tokens/sec" + suffix, "tokens/sec/card" + suffix
    return "img/sec" + suffix, "img/sec/card" + suffix


def _opt_state_stamp(args, opt) -> dict:
    """The optimizer state's dtypes by role and this rank's bytes of
    it."""
    nbytes = optim.state_bytes(opt)
    dtypes = nbytes.pop("dtypes")
    if args.model == LM:
        roles = {"mu": dtypes.get("exp_avg"), "nu": dtypes.get("exp_avg_sq")}
    else:
        roles = {"momentum": dtypes.get("momentum_buffer")}
    return {"opt_state_dtype": roles,
            "opt_state_bytes": sum(nbytes.values())}


def run(args, device: DeviceLike = None) -> dict:
    """The lane; returns the record. ``device=None`` is ``args.device``
    (default the card)."""
    _check_flags(args)
    dev = resolve_device(device if device is not None
                         else getattr(args, "device", None))
    basics.init(device=dev)
    dev = basics.device()
    log = print if basics.rank() == 0 else lambda *a, **k: None
    if getattr(args, "probe_only", False):
        probe = probe_chip(dev, log)
        metric, unit = metric_contract(args)
        return {"metric": metric, "value": probe, "unit": unit,
                "probe_tflops": probe, "mesh": args.mesh,
                "device": dev.type, "card": card_description(dev),
                "torch": torch.__version__}
    lane = _lm_lane if args.model == LM else _image_lane
    model, opt, step_fn, batch, units, fields = lane(args, dev)
    k = args.steps_per_dispatch
    window_fn, staged = stage_synthetic_window(step_fn, batch, k)

    def step():
        out = window_fn(staged)
        return out["loss"] if isinstance(out, dict) else out

    if args.zero:
        # ZeRO's exchange is reduce-scatter shaped; the overlap knob and
        # the bucket plan apply to DistributedOptimizer only.
        stamp = {"zero": shard_info(opt), "overlap": None, "buckets": None}
    else:
        stamp = {"zero": None,
                 "overlap": args.overlap or basics.config().overlap,
                 "buckets": plan_summary(plan_buckets(
                     wire_leaves([p for p in model.parameters()
                                  if p.requires_grad],
                                 resolve_compression(args)),
                     basics.config().fusion_threshold))}
    stamp.update(wire_stamp(args, model, log))

    if dev.type == "cuda" and k > 1:
        # A window's memory is allocated at its capture, in the warm-up:
        # its peak counts from there (after it, replays allocate nothing).
        torch.cuda.reset_peak_memory_stats(dev)
    if getattr(args, "compile_only", False):
        return _first_step_record(args, dev, step, fields, stamp, opt, log)
    for _ in range(args.num_warmup_batches):
        loss = step()
    _sync(dev)
    snap_ms = (measure_snapshot_ms(snapshot_state(model, opt), log)
               if args.snapshot_every > 0 else None)
    if dev.type == "cuda" and k == 1:
        torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = step()
        _sync(dev)
        rates.append(units * k * args.num_batches_per_iter
                     / (time.perf_counter() - t0))
    mean = float(np.mean(rates))
    # Data-parallel replicas must hold identical parameters after the
    # same reduced updates: every rank's checksum equals rank 0's.
    checksum = torch.stack([p.detach().double().sum()
                            for p in model.parameters()]).sum()
    sums = allgather(checksum.reshape(1)).tolist()
    n = basics.size()
    # After the timed windows: the card's condition as they ran.
    probe = probe_chip(dev, log)
    # The JAX lane's _winK contract: a window record never stands where a
    # per-step record should.
    metric, unit = metric_contract(args)
    return {
        "metric": metric,
        "value": mean,
        "unit": unit,
        "conf": float(1.96 * np.std(rates)),
        "peak": float(np.max(rates)),
        "step_ms": units / mean * 1e3,
        "loss": float(loss),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "model": args.model, "batch_size": args.batch_size, **fields,
        "dtype": "float32" if args.fp32 else "bfloat16",
        "compression": args.compression, **stamp,
        **_opt_state_stamp(args, opt),
        **snapshot_field(args, snap_ms, mean, units), "world_size": n,
        "replicas_in_sync": all(x == sums[0] for x in sums),
        "probe_tflops": probe, "mesh": args.mesh,
        "device": dev.type, "card": card_description(dev),
        "torch": torch.__version__,
        **({"window": k} if k > 1 else {}),
    }


def _first_step_record(args, dev, step, fields, stamp, opt, log) -> dict:
    """``--compile-only``: the seconds of one first step (a window's:
    its warm-up step, its capture and K - 1 replays), which builds the
    CUDA kernels the lane launches, synchronised."""
    t0 = time.perf_counter()
    loss = step()
    _sync(dev)
    secs = time.perf_counter() - t0
    metric, unit = metric_contract(args)
    log(f"First step: {secs:.3f} s", file=sys.stderr)
    k = args.steps_per_dispatch
    return {"metric": metric, "value": secs, "unit": unit,
            "loss": float(loss), "model": args.model,
            "batch_size": args.batch_size, **fields,
            "dtype": "float32" if args.fp32 else "bfloat16", **stamp,
            **_opt_state_stamp(args, opt),
            "probe_tflops": probe_chip(dev, log), "mesh": args.mesh,
            "world_size": basics.size(), "device": dev.type,
            "card": card_description(dev), "torch": torch.__version__,
            **({"window": k} if k > 1 else {})}


def error_record(args, error: str) -> dict:
    """The record of a run that failed: the success's metric and unit,
    ``"value": null`` and the ``"error"``."""
    metric, unit = metric_contract(args)
    return {"metric": metric, "value": None, "unit": unit, "peak": None,
            "probe_tflops": None,
            "window": getattr(args, "steps_per_dispatch", 1),
            "overlap": getattr(args, "overlap", None),
            "mesh": getattr(args, "mesh", None), "hierarchical": None,
            "wire": None, "snapshot": None, "model": args.model,
            "device": getattr(args, "device", None), "error": error}


def _under_launcher() -> bool:
    """A rank of a launched job (``hvdrun-torch``'s ``HOROVOD_RANK``,
    torchrun's ``RANK``): a supervisor per rank would retry one rank of
    the job and desynchronise its peers; the launcher's restarts own
    that."""
    return any(os.environ.get(v) is not None
               for v in ("HOROVOD_RANK", "RANK"))


def supervise(argv, args) -> int:
    """Run the measurement in a child process with an attempt timeout and
    retries (the module docstring); print exactly one JSON line in every
    outcome and return 0."""
    import signal
    import tempfile

    attempts = max(1, int(os.environ.get("HVD_BENCH_ATTEMPTS", "4")))
    timeout = float(os.environ.get("HVD_BENCH_ATTEMPT_TIMEOUT", "600"))
    backoff = float(os.environ.get("HVD_BENCH_BACKOFF", "20"))
    state = {"proc": None, "err": "unknown"}
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])

    def kill_group(proc):
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            pass

    def disarm():
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.SIG_DFL)

    def on_signal(signum, frame):
        disarm()                  # a second signal prints no second line
        proc = state["proc"]
        if proc is not None and proc.poll() is None:
            kill_group(proc)
        print(json.dumps(error_record(
            args, f"supervisor received signal {signum} mid-run; last "
                  f"state: {state['err']}")), flush=True)
        os._exit(0)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    for attempt in range(1, attempts + 1):
        with tempfile.NamedTemporaryFile(suffix=".json",
                                         delete=False) as f:
            emit = f.name
        cmd = [sys.executable, "-m", "horovod_tpu_torch.bench", *argv,
               "--_child", "--_emit", emit]
        print(f"[bench supervisor] attempt {attempt}/{attempts} (timeout "
              f"{timeout:.0f}s)", file=sys.stderr, flush=True)
        state["err"] = f"attempt {attempt} in flight"
        # The child in a session of its own, so a timeout or a signal
        # kills all it started; signals are held while it starts, so one
        # cannot land before the handler knows the child.
        mask = {signal.SIGTERM, signal.SIGINT}
        signal.pthread_sigmask(signal.SIG_BLOCK, mask)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    env=env, start_new_session=True)
            state["proc"] = proc
        finally:
            signal.pthread_sigmask(signal.SIG_UNBLOCK, mask)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            kill_group(proc)
            rc = None
            state["err"] = (f"attempt {attempt} exceeded the "
                            f"{timeout:.0f}s attempt timeout")
            print(f"[bench supervisor] {state['err']}", file=sys.stderr,
                  flush=True)
        finally:
            state["proc"] = None
        try:
            with open(emit) as f:
                payload = json.loads(f.read().strip() or "null")
        except (OSError, ValueError):
            payload = None
        try:
            with open(emit + ".err") as f:
                detail = f.read().strip()
        except OSError:
            detail = ""
        for path in (emit, emit + ".err"):
            try:
                os.unlink(path)
            except OSError:
                pass
        if payload is not None:
            disarm()
            print(json.dumps(payload), flush=True)
            return 0
        if rc is not None:
            state["err"] = f"attempt {attempt} exited rc={rc} before " \
                           "emitting"
        if detail:
            state["err"] += f" [{detail[:300]}]"
        print(f"[bench supervisor] {state['err']}", file=sys.stderr,
              flush=True)
        if rc in (2, RC_DETERMINISTIC):
            state["err"] += " (deterministic failure, not retried)"
            break
        if attempt < attempts:
            print(f"[bench supervisor] backing off {backoff:g}s",
                  file=sys.stderr, flush=True)
            time.sleep(backoff)
            backoff *= 2
    disarm()
    print(json.dumps(error_record(args, state["err"])), flush=True)
    return 0


def classify(exc: BaseException) -> int:
    """The exit code of a child that failed with ``exc``: 1 where a
    retry may cure it (an error naming an unavailable, timed-out or
    disconnected peer or device), else :data:`RC_DETERMINISTIC` (CUDA
    out of memory included: the same program runs out the same way)."""
    text = f"{type(exc).__name__}: {exc}".lower()
    if isinstance(exc, torch.cuda.OutOfMemoryError) \
            or "out of memory" in text:
        return RC_DETERMINISTIC
    return 1 if any(m in text for m in TRANSIENT_MARKERS) \
        else RC_DETERMINISTIC


def _print_record(args, record) -> None:
    """Rank 0 prints the record (and writes it to ``--_emit``'s file);
    the process group is left."""
    ranked = basics.is_initialized()
    if not ranked or basics.rank() == 0:
        line = json.dumps(record)
        print(line, flush=True)
        if args._emit:
            with open(args._emit, "w") as f:
                f.write(line + "\n")
    if ranked:
        basics.shutdown()


def main(argv=None) -> int:
    """Run the lane in this process and print its record; a failure
    raises (a library call's form: :func:`cli` is the command line)."""
    args = build_parser().parse_args(argv)
    _print_record(args, run(args))
    return 0


def cli(argv=None) -> int:
    """``python -m horovod_tpu_torch.bench``: the lane under
    :func:`supervise`, or, in a supervised child, under a launcher or with
    ``HVD_BENCH_NO_SUPERVISOR``, in this process, where a failure becomes
    the exit code :func:`classify` gives it, its text in ``--_emit``'s
    ``.err`` file."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if not (args._child or _under_launcher()
            or os.environ.get("HVD_BENCH_NO_SUPERVISOR")):
        return supervise(argv, args)
    try:
        record = run(args)
    except Exception as exc:
        import traceback

        traceback.print_exc()
        if args._emit:
            try:
                with open(args._emit + ".err", "w") as f:
                    f.write(f"{type(exc).__name__}: {exc}"[:2000])
            except OSError:
                pass
        return classify(exc)
    _print_record(args, record)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
