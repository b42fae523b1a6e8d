"""The port's bench lane: the JAX LM lane's step flags on a tiny model.

Each new flag of ``python -m horovod_tpu_torch.bench`` (``--fused-ce``,
``--zero``, ``--remat``, ``--flash-bwd``, ``--attention auto``), and every combination of ``--fused-ce``,
``--zero``, ``--remat`` and ``--overlap {on,off}``, runs the lane on the
CPU at a tiny size, and the
record carries its stamps (``fused_ce``, ``remat``, ``zero`` as
``shard_info``, ``overlap`` and ``buckets``, both None under ZeRO as the
JAX ``overlap_stamp`` has them, and ``flash_grid`` with the resolved
backward). ``--hierarchical`` and ``--compression int8|fp8`` run, and
the record's ``hierarchical``/``wire`` fields equal the JAX
``wire_stamp``'s, in a world of one and at an injected world size and
inner size; bad values and stale error-feedback state fail loudly.
``--snapshot-every`` stamps the snapshot probe's cost. Every flag the
JAX lane has and the port has not taken yet raises ``NotImplementedError`` naming its ROADMAP.md item (so does
``--flash-full-grid``: the CUDA kernels have no full-grid mode, and the
stamp never claims one); the flash-only flags raise without flash, and the LM-only flags on the image lane, as
the JAX ``bench.py`` does. ``--steps-per-dispatch K`` runs windows of K
steps (CUDA graph replays on the card, eager on the CPU) under the JAX
lane's ``_winK`` metric contract, with every step flag.
"""

import itertools

import numpy as np
import pytest
import torch

from horovod_tpu_torch import bench
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.transformer import TransformerLM

TINY = ["--seq-len", "16", "--batch-size", "2", "--lm-layers", "2",
        "--lm-dim", "16", "--lm-heads", "2", "--vocab", "32", "--fp32",
        "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
        "--num-iters", "2"]
FLASH = ["--attention", "flash"]


def _run(flags):
    try:
        return bench.run(bench.build_parser().parse_args(TINY + flags),
                         device="cpu")
    finally:
        basics.shutdown()


@pytest.mark.parametrize("flags", [
    FLASH + ["--fused-ce"], FLASH + ["--zero"], FLASH + ["--remat"],
    FLASH + ["--fused-ce", "--remat"],
    FLASH + ["--fused-ce", "--zero", "--remat"],
    FLASH + ["--flash-bwd", "pallas"], FLASH + ["--flash-bwd", "scan"],
    FLASH + ["--flash-bwd", "kernel"], ["--overlap", "on"], ["--zero"],
], ids=lambda f: "_".join(x.strip("-") for x in f))
def test_lane_runs_each_new_flag_on_the_cpu(flags):
    rec = _run(flags)
    assert rec["value"] > 0 and np.isfinite(rec["loss"])
    assert rec["replicas_in_sync"]
    assert rec["fused_ce"] == ("--fused-ce" in flags)
    assert rec["remat"] == ("--remat" in flags)
    if "--zero" in flags:
        n = sum(p.numel() for p in TransformerLM(
            vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
            max_len=2048, dtype=torch.float32, device="cpu").parameters())
        assert rec["zero"] == {"float32": (n, n)}
        assert rec["overlap"] is None and rec["buckets"] is None
    else:
        assert rec["zero"] is None and rec["buckets"]["count"] == 1
        assert rec["overlap"] == ("on" if "--overlap" in flags else "auto")
    if "flash" in flags:
        grid = rec["flash_grid"]
        want = {"pallas": "kernel", "scan": "scan"}.get(
            dict(zip(flags, flags[1:])).get("--flash-bwd"), "kernel")
        assert grid["bwd"] == want
        assert grid["truncated"]
    else:
        assert rec["flash_grid"] is None


@pytest.mark.parametrize("fused,zero,remat,overlap", list(
    itertools.product([False, True], [False, True], [False, True],
                      ["on", "off"])))
def test_every_combination_of_the_step_flags_runs(fused, zero, remat,
                                                  overlap):
    """--fused-ce x --zero x --remat x --overlap {on,off} on the flash
    lane (ZeRO ignores --overlap, as in the JAX lane)."""
    flags = FLASH + ["--overlap", overlap] + [
        f for f, on in (("--fused-ce", fused), ("--zero", zero),
                        ("--remat", remat)) if on]
    rec = _run(flags)
    assert np.isfinite(rec["loss"]) and rec["replicas_in_sync"]
    assert (rec["fused_ce"], rec["remat"]) == (fused, remat)
    assert (rec["zero"] is not None) == zero
    assert rec["overlap"] == (None if zero else overlap)


def test_fused_ce_and_remat_keep_the_loss():
    """The first step's loss is the same number with and without the
    fused loss and remat (the last window's loss is after 3 updates, so
    the lane is run for one step)."""
    one = ["--num-warmup-batches", "0", "--num-iters", "1"]
    base = _run(FLASH + one)["loss"]
    for flags in (["--fused-ce"], ["--remat"], ["--fused-ce", "--remat"],
                  ["--zero"]):
        np.testing.assert_allclose(_run(FLASH + one + flags)["loss"], base,
                                   rtol=1e-6)


@pytest.mark.parametrize("flags,item", [
    (["--scan-layers"], "layer scan"),
])
def test_flags_left_for_later_raise_naming_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1.*"
                                                  f"{item}"):
        _run(flags)
    assert not basics.is_initialized()


@pytest.mark.parametrize("model", [bench.LM, "resnet18"])
def test_snapshot_every_stamps_the_record(model):
    """``--snapshot-every N`` measures a synchronous host-RAM snapshot of
    the parameters and the optimizer state before the timed windows and
    stamps its cost as the JAX lane's ``snapshot`` field; off, the field
    is null."""
    flags = (["--snapshot-every", "1"] if model == bench.LM else
             ["--model", model, "--image-size", "32", "--batch-size", "2",
              "--snapshot-every", "1"])
    rec = _run(flags)
    snap = rec["snapshot"]
    assert set(snap) == {"every", "ms_per_snapshot", "overhead_pct"}
    assert snap["every"] == 1 and snap["ms_per_snapshot"] > 0
    step_ms = rec["step_ms"]
    assert snap["overhead_pct"] == pytest.approx(
        100 * snap["ms_per_snapshot"] / step_ms, rel=2e-2)
    assert _run([] if model == bench.LM else flags[:6])["snapshot"] is None


HIER_FLAGS = [["--hierarchical", "on"], ["--hierarchical", "auto"],
              ["--hierarchical", "off"], ["--compression", "int8"],
              ["--compression", "fp8"],
              ["--hierarchical", "on", "--compression", "int8"],
              ["--hierarchical", "on", "--compression", "fp8"],
              ["--hierarchical", "on", "--compression", "bf16"]]


def _jax_wire_stamp(flags, size, inner):
    """The JAX bench's ``wire_stamp`` for ``flags`` over the tiny LM's
    parameter shapes, at world ``size`` and inner size ``inner``."""
    import types

    import bench as jbench
    import horovod_tpu.jax as jhvd
    from horovod_tpu.common import state

    jhvd.init()
    opts = dict(zip(flags[::2], flags[1::2]))
    args = types.SimpleNamespace(
        hierarchical=opts.get("--hierarchical"), zero=False,
        compression=opts.get("--compression", "none"))
    shapes = [tuple(p.shape) for p in TransformerLM(
        vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
        max_len=2048, dtype=torch.float32, device="cpu").parameters()]
    cfg = state.global_state().config
    saved = (cfg.hierarchical_inner_size, jhvd.size)
    cfg.hierarchical_inner_size = inner
    jhvd.size = lambda: size
    try:
        return jbench.wire_stamp(
            args, {"params": [np.zeros(s, np.float32) for s in shapes]},
            lambda *a, **k: None)
    finally:
        cfg.hierarchical_inner_size, jhvd.size = saved


@pytest.mark.parametrize("flags", HIER_FLAGS,
                         ids=lambda f: "_".join(x.strip("-") for x in f))
def test_hierarchical_and_low_bit_flags_run_and_stamp_as_jax(flags):
    """The ladder's flags run the lane in a world of one, where the
    ladder resolves flat (and int8/fp8 are lossless): the record's
    ``hierarchical`` and ``wire`` fields are the JAX ``wire_stamp``'s at
    world size 1."""
    rec = _run(flags)
    assert np.isfinite(rec["loss"]) and rec["replicas_in_sync"]
    want = _jax_wire_stamp(flags, 1, 0)
    assert rec["hierarchical"] == want["hierarchical"]
    assert rec["wire"] is None and want["wire"] is None
    assert rec["compression"] == dict(zip(flags[::2], flags[1::2])).get(
        "--compression", "none")


@pytest.mark.parametrize("flags", HIER_FLAGS,
                         ids=lambda f: "_".join(x.strip("-") for x in f))
def test_wire_stamp_at_an_injected_inner_size_equals_jax(flags,
                                                        monkeypatch):
    """``wire_stamp`` as an 8-rank world with inner size 4 sees it (the
    world size injected): the same ``hierarchical`` and ``wire`` fields
    as the JAX ``wire_stamp`` at size 8, inner 4; under ``--zero`` both
    are null."""
    basics.init(device="cpu")
    try:
        basics.config().hierarchical_inner_size = 4
        monkeypatch.setattr(basics, "size", lambda: 8)
        args = bench.build_parser().parse_args(TINY + flags)
        model = TransformerLM(vocab_size=32, num_layers=2, num_heads=2,
                              embed_dim=16, max_len=2048,
                              dtype=torch.float32, device="cpu")
        lines = []
        got = bench.wire_stamp(args, model,
                               lambda *a, **k: lines.append(a[0]))
        want = _jax_wire_stamp(flags, 8, 4)
        assert got == want
        assert (got["wire"] is not None) == (len(lines) == 1)
        args.zero = True
        assert bench.wire_stamp(args, model) == {"hierarchical": None,
                                                 "wire": None}
    finally:
        basics.shutdown()


@pytest.mark.parametrize("bad", [["--hierarchical", "sometimes"],
                                 ["--compression", "int4"]])
def test_bad_ladder_flag_values_are_refused(bad):
    with pytest.raises(SystemExit):
        bench.build_parser().parse_args(TINY + bad)


def test_bad_ladder_mode_and_stale_residuals_fail_loudly():
    """What the parser cannot refuse raises as the JAX package does: an
    unknown mode, error-feedback residuals where the ladder resolves
    flat (a world of one), and a window over an optimizer that holds
    residuals."""
    from horovod_tpu_torch import distributed as hvd
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError
    from horovod_tpu_torch.distributed.window import windowed
    from horovod_tpu_torch.models.train import make_train_step

    basics.init(device="cpu")
    try:
        with pytest.raises(InvalidArgumentError, match="one of"):
            hvd.resolve_hierarchical("sometimes", 8)
        with pytest.raises(InvalidArgumentError, match="resolves to FLAT"):
            hvd.fused_reduce([torch.ones(3)], hierarchical="on",
                             compression=hvd.Compression.int8,
                             residuals=(torch.zeros(3),))
        model = TransformerLM(vocab_size=32, num_layers=1, num_heads=2,
                              embed_dim=16, max_len=16,
                              dtype=torch.float32, device="cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            compression=hvd.Compression.int8, hierarchical="on")
        assert opt.residuals is None and opt.hierarchical_inner == 0
        opt._hvd_residuals = [torch.zeros(4)]
        with pytest.raises(NotImplementedError, match="Queue 3"):
            windowed(make_train_step(model, opt), 2)(
                torch.zeros((2, 1, 8), dtype=torch.long))
    finally:
        basics.shutdown()


@pytest.mark.parametrize("model", ["lm", "resnet18"])
def test_steps_per_dispatch_runs_windows_with_the_win_k_contract(model):
    """``--steps-per-dispatch 3`` no longer raises: each timed iteration
    runs a window of 3 steps, the metric and unit carry ``_win3``, the
    record stamps ``"window": 3``, and the units count the 3 steps (the
    step time is the window's over 3). ``K = 1``'s record keeps its keys
    and names."""
    lane = ([] if model == "lm" else
            ["--model", "resnet18", "--image-size", "32"])
    one = _run(lane)
    win = _run(lane + ["--steps-per-dispatch", "3"])
    assert "window" not in one and win["window"] == 3
    assert set(win) == set(one) | {"window"}
    for key in ("metric", "unit"):
        assert win[key] == one[key] + "_win3"
    assert one["metric"] == ("tokens/sec" if model == "lm" else "img/sec")
    units = 2 * (16 if model == "lm" else 1)      # batch 2 (x seq 16)
    np.testing.assert_allclose(win["step_ms"], units / win["value"] * 1e3)
    assert np.isfinite(win["loss"]) and win["replicas_in_sync"]


@pytest.mark.parametrize("flags", [
    FLASH + ["--zero"], FLASH + ["--fused-ce", "--remat"],
    FLASH + ["--overlap", "on"], FLASH + ["--overlap", "off"],
    ["--model", "resnet18", "--image-size", "32", "--fused-bn"],
], ids=lambda f: "_".join(x.strip("-") for x in f))
def test_steps_per_dispatch_composes_with_the_step_flags(flags):
    rec = _run(flags + ["--steps-per-dispatch", "2"])
    assert rec["window"] == 2 and rec["metric"].endswith("_win2")
    assert np.isfinite(rec["loss"]) and rec["replicas_in_sync"]


def test_steps_per_dispatch_below_one_raises():
    with pytest.raises(ValueError, match="--steps-per-dispatch must be"):
        _run(["--steps-per-dispatch", "0"])
    assert not basics.is_initialized()


def test_flash_full_grid_raises_naming_the_missing_kernel_mode():
    """The JAX flag runs the full Pallas grid; K1-K3 always skip the
    tiles above the diagonal, so the port refuses the flag rather than
    stamp a grid the card never ran."""
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md Queue 2.*no full-grid mode"):
        _run(FLASH + ["--flash-full-grid"])
    assert not basics.is_initialized()


@pytest.mark.parametrize("flags", [
    ["--flash-bwd", "kernel"], ["--flash-full-grid"],
    ["--attention", "dense", "--flash-bwd", "scan"],
    ["--attention", "dense", "--flash-full-grid"],
    ["--model", "resnet18", "--fused-ce"], ["--model", "resnet18", "--remat"],
    ["--model", "resnet18", "--flash-bwd", "kernel"],
])
def test_flash_and_lm_only_flags_raise_elsewhere(flags):
    with pytest.raises(ValueError, match="requires the flash|applies to"):
        _run(flags)


def test_auto_attention_takes_the_measured_crossover():
    """Flash won at every length measured on the card, so ``auto`` is
    flash even at the tiny lane's 16 tokens."""
    rec = _run(["--attention", "auto", "--num-iters", "1"])
    assert rec["attention"] == "flash" and rec["seq_len"] == 16
    assert rec["flash_grid"]["bwd"] == "kernel"
