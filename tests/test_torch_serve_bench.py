"""The port's serving bench lane (``python -m horovod_tpu_torch.serve_bench``)
against the contract of tests/test_serve_bench.py's single-engine cases.

A tiny model on the CPU: one record with tokens/s, p50/p99 TTFT and
per-token latency and page occupancy, every stream pinned against
``lm_decode``; ``--ab``, ``--attention paged``, ``--ab-attention``,
``--ab-prefix`` (one cold prefill, streams identical, prefill tokens
saved) and ``--ab-spec`` (a full-depth draft accepts everything) carry
both sides; the argument checks are argparse errors (exit code 2) as in
the JAX tool, the workload is the JAX tool's draw for draw, and the JAX
tool's fleet, mesh and disaggregation flags raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

import numpy as np
import pytest

from horovod_tpu_torch import serve_bench as sb
from tools import serve_bench as jsb

TINY = ["--layers", "2", "--d-model", "64", "--heads", "2",
        "--vocab", "128", "--requests", "6", "--rate", "50",
        "--prompt-min", "4", "--prompt-max", "12",
        "--new-min", "2", "--new-max", "6", "--decode-slots", "2",
        "--prefill-chunk", "4", "--page-size", "8"]


def _run(*argv):
    ap = sb.build_parser()
    return sb.run(ap.parse_args([*TINY, *argv]), device="cpu", ap=ap)


def test_continuous_record_contract():
    rec = _run("--pin-exact", "--require-finished")
    assert rec["metric"] == "serve_continuous_tokens_per_sec_per_chip"
    assert rec["unit"] == "tokens/sec/chip" and rec["value"] > 0
    assert rec["card"] == "cpu"
    s = rec["serve"]
    assert s["by_state"] == {"finished": 6} and s["mode"] == "continuous"
    for key in ("p50", "p99"):
        assert s["ttft_ms"][key] is not None
        assert s["tbt_ms"][key] is not None
    assert 0 < s["pages"]["occupancy_max"] <= 1
    assert "spec" not in s and "prefix" not in s
    c = rec["config"]
    assert c["policy"] == "fcfs" and c["capture"] == "on"
    assert c["mesh"] is None and c["fleet"] is None


@pytest.mark.parametrize("flags", [["--static"], ["--capture", "off"],
                                   ["--admission", "lazy", "--policy",
                                    "sjf", "--slo", "latency"]])
def test_modes_finish_and_pin_exact(flags):
    rec = _run(*flags, "--pin-exact", "--require-finished")
    assert rec["serve"]["by_state"] == {"finished": 6}
    if "--static" in flags:
        assert rec["metric"] == "serve_static_tokens_per_sec_per_chip"


def test_ab_record_carries_both_sides():
    rec = _run("--ab")
    assert rec["metric"] == "serve_ab_tokens_per_sec_per_chip"
    ab = rec["serve"]["ab"]
    assert ab["static"]["tokens_per_sec_per_chip"] > 0
    assert ab["continuous_over_static"] is not None


def test_attention_paged_record_contract():
    rec = _run("--attention", "paged", "--pin-exact", "--require-finished")
    assert rec["config"]["attention"] == "paged"
    a = rec["serve"]["attention"]
    assert a["mode"] == "paged" and 0 < a["kv_fetch_frac"] < 1
    assert a["kv_bytes_per_step_paged"] < a["kv_bytes_per_step_gather"]


def test_ab_attention_record_carries_both_sides():
    rec = _run("--requests", "4", "--ab-attention")
    assert rec["metric"] == "serve_ab_attention_tokens_per_sec_per_chip"
    assert rec["config"]["attention"] == "ab"
    s = rec["serve"]
    assert s["attention"]["mode"] == "paged"
    ab = s["ab_attention"]
    assert ab["gather"]["attention"]["mode"] == "gather"
    assert ab["paged_over_gather"] is not None


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_ab_prefix_record_contract(attention):
    rec = _run("--ab-prefix", "--attention", attention, "--pin-exact",
               "--require-finished")
    assert rec["metric"] == "serve_ab_prefix_tokens_per_sec_per_chip"
    s = rec["serve"]
    assert s["mode"] == "ab_prefix" and s["by_state"] == {"finished": 6}
    pb = s["prefix"]
    assert pb["hit_rate"] > 0 and pb["prefill_tokens_saved"] > 0
    assert pb["cow_copies"] == 0
    ab = s["ab_prefix"]
    assert ab["off"]["prefix"] is None
    assert ab["off"]["by_state"] == {"finished": 6}
    assert ab["system_prompt_tokens"] == 32          # auto: 4 pages
    assert ab["unique_prefixes"] == 1 and ab["cold_prefills"] == 1
    assert ab["exact_pin"] == {"compared": 6, "identical": True}
    assert ab["cached_over_cold"] is not None
    assert rec["config"]["prefix_caching"] == "ab"
    assert rec["config"]["system_prompt_len"] == 32


@pytest.mark.parametrize("attention", ["gather", "paged"])
def test_ab_spec_record_contract(attention):
    rec = _run("--speculate", "4", "--draft-layers", "2", "--ab-spec",
               "--attention", attention, "--pin-exact",
               "--require-finished")
    assert rec["metric"] == "serve_ab_spec_tokens_per_sec_per_chip"
    assert rec["config"]["speculate_k"] == "ab"
    s = rec["serve"]
    assert s["mode"] == "ab_spec"
    assert s["spec"]["k"] == 4 and s["spec"]["draft_layers"] == 2
    ab = s["ab_spec"]
    assert ab["k"] == 4 and ab["draft_layers"] == 2
    assert ab["base"]["spec"] is None
    assert ab["base"]["tokens_per_sec_per_chip"] > 0
    assert ab["exact_pin"] == {"compared": 6, "identical": True}
    # The draft is the whole target (2 layers): every proposal accepted.
    assert ab["accept_rate"] == 1.0 and ab["tokens_per_step"] > 1.0
    assert ab["spec_over_base"] is not None


@pytest.mark.parametrize("argv", [
    ["--ab-attention", "--ab"], ["--ab-attention", "--static"],
    ["--ab-prefix", "--ab"], ["--ab-prefix", "--static"],
    ["--ab-prefix", "--ab-attention"], ["--ab-prefix", "--prefix"],
    ["--ab-spec"], ["--speculate", "2", "--ab-spec", "--ab"],
    ["--speculate", "2", "--ab-spec", "--static"],
    ["--speculate", "2", "--ab-spec", "--ab-attention"],
    ["--speculate", "2", "--ab-spec", "--ab-prefix"],
    ["--speculate", "-1"], ["--draft-layers", "1"],
    ["--rate", "0"], ["--requests", "0"], ["--prompt-min", "0"],
    ["--new-max", "1", "--new-min", "2"], ["--system-prompt-len", "-2"],
    ["--heads", "3"], ["--capture", "maybe"],
], ids=lambda a: "_".join(x.strip("-") for x in a))
def test_bad_args_are_argparse_errors(argv):
    with pytest.raises(SystemExit) as e:
        _run(*argv)
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ["--mesh", "dp=1,tp=4"], ["--ab-tp"], ["--fleet", "2"],
    ["--fleet-transport", "tcp"], ["--fault-plan", "kill:replica=1,at=0s"],
    ["--rolling-update-at", "50%"], ["--pools", "1,1"], ["--ab-disagg"],
], ids=lambda a: a[0].strip("-"))
def test_unported_flags_raise_naming_the_roadmap(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        _run(*argv)


def test_require_finished_fails_loudly():
    # One allocatable page of 8 positions: most drawn requests can never
    # fit and are rejected.
    with pytest.raises(SystemExit, match="not all requests finished"):
        _run("--num-pages", "2", "--require-finished")


@pytest.mark.parametrize("spl", [0, 16])
def test_workload_is_the_jax_tools_draw_for_draw(spl):
    args = sb.build_parser().parse_args(TINY)
    got = sb.make_workload(args, system_prompt_len=spl)
    want = jsb.make_workload(args, system_prompt_len=spl)
    assert len(got) == len(want) == 6
    for (ta, pa, na), (tb, pb, nb) in zip(got, want):
        assert ta == tb and na == nb and np.array_equal(pa, pb)


def test_pins_fail_on_a_divergence():
    from horovod_tpu_torch.serve.scheduler import Request

    def req(out, hit=0, prompt=(1, 2, 3, 4, 5, 6, 7, 8, 9)):
        r = Request(prompt=np.asarray(prompt), max_new_tokens=2)
        r.state, r.output, r.prefix_hit_tokens = "finished", out, hit
        return r

    assert sb.pin_sides([req([1, 2])], [req([1, 2])], "X") == 1
    with pytest.raises(SystemExit, match="X PIN FAILED"):
        sb.pin_sides([req([1, 2])], [req([1, 3])], "X")
    assert sb.pin_prefix_cold([req([1], 0), req([1], 8)], 8, "t") == (1, 1)
    with pytest.raises(SystemExit, match="PREFIX COLD PIN FAILED"):
        sb.pin_prefix_cold([req([1], 0), req([1], 0)], 8, "t")
