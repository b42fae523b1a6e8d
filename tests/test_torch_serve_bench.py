"""The port's serving bench lane (``python -m horovod_tpu_torch.serve_bench``)
against the contract of tests/test_serve_bench.py's single-engine cases.

A tiny model on the CPU: one record with tokens/s, p50/p99 TTFT and
per-token latency and page occupancy, every stream pinned against
``lm_decode``; ``--ab``, ``--attention paged``, ``--ab-attention``,
``--ab-prefix`` (one cold prefill, streams identical, prefill tokens
saved) and ``--ab-spec`` (a full-depth draft accepts everything) carry
both sides; the argument checks are argparse errors (exit code 2) as in
the JAX tool, the workload is the JAX tool's draw for draw, and the mesh
flags with a captured lane raise ``NotImplementedError`` naming the
ROADMAP.md item of a captured tensor-parallel lane.

The fleet lanes (``--fleet N`` in process, as worker processes and over
TCP, ``--fault-plan``, ``--rolling-update-at``, ``--ab-prefix`` over the
fleet, ``--pools P,D`` and ``--ab-disagg``) carry the JAX tool's
record: the ``serve.fleet`` block with the reference fleet's ``stats()``
keys (its ``disagg`` block under pools), ``serve.fleet_ab`` with the
clean-versus-faulted stream pin, ``serve.disagg`` with the
colocated-versus-disaggregated pin, ``config.fleet``, and ``per_card``
for every lane; the fleet's argument checks are argparse errors as in
the JAX tool.
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
    ["--mesh", "dp=1,tp=4"], ["--ab-tp", "--mesh", "dp=1,tp=2"],
], ids=lambda a: a[0].strip("-"))
def test_unported_flags_raise_naming_the_roadmap(argv):
    """The mesh flags are ported (tests/test_torch_serve_tp.py runs them
    in gloo worlds), and so is the captured tensor-parallel lane (over
    NCCL only); with no world started they raise the engine's refusal of
    a mesh that is not the world, naming the launch that fixes it."""
    from horovod_tpu_torch.common.exceptions import InvalidArgumentError

    with pytest.raises(InvalidArgumentError,
                       match=r"world has 1.*torchrun --nproc-per-node"):
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


# ------------------------------------------------------------------ fleet

#: Keys of the JAX tool's ``serve.fleet_ab`` block and ``config.fleet``
#: (tools/serve_bench.py); each must appear in its source.
FLEET_AB_KEYS = {"clean", "fault_plan", "rolling_update_at",
                 "redispatch_pin", "p99_ttft_clean_ms",
                 "p99_ttft_faulted_ms", "faulted_over_clean_p99_ttft"}
CONFIG_FLEET_KEYS = {"replicas", "transport", "hosts", "max_restarts",
                     "watchdog_timeout", "max_queue", "backoff_base",
                     "fault_plan", "rolling_update_at", "push_chunk_bytes",
                     "push_retries", "pools"}


@pytest.fixture(scope="module")
def jax_fleet_keys():
    """The reference fleet's ``stats()`` keys, from a JAX ServeFleet over
    the protocol stub (no model to compile)."""
    import os
    import sys

    from horovod_tpu.serve import FleetConfig as JFleetConfig
    from horovod_tpu.serve import ServeConfig as JServeConfig
    from horovod_tpu.serve import ServeFleet as JServeFleet

    stub = os.path.join(os.path.dirname(__file__), "serve_stub_worker.py")

    def cmd(rid, sock, default):
        dcmd, env = default
        return [sys.executable, "-S", stub, "--socket", sock, "--rank",
                str(rid), "--heartbeat-dir",
                dcmd[dcmd.index("--heartbeat-dir") + 1]], env

    fl = JServeFleet({"pos": np.zeros((64, 4), np.float32)},
                     JServeConfig(page_size=8, num_pages=32),
                     JFleetConfig(replicas=1, transport="process"),
                     worker_cmd=cmd)
    try:
        return fl.stats()
    finally:
        fl.close()


def _keyset(block):
    return set(block) if isinstance(block, dict) else None


def test_fleet_clean_record_contract(jax_fleet_keys):
    rec = _run("--fleet", "2", "--pin-exact", "--require-finished")
    assert rec["metric"] == "serve_fleet_tokens_per_sec_per_chip"
    s = rec["serve"]
    assert s["mode"] == "fleet" and s["by_state"] == {"finished": 6}
    assert set(s) - {"mode"} == set(jax_fleet_keys)
    f = s["fleet"]
    assert set(f) == set(jax_fleet_keys["fleet"])
    assert f["incidents"] == [] and f["redispatched"] == 0
    assert f["healthy"] == 2 and f["transport"] == "inproc"
    assert "fleet_ab" not in s
    assert set(rec["config"]["fleet"]) == CONFIG_FLEET_KEYS
    assert rec["config"]["fleet"]["replicas"] == 2
    # both replicas share the one device: its rate is twice each one's
    assert rec["per_card"] == {"cards": 1, "tokens_per_sec": {
        "clean": round(s["tokens_per_sec_per_chip"] * 2, 1)}}


@pytest.mark.parametrize("transport, hosts, replicas, cards", [
    ("inproc", "", 4, 1),
    ("process", "", 2, 1),
    ("tcp", "", 2, 1),
    ("tcp", "localhost,127.0.0.1", 2, 1),
    ("tcp", "a:7000,b:7000", 2, 2),
    ("tcp", "a:7000,b:7000,c:7000", 2, 2),
    ("tcp", "a:7000,localhost", 3, 2),
])
def test_fleet_cards_are_the_hosts_the_replicas_land_on(
        transport, hosts, replicas, cards):
    args = sb.build_parser().parse_args([
        "--fleet", str(replicas), "--fleet-transport", transport,
        "--fleet-hosts", hosts])
    assert sb.fleet_cards(args) == cards


@pytest.mark.parametrize("argv", [
    ["--fault-plan", "kill:replica=1,at=50%"],
    ["--rolling-update-at", "50%"],
    ["--fault-plan", "slow:replica=0,at=0s,factor=2",
     "--rolling-update-at", "0.05s"],
], ids=["kill", "rolling_update", "slow_and_roll"])
def test_fleet_fault_ab_record_contract(argv, jax_fleet_keys):
    rec = _run("--rate", "200", "--fleet", "2", *argv, "--pin-exact",
               "--require-finished")
    assert rec["metric"] == "serve_fleet_fault_ab_tokens_per_sec_per_chip"
    s = rec["serve"]
    assert s["mode"] == "fleet_fault_ab" and s["by_state"] == \
        {"finished": 6}
    f = s["fleet"]
    assert set(f) == set(jax_fleet_keys["fleet"]) and f["failed"] == 0
    ab = s["fleet_ab"]
    assert set(ab) == FLEET_AB_KEYS
    assert rec["per_card"]["tokens_per_sec"] == {
        side: round(st["tokens_per_sec_per_chip"] * 2, 1)
        for side, st in (("clean", ab["clean"]), ("faulted", s))}
    assert ab["redispatch_pin"] == {"compared": 6, "identical": True}
    assert ab["clean"]["by_state"] == {"finished": 6}
    assert ab["p99_ttft_clean_ms"] is not None
    if "--fault-plan" in argv and "kill" in argv[1]:
        assert f["incidents_by_class"] == {"crashed": 1}
        assert f["incidents"][0]["code"] == -9
    if "--rolling-update-at" in argv:
        assert f["params_version"] == 2 and not f["update_active"]
        assert all(r["version"] == 2 for r in f["per_replica"])
        assert f["incidents_by_class"] == {}
    c = rec["config"]["fleet"]
    assert c["fault_plan"] == (argv[1] if argv[0] == "--fault-plan"
                               else None)


def test_fleet_process_transport_record_contract():
    """One worker process per replica (``--device cpu``): the kill is a
    real SIGKILL, both sides stamp the transport evidence and the pushed
    weights, and no worker outlives the bench."""
    rec = _run("--rate", "200", "--fleet", "2", "--fleet-transport",
               "process", "--fault-plan", "kill:replica=1,at=50%",
               "--pin-exact", "--require-finished")
    s = rec["serve"]
    assert s["mode"] == "fleet_fault_ab" and s["by_state"] == \
        {"finished": 6}
    f = s["fleet"]
    assert f["transport"] == "process"
    assert f["rpc_ms"]["calls"] > 0 and f["rpc_ms"]["p99"] is not None
    assert f["incidents_by_class"] == {"crashed": 1}
    assert f["incidents"][0]["code"] == -9
    assert s["fleet_ab"]["redispatch_pin"]["identical"] is True
    assert s["fleet_ab"]["clean"]["fleet"]["transport"] == "process"
    for block in (f, s["fleet_ab"]["clean"]["fleet"]):
        assert block["per_replica"][0]["params_sha"] == \
            block["per_replica"][1]["params_sha"]
    assert rec["config"]["fleet"]["transport"] == "process"


def test_fleet_ab_prefix_record_contract():
    rec = _run("--fleet", "2", "--ab-prefix", "--pin-exact",
               "--require-finished")
    assert rec["metric"] == "serve_ab_prefix_tokens_per_sec_per_chip"
    s = rec["serve"]
    assert s["mode"] == "ab_prefix" and s["by_state"] == {"finished": 6}
    pb = s["fleet"]["prefix"]
    assert pb["hits"] > 0 and pb["prefill_tokens_saved"] > 0
    ab = s["ab_prefix"]
    assert ab["off"]["fleet"]["prefix"] is None
    assert set(rec["per_card"]["tokens_per_sec"]) == {"off", "on"}
    assert ab["unique_prefixes"] == 1
    assert ab["cold_prefills"] == ab["replica_homes"] >= 1
    assert ab["exact_pin"] == {"compared": 6, "identical": True}


def test_fleet_record_keys_are_the_jax_tools():
    import pathlib

    src = (pathlib.Path(__file__).parent.parent / "tools" /
           "serve_bench.py").read_text()
    for key in FLEET_AB_KEYS | CONFIG_FLEET_KEYS | DISAGG_AB_KEYS | {
            "fleet_fault_ab", "replica_homes", "ab_disagg"}:
        assert f'"{key}"' in src, key
    # the fleet's disagg block: the reference coordinator's stats keys
    ref = (pathlib.Path(__file__).parent.parent / "horovod_tpu" /
           "serve" / "disagg.py").read_text()
    for key in DISAGG_STATS_KEYS:
        assert f'"{key}"' in ref, key


#: Keys of the JAX tool's ``serve.disagg`` block and of the reference
#: coordinator's ``stats()`` (``serve.fleet.disagg``).
DISAGG_AB_KEYS = {"pools", "colocated", "transfers", "kv_bytes_shipped",
                  "transfer_ms_p50", "transfer_ms_p99", "ttft_ms", "tbt_ms",
                  "colocated_ttft_ms", "colocated_tbt_ms", "exact_pin",
                  "redispatch_pin", "p99_ttft_colocated_ms",
                  "p99_ttft_disagg_ms", "disagg_over_colocated"}
DISAGG_STATS_KEYS = {"pools", "transfers", "kv_bytes_shipped",
                     "chunks_shipped", "transfer_ms_p50", "transfer_ms_p99",
                     "parked", "failures"}


def test_fleet_pools_record_contract(jax_fleet_keys):
    rec = _run("--pools", "1,1", "--pin-exact", "--require-finished")
    assert rec["metric"] == "serve_fleet_tokens_per_sec_per_chip"
    s = rec["serve"]
    assert s["mode"] == "fleet" and s["by_state"] == {"finished": 6}
    f = s["fleet"]
    assert set(f) == set(jax_fleet_keys["fleet"])
    d = f["disagg"]
    assert set(d) == DISAGG_STATS_KEYS
    assert d["pools"] == {"prefill": 1, "decode": 1}
    assert d["transfers"] == 6 and d["failures"] == {} and d["parked"] == 0
    assert [r["role"] for r in f["per_replica"]] == ["prefill", "decode"]
    c = rec["config"]["fleet"]
    assert c["replicas"] == 2 and c["pools"] == "1,1"
    assert rec["per_card"] == {"cards": 1, "tokens_per_sec": {
        "clean": round(s["tokens_per_sec_per_chip"] * 2, 1)}}


@pytest.mark.parametrize("argv", [[], ["--fault-plan",
                                       "kill:replica=0,at=50%"]],
                         ids=["clean", "prefill_killed"])
def test_ab_disagg_record_contract(argv):
    rec = _run("--rate", "200", "--pools", "1,1", "--ab-disagg", *argv,
               "--pin-exact", "--require-finished")
    assert rec["metric"] == "serve_ab_disagg_tokens_per_sec_per_chip"
    s = rec["serve"]
    assert s["mode"] == "ab_disagg" and s["by_state"] == {"finished": 6}
    d = s["disagg"]
    assert set(d) == DISAGG_AB_KEYS
    assert d["pools"] == {"prefill": 1, "decode": 1}
    assert d["colocated"]["fleet"]["disagg"] is None
    assert d["transfers"] == s["fleet"]["disagg"]["transfers"] == 6
    assert d["kv_bytes_shipped"] > 0
    assert d["exact_pin"] == {"compared": 6, "identical": True}
    assert d["p99_ttft_colocated_ms"] == d["colocated"]["ttft_ms"]["p99"]
    assert rec["per_card"] == {"cards": 1, "tokens_per_sec": {
        name: round(st["tokens_per_sec_per_chip"] * 2, 1)
        for name, st in (("colocated", d["colocated"]), ("disagg", s))}}
    if argv:
        rp = d["redispatch_pin"]
        assert rp["identical"] is True and rp["compared"] == 6
        assert rp["incidents_by_class"] == {"crashed": 1}
        assert rp["redispatched"] >= 0
    else:
        assert d["redispatch_pin"] is None
    assert rec["config"]["fleet"]["pools"] == "1,1"


def test_disagg_pin_fails_on_a_divergence():
    from horovod_tpu_torch.serve.scheduler import Request

    def req(out):
        r = Request(prompt=np.asarray([1, 2, 3]), max_new_tokens=2)
        r.state, r.output = "finished", out
        return r

    assert sb.pin_disagg_sides([req([1, 2])], [req([1, 2])]) == 1
    with pytest.raises(SystemExit, match="DISAGG AB PIN FAILED"):
        sb.pin_disagg_sides([req([1, 2])], [req([1, 3])])
    with pytest.raises(SystemExit, match="DISAGG AB PIN FAILED"):
        sb.pin_disagg_sides([req([1, 2])], [])


@pytest.mark.parametrize("argv", [
    ["--pools", "1"], ["--pools", "a,b"], ["--pools", "0,2"],
    ["--fleet", "3", "--pools", "1,1"], ["--ab-disagg"],
    ["--pools", "1,1", "--ab-disagg", "--ab-prefix"],
    ["--pools", "1,1", "--ab-disagg", "--rolling-update-at", "50%"],
    ["--pools", "1,1", "--speculate", "2", "--ab-spec"],
    ["--pools", "1,1", "--ab"],
], ids=lambda a: "_".join(x.strip("-").replace(",", "").replace("%", "")
                          for x in a))
def test_pools_bad_args_are_argparse_errors(argv):
    with pytest.raises(SystemExit) as e:
        _run(*argv)
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ["--fault-plan", "kill:replica=0,at=1s"],
    ["--fleet", "2", "--fault-plan", "kill:replica=5,at=1s"],
    ["--fleet", "2", "--fault-plan", "explode:replica=0,at=1s"],
    ["--fleet", "2", "--fault-plan", "stall:replica=0,at=1s"],
    ["--fleet", "2", "--fault-plan", "transfer:replica=0,at=1s"],
    ["--fleet", "2", "--fault-plan", "kill:host=0,at=1s"],
    ["--fleet", "2", "--fleet-transport", "tcp", "--fault-plan",
     "kill:host=1,at=1s"],
    ["--fleet", "2", "--fleet-hosts", "127.0.0.1"],
    ["--fleet", "2", "--fleet-transport", "tcp", "--fleet-hosts",
     "remotebox"],
    ["--fleet", "2", "--ab"], ["--fleet", "2", "--ab-attention"],
    ["--fleet", "2", "--static"], ["--fleet", "-1"],
    ["--rolling-update-at", "50%"],
    ["--fleet", "2", "--rolling-update-at", "soon"],
    ["--fleet", "2", "--ab-prefix", "--fault-plan",
     "kill:replica=1,at=50%"],
    ["--fleet", "2", "--speculate", "2", "--ab-spec"],
    ["--fleet", "2", "--fleet-transport", "carrier"],
], ids=lambda a: "_".join(x.strip("-").replace(":", "")
                          .replace(",", "").replace("=", "")
                          for x in a)[:60])
def test_fleet_bad_args_are_argparse_errors(argv):
    with pytest.raises(SystemExit) as e:
        _run(*argv)
    assert e.value.code == 2
