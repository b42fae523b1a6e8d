"""The port's fleet wire against the reference's, byte for byte.

Every module of the fleet's wire is framework-neutral, so the port keeps
its own copy and these cases hold the copy to ``horovod_tpu``: the frame
codec (``encode_frame`` bytes, the typed failure of every corruption),
RPC both ways (a port ``RpcClient`` against a reference
``serve_connection`` and the reverse, over Unix sockets and over TCP
with the shared-secret handshake), the chunk stream (manifests, chunks,
typed chunk errors, assembly), the KV lane over it (``KvSender``
manifests and chunks, each package's ``KvReceiver`` committing the
other's stream, a params manifest refused typed), the params blob (the same bytes and
sha256 for the same numpy weights in float32 and bfloat16, each package
reading the other's blob and assembling the other's chunks), the
network fault injector, the serving fault grammar (every plan string of
tests/test_serve_fleet.py and tests/test_serve_fleet_tcp.py, valid and
not, with equal actions and equal messages), ``FleetConfig`` (its
disaggregated pools included), the exit
taxonomy, the heartbeat and the watchdog.
"""

import dataclasses
import os
import socket
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.elastic import faults as jfaults
from horovod_tpu.elastic import signals as jsignals
from horovod_tpu.elastic import supervisor as jsupervisor
from horovod_tpu.models import parallel_lm as jlm
from horovod_tpu.run import driver as jdriver
from horovod_tpu.run import network as jnetwork
from horovod_tpu.serve import chunk_stream as jcs
from horovod_tpu.serve import config as jconfig
from horovod_tpu.serve import kv_wire as jkv
from horovod_tpu.serve import netfault as jnetfault
from horovod_tpu.serve import params_wire as jpw
from horovod_tpu.serve import transport as jtr
from horovod_tpu_torch.elastic import faults as tfaults
from horovod_tpu_torch.elastic import signals as tsignals
from horovod_tpu_torch.elastic import supervisor as tsupervisor
from horovod_tpu_torch.models import parallel_lm as tlm
from horovod_tpu_torch.run import driver as tdriver
from horovod_tpu_torch.run import network as tnetwork
from horovod_tpu_torch.serve import chunk_stream as tcs
from horovod_tpu_torch.serve import config as tconfig
from horovod_tpu_torch.serve import kv_wire as tkv
from horovod_tpu_torch.serve import netfault as tnetfault
from horovod_tpu_torch.serve import params_wire as tpw
from horovod_tpu_torch.serve import transport as ttr

V, LMAX, LAYERS, H, DH, FFN = 64, 64, 2, 2, 8, 32


def _map(fn, x):
    """``fn`` over a params tree's leaves, keeping every dict's key order
    (the blob's header records it; ``jax.tree_util.tree_map`` would sort
    the keys)."""
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_map(fn, v) for v in x]
    return fn(x)


NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def np_params():
    return _map(np.asarray, jlm.init_lm_params(
        jax.random.PRNGKey(0), V, LMAX, LAYERS, H, DH, FFN))


def _raises_alike(fj, fp, exc_j, exc_p):
    """Both calls raise the same-named typed error with the same text."""
    with pytest.raises(exc_j) as ej:
        fj()
    with pytest.raises(exc_p) as ep:
        fp()
    assert type(ej.value).__name__ == type(ep.value).__name__
    assert str(ej.value) == str(ep.value)


# ------------------------------------------------------------ frame codec


FRAMES = [{}, {"id": 0, "method": "ping", "params": {}},
          {"id": 7, "ok": True, "result": {"tokens": [1, 2, 3],
                                           "hb": 12, "x": 0.25}},
          [1, "two", None, 3.5, {"k": [True, False]}], "ünïcode",
          {"big": list(range(5000))}]


@pytest.mark.parametrize("obj", FRAMES, ids=range(len(FRAMES)))
def test_encode_frame_bytes_equal(obj):
    assert ttr.encode_frame(obj) == jtr.encode_frame(obj)
    assert ttr.MAGIC == jtr.MAGIC and ttr.HEADER_LEN == jtr.HEADER_LEN
    assert ttr.MAX_FRAME == jtr.MAX_FRAME


def _feed(data: bytes, recv, deadline=0.5):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        a.shutdown(socket.SHUT_WR)
        return recv(b, time.monotonic() + deadline)
    finally:
        a.close()
        b.close()


def _corruptions():
    good = jtr.encode_frame({"id": 3, "ok": True, "result": [1, 2]})
    flipped = bytearray(good)
    flipped[-2] ^= 0x10
    bad_magic = b"XXXX" + good[4:]
    return {
        "torn_payload": good[:-3],
        "torn_header": good[:5],
        "checksum": bytes(flipped),
        "bad_magic": bad_magic,
        "oversized": jtr._HEADER.pack(jtr.MAGIC, jtr.MAX_FRAME + 1, 0),
        "eof_between_frames": b"",
    }


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_every_corruption_is_the_same_typed_error(case):
    data = _corruptions()[case]
    _raises_alike(lambda: _feed(data, jtr.recv_frame),
                  lambda: _feed(data, ttr.recv_frame),
                  jtr.TransportError, ttr.TransportError)


def test_frames_decode_across_packages():
    for obj in FRAMES:
        assert _feed(jtr.encode_frame(obj), ttr.recv_frame) == obj
        assert _feed(ttr.encode_frame(obj), jtr.recv_frame) == obj


@pytest.mark.parametrize("which", ["remote_typed", "remote_text", "local"])
def test_remote_error_kind_matches(which):
    errs = []
    for tr in (jtr, ttr):
        if which == "local":
            e = tr.DeadlineExceeded("late")
        else:
            e = tr.RemoteCallError("push_chunk: worker raised: "
                                   "ChecksumError: crc")
            if which == "remote_typed":
                e.remote_type = "FrameError"
        errs.append(tr.remote_error_kind(e))
    assert errs[0] == errs[1]


# -------------------------------------------------------- RPC both ways


def _handler(method, params):
    if method == "boom":
        raise KeyError("no such rid")
    return {"method": method, "echo": params}


class _Server:
    """One accept loop of a package's ``serve_connection`` (and its
    handshake when ``secret``) on a Unix socket or loopback TCP."""

    def __init__(self, tr, tcp=False, secret=None):
        self.tr, self.secret = tr, secret
        self.dir = None
        self.stop = threading.Event()
        if tcp:
            self.sock = socket.socket()
            self.sock.bind(("127.0.0.1", 0))
            self.addr = ("127.0.0.1", self.sock.getsockname()[1])
        else:
            import tempfile

            self.dir = tempfile.mkdtemp(prefix="hvd-wire-test-")
            self.addr = os.path.join(self.dir, "s.sock")
            self.sock = socket.socket(socket.AF_UNIX)
            self.sock.bind(self.addr)
        self.sock.listen(4)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.is_set():
            self.sock.settimeout(0.1)
            try:
                conn, _ = self.sock.accept()
            except (socket.timeout, OSError):
                continue
            with conn:
                if self.secret and not self.tr.server_handshake(
                        conn, self.secret, time.monotonic() + 5.0):
                    continue
                self.tr.serve_connection(conn, _handler,
                                         should_stop=self.stop.is_set)

    def close(self):
        self.stop.set()
        self.thread.join(5)
        self.sock.close()
        if self.dir is not None:
            import shutil

            shutil.rmtree(self.dir, ignore_errors=True)


@pytest.mark.parametrize("client_pkg, server_pkg",
                         [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("tcp", [False, True], ids=["unix", "tcp"])
def test_rpc_across_packages(client_pkg, server_pkg, tcp):
    pkgs = {"port": ttr, "jax": jtr}
    secret = "s3cret" if tcp else None
    srv = _Server(pkgs[server_pkg], tcp=tcp, secret=secret)
    client = pkgs[client_pkg].RpcClient(srv.addr, default_timeout=5.0,
                                        secret=secret)
    try:
        out = client.call("submit", {"rid": 4, "prompt": [1, 2, 3]})
        assert out == {"method": "submit",
                       "echo": {"rid": 4, "prompt": [1, 2, 3]}}
        with pytest.raises(pkgs[client_pkg].RemoteCallError) as e:
            client.call("boom")
        assert pkgs[client_pkg].remote_error_kind(e.value) == "KeyError"
        assert client.call("ping") == {"method": "ping", "echo": {}}
        assert len(client.call_ms) == 3
    finally:
        client.close()
        srv.close()


@pytest.mark.parametrize("client_pkg, server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_wrong_secret_rejected_across_packages(client_pkg, server_pkg):
    pkgs = {"port": ttr, "jax": jtr}
    srv = _Server(pkgs[server_pkg], tcp=True, secret="right")
    client = pkgs[client_pkg].RpcClient(srv.addr, default_timeout=3.0,
                                        secret="wrong")
    try:
        with pytest.raises(pkgs[client_pkg].ConnectionLost,
                           match="shared-secret mismatch"):
            client.call("ping")
    finally:
        client.close()
        srv.close()


# ------------------------------------------------------------ chunk stream


@pytest.mark.parametrize("chunk_bytes", [1, 7, 64, 1 << 20])
def test_chunk_stream_manifest_and_chunks_equal(chunk_bytes):
    blob = np.random.default_rng(chunk_bytes).bytes(300)
    mj = jcs.make_manifest(blob, kind="kv", version=3,
                           chunk_bytes=chunk_bytes, extra={"rid": 9})
    mp = tcs.make_manifest(blob, kind="kv", version=3,
                           chunk_bytes=chunk_bytes, extra={"rid": 9})
    assert jtr.encode_frame(mj) == ttr.encode_frame(mp)
    for i in range(min(mj["num_chunks"], 12)):
        assert jtr.encode_frame(jcs.make_chunk(blob, mj, i)) == \
            ttr.encode_frame(tcs.make_chunk(blob, mp, i))


def _bad_chunks():
    blob = bytes(range(200))
    man = jcs.make_manifest(blob, kind="kv", version=2, chunk_bytes=64)
    good = jcs.make_chunk(blob, man, 1)
    import base64

    raw = bytearray(base64.b64decode(good["data"]))
    raw[0] ^= 1
    return man, {
        "version_mix": dict(good, version=3),
        "index_range": dict(good, index=9),
        "offset": dict(good, offset=3),
        "crc": dict(good, data=base64.b64encode(bytes(raw)).decode()),
        "truncated": dict(good, data=good["data"][:8]),
        "not_base64": dict(good, data="!!!!"),
        "missing_key": {k: v for k, v in good.items() if k != "crc32"},
        "not_a_mapping": [1, 2],
    }


@pytest.mark.parametrize("case", sorted(_bad_chunks()[1]))
def test_bad_chunks_same_typed_error(case):
    man, bad = _bad_chunks()
    chunk = bad[case]
    _raises_alike(lambda: jcs.check_chunk(man, chunk),
                  lambda: tcs.check_chunk(man, chunk),
                  jtr.TransportError, ttr.TransportError)


@pytest.mark.parametrize("manifest", [
    {"version": 0, "sha256": "0" * 64, "total_bytes": 1,
     "chunk_bytes": 1, "num_chunks": 1},
    {"version": 1, "sha256": "0" * 64, "total_bytes": 10,
     "chunk_bytes": 4, "num_chunks": 2},
    {"version": 1, "sha256": "short", "total_bytes": 1,
     "chunk_bytes": 1, "num_chunks": 1},
    {"version": 1},
], ids=["version", "count", "sha", "missing"])
def test_bad_manifests_same_typed_error(manifest):
    _raises_alike(lambda: jcs.check_manifest(manifest),
                  lambda: tcs.check_manifest(manifest),
                  jtr.FrameError, ttr.FrameError)


def test_buffer_assembler_takes_the_other_packages_chunks():
    blob = np.random.default_rng(5).bytes(1000)
    for send, recv in ((jcs, tcs), (tcs, jcs)):
        man = send.make_manifest(blob, kind="kv", version=1,
                                 chunk_bytes=96)
        asm = recv.BufferAssembler(kind="kv")
        assert asm.begin(man) == 0
        for i in range(5):
            asm.write_chunk(send.make_chunk(blob, man, i))
        # a torn transfer resumes from the verified prefix
        assert asm.begin(man) == 5 * 96
        for i in range(5, man["num_chunks"]):
            asm.write_chunk(send.make_chunk(blob, man, i))
        assert asm.commit() == (blob, send.sha256_hex(blob))


# ------------------------------------------------------------- kv lane


def test_kv_lane_constants_equal():
    assert (tkv.KV_KIND, tkv.KV_WIRE_VERSION) == \
        (jkv.KV_KIND, jkv.KV_WIRE_VERSION)
    from horovod_tpu.serve import kvcache as jkc
    from horovod_tpu_torch.serve import kvcache as tkc

    assert tkc.KV_BLOB_MAGIC == jkc.KV_BLOB_MAGIC


@pytest.mark.parametrize("chunk_bytes", [7, 64, 1 << 20])
def test_kv_sender_manifest_and_chunks_equal(chunk_bytes):
    blob = b"HVKV" + np.random.default_rng(chunk_bytes).bytes(500)
    js, ts = (jkv.KvSender(blob, 17, chunk_bytes),
              tkv.KvSender(blob, 17, chunk_bytes))
    assert jtr.encode_frame(ts.manifest) == jtr.encode_frame(js.manifest)
    assert jtr.encode_frame(tkv.make_kv_manifest(
        blob, rid=17, chunk_bytes=chunk_bytes)) == \
        jtr.encode_frame(js.manifest)
    assert (ts.num_chunks, ts.total_bytes) == (js.num_chunks,
                                               js.total_bytes)
    for i in range(min(ts.num_chunks, 12)):
        assert ttr.encode_frame(ts.chunk(i)) == \
            jtr.encode_frame(js.chunk(i))


@pytest.mark.parametrize("sender,receiver", [(jkv, tkv), (tkv, jkv)],
                         ids=["ref_to_port", "port_to_ref"])
def test_kv_receiver_commits_the_other_packages_stream(sender, receiver):
    blob = np.random.default_rng(3).bytes(1000)
    snd = sender.KvSender(blob, 5, 96)
    recv = receiver.KvReceiver(5)
    assert recv.begin(snd.manifest) == 0
    for i in range(4):
        recv.write_chunk(snd.chunk(i))
    # a re-begin of the same payload resumes from the verified prefix
    assert recv.begin(snd.manifest) == 4 * 96 == recv.have_bytes
    for i in range(4, snd.num_chunks):
        recv.write_chunk(snd.chunk(i))
    assert recv.commit() == blob
    # one request's pages never land under another's table
    other = receiver.KvReceiver(6)
    with pytest.raises(Exception) as e:
        other.begin(snd.manifest)
    assert type(e.value).__name__ == "FrameError"
    assert "rid 5" in str(e.value) and "rid 6" in str(e.value)


def test_params_manifest_fed_to_a_kv_receiver_fails_alike():
    blob = jpw.params_to_blob({"pos": np.zeros((8, 4), np.float32)})
    man = dict(jpw.make_manifest(blob, version=1, chunk_bytes=64), rid=3)
    _raises_alike(lambda: jkv.KvReceiver(3).begin(man),
                  lambda: tkv.KvReceiver(3).begin(man),
                  jtr.FrameError, ttr.FrameError)


# --------------------------------------------------------------- params


def _trees(np_params, dtype):
    """The same weights as numpy leaves and as torch leaves."""
    npt = _map(lambda a: a.astype(NP_DT[dtype]), np_params)
    tt = _map(lambda a: torch.tensor(a).to(TORCH_DT[dtype]),
              np_params)
    return npt, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_blob_bytes_and_sha_equal(np_params, dtype):
    npt, tt = _trees(np_params, dtype)
    jblob = jpw.params_to_blob(npt)
    assert tpw.params_to_blob(npt) == jblob        # numpy leaves
    tblob = tpw.params_to_blob(tt)
    assert tblob == jblob                          # torch leaves
    assert tpw.sha256_hex(tblob) == jpw.sha256_hex(jblob)
    for cb in (1 << 10, 1 << 20):
        assert jtr.encode_frame(jpw.make_manifest(jblob, version=2,
                                                  chunk_bytes=cb)) == \
            ttr.encode_frame(tpw.make_manifest(tblob, version=2,
                                               chunk_bytes=cb))
    assert tpw.blob_spec(tblob) == jpw.blob_spec(jblob)


def test_params_blob_key_order_matches_the_reference(np_params):
    """The port's init_lm_params lays the tree out in the reference's
    key order, so a fleet over the port's own weights ships the blob
    the reference would for the same numbers."""
    tp = tlm.init_lm_params(0, V, LMAX, LAYERS, H, DH, FFN, device="cpu")
    assert tpw.blob_spec(tpw.params_to_blob(tp))["spec"] == \
        jpw.blob_spec(jpw.params_to_blob(np_params))["spec"]
    assert tpw.params_to_blob(tp) == jpw.params_to_blob(
        _map(lambda t: t.numpy(), tp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_reads_the_others_blob(np_params, dtype):
    npt, tt = _trees(np_params, dtype)
    leaves = jax.tree_util.tree_leaves
    back = tpw.params_from_blob(jpw.params_to_blob(npt), device="cpu")
    assert len(leaves(back)) == len(leaves(tt))
    for b, t in zip(leaves(back), leaves(tt)):
        assert b.dtype == TORCH_DT[dtype] and b.shape == t.shape
        assert torch.equal(b, t)
    jback = jpw.params_from_blob(tpw.params_to_blob(tt), as_jax=False)
    for b, a in zip(leaves(jback), leaves(npt)):
        assert b.dtype.name == dtype and b.tobytes() == a.tobytes()


@pytest.mark.parametrize("blob_case", ["short", "magic", "torn_leaf",
                                       "trailing"])
def test_garbage_blobs_same_typed_error(np_params, blob_case):
    good = jpw.params_to_blob({"a": np.arange(6, dtype=np.float32)})
    blob = {"short": good[:3], "magic": b"NOPE" + good[4:],
            "torn_leaf": good[:-2], "trailing": good + b"\0"}[blob_case]
    _raises_alike(lambda: jpw.params_from_blob(blob, as_jax=False),
                  lambda: tpw.params_from_blob(blob),
                  jtr.FrameError, ttr.FrameError)


@pytest.mark.parametrize("sender, receiver",
                         [("jax", "port"), ("port", "jax")])
def test_artifact_assembler_across_packages(tmp_path, np_params, sender,
                                            receiver):
    pkgs = {"port": tpw, "jax": jpw}
    s, r = pkgs[sender], pkgs[receiver]
    blob = s.params_to_blob(np_params)
    man = s.make_manifest(blob, version=4, chunk_bytes=4096)
    asm = r.ArtifactAssembler(str(tmp_path))
    assert asm.begin(man) == 0
    half = man["num_chunks"] // 2
    for i in range(half):
        asm.write_chunk(s.make_chunk(blob, man, i))
    # resume after a torn transfer: a fresh assembler finds the prefix
    asm = r.ArtifactAssembler(str(tmp_path))
    assert asm.begin(man) == half * 4096
    for i in range(half, man["num_chunks"]):
        asm.write_chunk(s.make_chunk(blob, man, i))
    path, sha = asm.commit()
    assert sha == man["sha256"] and os.path.basename(path) == \
        f"params-v4.{sha[:12]}.hvpw"
    with open(path, "rb") as f:
        assert f.read() == blob
    (tmp_path / "params-v3.deadbeef0000.hvpw").write_bytes(b"old")
    (tmp_path / "other.txt").write_bytes(b"keep")
    r.prune_artifacts(str(tmp_path), path)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(path), "other.txt"])


def test_corrupt_artifact_commit_refused_alike(tmp_path):
    blob = jpw.params_to_blob({"a": np.arange(40, dtype=np.float32)})
    man = jpw.make_manifest(blob, version=1, chunk_bytes=64)
    bad = dict(man, sha256="f" * 64)
    errs = []
    for i, pw in enumerate((jpw, tpw)):
        asm = pw.ArtifactAssembler(str(tmp_path / str(i)))
        asm.begin(bad)
        for k in range(man["num_chunks"]):
            asm.write_chunk(pw.make_chunk(blob, bad, k))
        with pytest.raises(Exception) as e:
            asm.commit()
        errs.append((type(e.value).__name__, str(e.value)))
        assert not os.listdir(tmp_path / str(i))   # the temp is gone
    assert errs[0] == errs[1] and errs[0][0] == "ChecksumError"


# ------------------------------------------------------------- netfault


@pytest.mark.parametrize("mode", ["tear", "partition", "delay"])
def test_netfault_resolves_to_the_same_typed_error(mode):
    """The injector at the client seam: each package's NetFaults on its
    own client against a reference server gives the same failure
    class."""
    kinds = []
    for tr, nf in ((jtr, jnetfault), (ttr, tnetfault)):
        srv = _Server(jtr, tcp=True, secret="k")
        faults = nf.NetFaults()
        client = tr.RpcClient(srv.addr, default_timeout=0.6, secret="k",
                              sock_wrap=faults.wrap)
        try:
            client.call("ping")
            if mode == "tear":
                faults.tear_send_frame = 1
            elif mode == "partition":
                faults.partition(None)
            else:
                faults.delay_s = 5.0
            with pytest.raises(tr.TransportError) as e:
                client.call("ping")
            kinds.append(type(e.value).__name__)
            if mode == "tear":
                assert faults.tear_send_frame is None   # one-shot
        finally:
            client.close()
            srv.close()
    assert kinds[0] == kinds[1]


# ---------------------------------------------------------- fault grammar

VALID_PLANS = [
    "kill:replica=1,at=2.5s; stall:replica=0,at=4s; "
    "slow:replica=2,at=1s,factor=3",
    "kill:replica=0,at=40%", "stall:replica=1,at=0.25,secs=2", "",
    "  ;  ", "kill:replica=1,at=0s", "stall:replica=0,at=0s",
    "stall:replica=0,at=0s,secs=0.05", "slow:replica=0,at=0s,factor=3",
    "slow:replica=1,at=0s,factor=2; kill:replica=1,at=0.5s",
    "kill:replica=7,at=1s", "transfer:replica=0,at=1s",
    "corrupt:replica=0,at=1s", "transfer:replica=0,at=50%",
    "kill:host=1,at=2.5s; partition:host=0,at=50%,secs=2",
    "partition:host=0,at=1s", "partition:host=0,at=0s,secs=0.5",
    "kill:host=0,at=0s", "partition:host=1,at=1s,secs=1",
    "partition:host=0,at=1000s,secs=1",
]
INVALID_PLANS = [
    "boom:replica=0,at=1s", "kill:replica=0", "kill:at=1s",
    "kill:replica=-1,at=1s", "kill:replica=0,at=eventually",
    "kill:replica=0,at=nan", "kill:replica=0,at=1e999",
    "kill:replica=0,at=150%", "stall:replica=0,at=1s,secs=nan",
    "slow:replica=0,at=1s,factor=nan", "slow:replica=0,at=1s",
    "slow:replica=0,at=1s,factor=0.5", "kill:replica=0,at=1s,factor=2",
    "kill:replica=0,at=1s,secs=2", "stall:replica=0,at=1s,secs=0",
    "partition:replica=0,at=1s", "stall:host=0,at=1s",
    "slow:host=0,at=1s,factor=2", "kill:replica=0,host=1,at=1s",
    "partition:host=-1,at=1s", "partition:host=x,at=1s",
    "partition:host=0,at=1s,factor=2", "partition:host=0,at=1s,secs=0",
    "kill:replica=x,at=1s", "kill:replica=0,bogus=1,at=1s",
    "stall:replica=0,at=1s,secs=abc", "slow:replica=0,at=1s,factor=x",
    "kill", "kill:replica=0,at=-1s",
]


@pytest.mark.parametrize("plan", VALID_PLANS)
def test_valid_plans_parse_to_equal_actions(plan):
    ja = jfaults.parse_serve_fault_plan(plan)
    ta = tfaults.parse_serve_fault_plan(plan)
    assert [dataclasses.asdict(a) for a in ja] == \
        [dataclasses.asdict(a) for a in ta]
    assert [str(a) for a in ja] == [str(a) for a in ta]
    for a, b in zip(ja, ta):
        if a.at_frac is not None:
            assert a.resolve_at(8.0) == b.resolve_at(8.0)


@pytest.mark.parametrize("plan", INVALID_PLANS)
def test_invalid_plans_fail_with_equal_messages(plan):
    _raises_alike(lambda: jfaults.parse_serve_fault_plan(plan),
                  lambda: tfaults.parse_serve_fault_plan(plan),
                  jfaults.FaultPlanError, tfaults.FaultPlanError)


@pytest.mark.parametrize("kw", [
    dict(kind="slow", replica=0, at=1.0), dict(kind="kill", replica=0),
    dict(kind="partition", replica=0, at=1.0),
    dict(kind="kill", replica=0, host=1, at=1.0),
    dict(kind="stall", replica=0, at=1.0, secs=-1.0),
    dict(kind="kill", replica=0, at=0.5, at_frac=0.5),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_hand_built_actions_validate_alike(kw):
    _raises_alike(lambda: jfaults.ServeFaultAction(**kw).validate(),
                  lambda: tfaults.ServeFaultAction(**kw).validate(),
                  jfaults.FaultPlanError, tfaults.FaultPlanError)


def test_percent_action_needs_a_horizon_alike():
    _raises_alike(
        lambda: jfaults.parse_serve_fault_plan(
            "kill:replica=0,at=40%")[0].resolve_at(None),
        lambda: tfaults.parse_serve_fault_plan(
            "kill:replica=0,at=40%")[0].resolve_at(None),
        jfaults.FaultPlanError, tfaults.FaultPlanError)
    assert tfaults.SERVE_KINDS == jfaults.SERVE_KINDS


# ------------------------------------------------------------ FleetConfig


@pytest.mark.parametrize("kw", [
    {}, dict(replicas=3, max_queue=4, max_restarts=0),
    dict(transport="process", rpc_deadline=5.0, push_chunk_bytes=64),
    dict(transport="tcp", hosts=["127.0.0.1", "localhost:9000",
                                 "hostb:47000"]),
    dict(watchdog_timeout=0.4, backoff_base=0.2, backoff_cap=10.0),
], ids=range(5))
def test_fleet_config_asdict_equal(kw):
    assert dataclasses.asdict(tconfig.FleetConfig(**kw)) == \
        dataclasses.asdict(jconfig.FleetConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(replicas=0), dict(max_queue=-1), dict(max_restarts=-1),
    dict(backoff_base=3.0), dict(watchdog_timeout=-1),
    dict(retry_after_min=0), dict(transport="carrier-pigeon"),
    dict(rpc_deadline=0), dict(spawn_timeout=0),
    dict(shutdown_deadline=0), dict(push_chunk_bytes=0),
    dict(push_chunk_bytes=(8 << 20) + 1), dict(push_retries=-1),
    dict(hosts=("hosta:5000",)),
    dict(transport="tcp", hosts=("/tmp/worker.sock",)),
    dict(transport="tcp", hosts=("a:5000", "b:6000", "a:5000")),
    dict(transport="tcp", hosts=("remotebox",)),
    dict(transport="tcp", hosts=("a:http",)),
    dict(transport="tcp", hosts=("a:70000",)),
    dict(transport="tcp", hosts="127.0.0.1:5000"),
    dict(transport="tcp", hosts=(":80",)),
], ids=range(21))
def test_fleet_config_validation_messages_equal(kw):
    _raises_alike(lambda: jconfig.FleetConfig(**kw),
                  lambda: tconfig.FleetConfig(**kw),
                  ValueError, ValueError)


@pytest.mark.parametrize("kw", [
    dict(replicas=2, pools={"prefill": 1, "decode": 1}),
    dict(replicas=5, pools={"decode": 3, "prefill": 2},
         transport="process"),
    dict(replicas=2, pools=(("prefill", 1), ("decode", 1)),
         transport="tcp"),
], ids=range(3))
def test_pools_fleet_config_asdict_equal(kw):
    t, j = tconfig.FleetConfig(**kw), jconfig.FleetConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t == tconfig.FleetConfig(**dataclasses.asdict(t))
    assert t.prefill_replicas == j.prefill_replicas
    assert [t.pool_of(i) for i in range(t.replicas)] == \
        [j.pool_of(i) for i in range(j.replicas)]


def test_local_hosts_and_host_entries_equal():
    assert tconfig.LOCAL_HOSTS == jconfig.LOCAL_HOSTS
    for e in ("h", "h:1", "127.0.0.1:65535", " x:9 "):
        assert tconfig.parse_host_entry(e) == jconfig.parse_host_entry(e)


# --------------------------------------------- exit taxonomy, heartbeats


@pytest.mark.parametrize("code", [0, 1, 2, 75, 76, -9, -15, -11, 255,
                                  137])
def test_exit_taxonomy_matches(code):
    assert tdriver.classify_exit(code) == jdriver.classify_exit(code)
    for stalled in (False, True):
        j = jdriver.WorkerExit(rank=3, code=code, stalled=stalled)
        t = tdriver.WorkerExit(rank=3, code=code, stalled=stalled)
        assert t.category == j.category
        assert t.describe(role="replica") == j.describe(role="replica")
    for name in ("EXIT_CLEAN", "EXIT_USAGE", "EXIT_PREEMPTED",
                 "EXIT_RESIZED"):
        assert getattr(tdriver, name) == getattr(jdriver, name)


def test_secret_and_advertised_address(monkeypatch):
    k = tnetwork.make_secret_key()
    assert isinstance(k, bytes) and len(k) == len(
        jnetwork.make_secret_key()) == 32
    assert tnetwork.make_secret_key() != k
    for mod in (tnetwork, jnetwork):
        monkeypatch.setattr(mod, "_route_probe_ip", lambda: None)
        monkeypatch.setattr(mod, "_hostname_ips",
                            lambda: ["127.0.0.1", "10.1.2.3"])
    assert tnetwork.advertise_ip() == jnetwork.advertise_ip() == \
        "10.1.2.3"
    for mod in (tnetwork, jnetwork):
        monkeypatch.setattr(mod, "_hostname_ips", lambda: [])
    assert tnetwork.advertise_ip() == jnetwork.advertise_ip() == \
        "127.0.0.1"


def test_heartbeat_and_watchdog_match(tmp_path):
    now = [100.0]
    stale = {}
    for name, sig, sup in (("j", jsignals, jsupervisor),
                           ("t", tsignals, tsupervisor)):
        base = str(tmp_path / name)
        d1 = sig.namespaced_heartbeat_dir(base)
        d2 = sig.namespaced_heartbeat_dir(base)
        assert d1 != d2 and os.path.dirname(d1) == base
        hb0, hb1 = sig.Heartbeat(d1, rank=0), sig.Heartbeat(d1, rank=1)
        assert os.path.basename(hb1.path) == "hb-1"
        hb0.touch(3)
        hb1.touch(4)
        old = time.time() - 10
        os.utime(hb1.path, (old, old))
        wd = sup.HealthWatchdog(d1, timeout=5.0, interval=1.0,
                                _now=lambda: now[0])
        got = wd.check([0, 1, 2])
        assert wd.check([0, 1, 2]) == {}          # throttled
        stale[name] = sorted(got)
    assert stale["j"] == stale["t"] == [1]
