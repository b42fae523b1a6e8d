"""Deadline-checked frame protocol for the cross-process serving fleet.

The port's copy of ``horovod_tpu.serve.transport``, stdlib-only like the
reference: frames, handshake and typed errors are byte-for-byte the
same, so a port client talks to a reference worker and a reference
client to a port worker.

One replica worker (:mod:`horovod_tpu_torch.serve.worker`) serves its RPCs
over a Unix-domain socket (``FleetConfig(transport="process")``) or a
TCP listener (``transport="tcp"`` — the multi-host placement); the
router side (:class:`~horovod_tpu_torch.serve.fleet.ServeFleet`) talks to it
through :class:`RpcClient` either way — the address is a filesystem
path for Unix sockets or a ``(host, port)`` tuple for TCP, and the
frame discipline below is byte-identical on both. The wire format is
deliberately minimal and fully checkable:

``[4B magic "HVSF"][4B big-endian payload length][4B CRC32][payload]``

with the payload UTF-8 JSON. No pickle: the peer is a child process of
the router, but a worker that died mid-write (the whole point of this
transport is surviving exactly that) leaves arbitrary byte garbage on
the stream, and a codec that cannot mis-parse garbage into a live
object is the difference between "replica crashed, drained, and
redispatched" and a corrupted router.

Failure taxonomy — every way the wire can fail maps to ONE typed
exception, and every receive is bounded by a deadline (the silent-hang
shape this module must never have):

* :class:`DeadlineExceeded` — the per-RPC deadline expired (worker
  wedged mid-compute, or a frame stopped arriving mid-stream);
* :class:`ConnectionLost` — refused / reset / EOF *between* frames
  (the worker process is gone);
* :class:`FrameError` — a torn frame (EOF or garbage mid-frame: the
  kill-mid-write shape), bad magic, an oversized length, undecodable
  payload, or a duplicated/interleaved reply (response id mismatch);
* :class:`ChecksumError` — the frame arrived complete but its CRC32
  does not match (bit corruption);
* :class:`RemoteCallError` — the frame layer is healthy but the worker
  raised inside the handler.

The RPC layer never retries: any :class:`TransportError` means the
caller must treat the replica as DEAD and route into the fleet's
drain/redispatch path (at-most-once delivery is the fleet's invariant,
and a blind resend could double-apply a ``submit``). docs/serving.md
"Process fleet" / "Multi-host fleet" carry the deadline table and the
failure → action matrix.

TCP adds one thing Unix sockets never needed: a **connect handshake**.
A Unix socket is reachable only through the filesystem; a TCP listener
is reachable by anything that can route to the port, so every accepted
connection must prove it holds the fleet's shared secret before a
single RPC frame is served (:func:`server_handshake` /
:func:`client_handshake` — an HMAC-SHA256 challenge/response over the
same frame codec, the ``run/network.py`` secret discipline applied to
the serving wire; the secret itself never crosses the wire, and over
ssh placement it ships via stdin, never argv).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import re
import socket
import struct
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

#: An RPC endpoint: a Unix-socket filesystem path, or a TCP
#: ``(host, port)`` pair.
Address = Union[str, Tuple[str, int]]

#: Frame magic. A reply that starts with anything else is byte garbage
#: (a torn previous frame, or a non-worker peer) — never parsed.
MAGIC = b"HVSF"
_HEADER = struct.Struct(">4sII")   # magic, payload length, CRC32
HEADER_LEN = _HEADER.size

#: Frames are control-plane JSON (requests, token ids, stats) — a
#: length field above this is corruption, not a real payload, and must
#: not turn into a giant allocation + an unbounded read.
MAX_FRAME = 16 << 20

#: recv() slice while waiting out a deadline, so a close()d socket or
#: process exit is noticed promptly even under a long deadline.
_POLL_SLICE = 0.25


class TransportError(RuntimeError):
    """Base of every wire failure. The fleet maps ANY of these to the
    replica-death path (drain + redispatch + relaunch) — no RPC-level
    retry, ever."""


class DeadlineExceeded(TransportError):
    """The per-RPC deadline expired before the full reply arrived."""


class ConnectionLost(TransportError):
    """Connection refused/reset, or EOF on a frame boundary — the
    worker process is gone (or never came up)."""


class FrameError(TransportError):
    """Torn or malformed frame: EOF mid-frame (kill-mid-write), bad
    magic, oversized length, undecodable payload, or a reply whose id
    does not match the in-flight request (duplicate/interleave)."""


class ChecksumError(FrameError):
    """Complete frame, wrong CRC32: the bytes were corrupted in
    flight or by a partially-flushed writer."""


class RemoteCallError(TransportError):
    """The worker's handler raised; the error text rode back over a
    healthy frame layer. Still a replica-death signal: an engine that
    raises mid-step is the crash shape (the in-process fleet treats it
    identically). The ONE exception is the params-push lane
    (``push_begin``/``push_chunk``/``push_commit``): chunk writes are
    idempotent and digest-verified, so the fleet retries those under
    its budgeted backoff instead of killing the replica — see
    :func:`remote_error_kind` for how a worker-side typed rejection
    (e.g. the transfer codec's ``ChecksumError``) is classified."""


def remote_error_kind(err: TransportError) -> str:
    """Incident-classification label for a transport failure: for a
    :class:`RemoteCallError` the WORKER-side exception class name (the
    handler's typed error — e.g. the transfer codec's ``ChecksumError``
    riding back over a healthy frame layer), else the local typed
    class. The fleet stamps this into ``transfer_incidents`` /
    ``transport_incidents`` so a corrupted chunk and a torn connection
    stay distinguishable in the record. The class name rides the
    reply's structured ``error_type`` field (set by
    :func:`serve_connection`, stamped onto the exception by
    :meth:`RpcClient.call`); the message-parse below is only the
    fallback for a peer speaking an older reply shape."""
    if isinstance(err, RemoteCallError):
        kind = getattr(err, "remote_type", None)
        if kind:
            return str(kind)
        m = re.search(r"worker raised: ([A-Za-z_][A-Za-z0-9_]*)",
                      str(err))
        if m:
            return m.group(1)
    return type(err).__name__


def encode_frame(obj: Any) -> bytes:
    """One message -> wire bytes (header + JSON payload)."""
    payload = json.dumps(obj).encode("utf-8")
    if len(payload) > MAX_FRAME:
        raise FrameError(
            f"payload of {len(payload)} bytes exceeds MAX_FRAME "
            f"({MAX_FRAME}) — not a control-plane message")
    return _HEADER.pack(MAGIC, len(payload),
                        zlib.crc32(payload)) + payload


def _deadline(timeout: Optional[float]) -> Optional[float]:
    return None if timeout is None else time.monotonic() + timeout


def _remaining(deadline: Optional[float]) -> Optional[float]:
    if deadline is None:
        return None
    return deadline - time.monotonic()


def recv_exact(sock: socket.socket, n: int, deadline: Optional[float],
               *, mid_frame: bool) -> bytes:
    """Read exactly ``n`` bytes with every recv bounded by ``deadline``
    (an absolute ``time.monotonic`` stamp; None = wait forever, which
    no fleet-side caller uses). EOF maps to :class:`ConnectionLost` on
    a frame boundary (``mid_frame=False``, nothing read yet) and to
    :class:`FrameError` once any frame byte has been consumed — the
    kill-mid-write distinction the drain path keys on."""
    buf = b""
    while len(buf) < n:
        remaining = _remaining(deadline)
        if remaining is not None and remaining <= 0:
            raise DeadlineExceeded(
                f"deadline expired after {len(buf)}/{n} bytes")
        slice_ = _POLL_SLICE if remaining is None \
            else min(_POLL_SLICE, remaining)
        sock.settimeout(slice_)
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            continue   # poll slice over; re-check the real deadline
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ConnectionLost(f"connection reset: {e}") from None
        except OSError as e:
            raise ConnectionLost(f"socket error: {e}") from None
        if not chunk:
            if mid_frame or buf:
                raise FrameError(
                    f"torn frame: peer closed after {len(buf)}/{n} "
                    "bytes (writer died mid-frame)")
            raise ConnectionLost("peer closed the connection")
        buf += chunk
    return buf


def send_frame(sock: socket.socket, obj: Any,
               deadline: Optional[float]) -> None:
    """Write one frame, bounded by ``deadline`` (absolute monotonic)."""
    data = encode_frame(obj)
    remaining = _remaining(deadline)
    if remaining is not None and remaining <= 0:
        raise DeadlineExceeded("deadline expired before send")
    sock.settimeout(remaining)
    try:
        sock.sendall(data)
    except socket.timeout:
        raise DeadlineExceeded(
            "deadline expired mid-send (peer not draining)") from None
    except (ConnectionResetError, BrokenPipeError) as e:
        raise ConnectionLost(f"connection lost mid-send: {e}") from None
    except OSError as e:
        raise ConnectionLost(f"socket error mid-send: {e}") from None


def recv_frame(sock: socket.socket, deadline: Optional[float]) -> Any:
    """Read + validate one frame; returns the decoded JSON value.
    Every corruption mode raises a typed :class:`TransportError` —
    never a hang (deadline-bounded reads), never a mis-parsed payload
    (magic + length bound + CRC32 + strict JSON)."""
    header = recv_exact(sock, HEADER_LEN, deadline, mid_frame=False)
    magic, length, crc = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameError(
            f"bad frame magic {magic!r} (desynchronized or corrupt "
            "stream)")
    if length > MAX_FRAME:
        raise FrameError(
            f"frame length {length} exceeds MAX_FRAME ({MAX_FRAME}) — "
            "corrupt length field")
    payload = recv_exact(sock, length, deadline, mid_frame=True)
    if zlib.crc32(payload) != crc:
        raise ChecksumError(
            f"checksum mismatch on a {length}-byte frame")
    try:
        return json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise FrameError(f"undecodable frame payload: {e}") from None


# ------------------------------------------------------------- handshake
#
# TCP listeners are network-reachable, so a connection must prove it
# holds the fleet's shared secret before any RPC is served. The
# challenge/response rides the frame codec itself: server sends a
# random nonce, client answers HMAC-SHA256(secret, nonce), server
# compares in constant time and acks. An unauthenticated peer never
# reaches the handler, and the secret never crosses the wire.


def _handshake_mac(secret: str, nonce: str) -> str:
    # utf-8 on both legs: encoding a str can then never raise, so an
    # adversarial (non-ASCII) nonce or auth value from the wire can
    # only ever FAIL the comparison — never throw past the typed
    # taxonomy (a TypeError/UnicodeEncodeError here would kill the
    # worker's only accept thread / leak the client's socket).
    return hmac.new(secret.encode("utf-8"), nonce.encode("utf-8"),
                    hashlib.sha256).hexdigest()


def server_handshake(sock: socket.socket, secret: str,
                     deadline: Optional[float]) -> bool:
    """Worker-side challenge/response on one accepted connection.
    Returns True when the peer proved the shared secret; False (after a
    best-effort rejection ack) otherwise — the caller drops the
    connection and keeps accepting. Never raises: a garbage or silent
    peer is just an unauthenticated one."""
    nonce = os.urandom(16).hex()
    try:
        send_frame(sock, {"hvsf": 1, "nonce": nonce}, deadline)
        reply = recv_frame(sock, deadline)
    except TransportError:
        return False
    auth = reply.get("auth") if isinstance(reply, dict) else None
    # Compare BYTES: compare_digest on str raises TypeError for
    # non-ASCII input, and this function's contract is never-raise —
    # an unauthenticated peer must only ever be dropped.
    ok = isinstance(auth, str) and hmac.compare_digest(
        auth.encode("utf-8"),
        _handshake_mac(secret, nonce).encode("utf-8"))
    try:
        send_frame(sock, {"ok": bool(ok)}, deadline)
    except TransportError:
        return False
    return ok


def client_handshake(sock: socket.socket, secret: str,
                     deadline: Optional[float]) -> None:
    """Router-side half: answer the server's nonce challenge. Raises a
    typed :class:`TransportError` on any failure — a rejected handshake
    (secret mismatch) is :class:`ConnectionLost`, because to the fleet
    it IS one: the replica can never be spoken to."""
    challenge = recv_frame(sock, deadline)
    nonce = challenge.get("nonce") if isinstance(challenge, dict) else None
    if not isinstance(nonce, str):
        raise FrameError(
            f"handshake: expected a nonce challenge, got {challenge!r}")
    send_frame(sock, {"auth": _handshake_mac(secret, nonce)}, deadline)
    ack = recv_frame(sock, deadline)
    if not (isinstance(ack, dict) and ack.get("ok")):
        raise ConnectionLost(
            "handshake rejected by the worker — shared-secret mismatch "
            "(is HOROVOD_SECRET the fleet's secret on both ends?)")


class RpcClient:
    """Fleet-side RPC stub over one Unix-socket or TCP connection.

    Every :meth:`call` carries its own deadline (``timeout``, default
    ``default_timeout``); the request/response pair shares it — a
    worker that accepted the request but never answers is
    indistinguishable from one that wedged mid-parse, and both resolve
    as :class:`DeadlineExceeded` within the budget. Replies carry the
    request's ``id`` and a mismatch (a duplicated or interleaved frame,
    e.g. a stale reply surviving a half-torn stream) raises
    :class:`FrameError`. After ANY transport error the connection is
    closed; on the normal RPC surface the fleet then replaces the
    replica — it never resends (a resent ``submit`` could
    double-apply). The ONE exception is the params-push lane
    (``push_begin``/``push_chunk``/``push_commit``): those calls are
    idempotent and digest-verified, so the fleet retries them through
    this same client (the next :meth:`call` reconnects), resuming the
    transfer from the worker's verified offset.

    ``proc_alive`` (optional callable) lets :meth:`connect` fail fast
    with :class:`ConnectionLost` when the worker process has already
    exited instead of retrying the socket until the deadline — the
    worker-dies-on-startup shape.

    ``connect_timeout`` (optional) separately bounds how long the
    FIRST connect after a (re)spawn may retry while the worker binds
    its socket — the fleet passes ``FleetConfig.spawn_timeout`` so a
    worker that never comes up fails at
    ``min(spawn_timeout, rpc_deadline)`` rather than consuming a
    generous per-RPC budget on every doomed call.

    ``call_ms`` (optional shared list) accumulates per-call wall
    milliseconds — the fleet aggregates them across replica
    incarnations into the ``rpc_ms`` overhead stamp.

    ``path`` may be a Unix-socket filesystem path or a TCP
    ``(host, port)`` tuple. TCP connections additionally take
    ``secret`` (the fleet's shared secret: every fresh connection runs
    the :func:`client_handshake` challenge/response before the first
    RPC) and ``sock_wrap`` (a ``sock -> sock`` hook applied to every
    fresh connection — the seam the deterministic network fault
    injector, :mod:`horovod_tpu_torch.serve.netfault`, plugs into).
    """

    def __init__(self, path: Address, *, default_timeout: float = 60.0,
                 connect_timeout: Optional[float] = None,
                 proc_alive: Optional[Callable[[], bool]] = None,
                 call_ms: Optional[List[float]] = None,
                 secret: Optional[str] = None,
                 sock_wrap: Optional[
                     Callable[[socket.socket], socket.socket]] = None):
        self.path = path
        self.default_timeout = float(default_timeout)
        self.connect_timeout = connect_timeout
        self._proc_alive = proc_alive
        self.call_ms = call_ms if call_ms is not None else []
        self.secret = secret
        self._sock_wrap = sock_wrap
        self._sock: Optional[socket.socket] = None
        self._next_id = 0

    @property
    def connected(self) -> bool:
        return self._sock is not None

    @property
    def _is_tcp(self) -> bool:
        return isinstance(self.path, tuple)

    def _endpoint(self) -> str:
        return (f"{self.path[0]}:{self.path[1]}" if self._is_tcp
                else str(self.path))

    def connect(self, timeout: Optional[float] = None) -> None:
        """Connect, retrying while the socket file is absent or the
        listener not yet up (the worker binds before its heavy torch
        import, but a relaunch can race). Gives up early when
        ``proc_alive`` reports the worker dead. TCP connections run the
        shared-secret handshake before the client counts as connected —
        a replica we cannot authenticate to is one we cannot speak to."""
        if self._sock is not None:
            return
        deadline = _deadline(timeout if timeout is not None
                             else self.default_timeout)
        family = socket.AF_INET if self._is_tcp else socket.AF_UNIX
        target = tuple(self.path) if self._is_tcp else self.path
        while True:
            sock = socket.socket(family, socket.SOCK_STREAM)
            try:
                remaining = _remaining(deadline)
                if remaining is not None and remaining <= 0:
                    sock.close()
                    raise DeadlineExceeded(
                        f"could not connect to worker at "
                        f"{self._endpoint()} before the deadline")
                sock.settimeout(remaining)
                sock.connect(target)
                break
            except socket.timeout:
                sock.close()
                raise DeadlineExceeded(
                    f"connect to {self._endpoint()} timed out") from None
            except (FileNotFoundError, ConnectionRefusedError) as e:
                sock.close()
                if self._proc_alive is not None and \
                        not self._proc_alive():
                    raise ConnectionLost(
                        f"worker exited before serving "
                        f"{self._endpoint()} (died on startup?)"
                    ) from None
                remaining = _remaining(deadline)
                if remaining is not None and remaining <= 0:
                    raise DeadlineExceeded(
                        f"worker never listened on {self._endpoint()}: "
                        f"{e}") from None
                time.sleep(0.02)
            except OSError as e:
                sock.close()
                raise ConnectionLost(
                    f"connect to {self._endpoint()} failed: {e}"
                ) from None
        if self._sock_wrap is not None:
            sock = self._sock_wrap(sock)
        if self.secret is not None:
            try:
                client_handshake(sock, self.secret, deadline)
            except Exception:
                # Typed or not (defense in depth), a failed handshake
                # must never leak the connected socket.
                sock.close()
                raise
        self._sock = sock

    def call(self, method: str, params: Optional[Dict] = None,
             timeout: Optional[float] = None) -> Any:
        """One request/response round trip under one deadline."""
        budget = self.default_timeout if timeout is None else timeout
        deadline = _deadline(budget)
        if self._sock is None:
            connect_budget = _remaining(deadline)
            if self.connect_timeout is not None:
                connect_budget = min(connect_budget,
                                     self.connect_timeout)
            self.connect(connect_budget)
        rid = self._next_id
        self._next_id += 1
        t0 = time.perf_counter()
        try:
            send_frame(self._sock, {"id": rid, "method": method,
                                    "params": params or {}}, deadline)
            resp = recv_frame(self._sock, deadline)
        except TransportError:
            self.close()
            raise
        self.call_ms.append((time.perf_counter() - t0) * 1e3)
        if not isinstance(resp, dict) or resp.get("id") != rid:
            self.close()
            raise FrameError(
                f"reply id {resp.get('id') if isinstance(resp, dict) else resp!r} "
                f"does not match request id {rid} (duplicated or "
                "interleaved frame)")
        if not resp.get("ok"):
            err = RemoteCallError(
                f"{method}: worker raised: {resp.get('error')}")
            # Structured worker-side exception class (what
            # remote_error_kind classifies by) — never parsed back out
            # of the human-readable message.
            err.remote_type = resp.get("error_type")
            raise err
        return resp.get("result")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


def serve_connection(sock: socket.socket,
                     handler: Callable[[str, Dict], Any],
                     *, idle_timeout: Optional[float] = None,
                     should_stop: Optional[Callable[[], bool]] = None,
                     send_hook: Optional[
                         Callable[[socket.socket, bytes], bool]] = None
                     ) -> None:
    """Worker-side request loop over ONE accepted connection.

    Each request is answered with ``{"id", "ok", "result"}`` or
    ``{"id", "ok": False, "error"}`` (handler exceptions ride back as
    errors — the client surfaces them as :class:`RemoteCallError`).
    Waiting for the NEXT request polls in deadline-bounded slices
    (never an unbounded recv — the worker is held to it too)
    so ``should_stop`` is honored promptly; ``idle_timeout`` bounds
    how long an idle connection is held. Returns when the peer
    disconnects, the idle timeout passes, or ``should_stop`` fires.

    ``send_hook(sock, frame_bytes) -> bool`` (test instrumentation)
    may take over sending a reply; returning True means it did.
    """
    idle_since = time.monotonic()
    while True:
        if should_stop is not None and should_stop():
            return
        # Idle wait is a PEEK in poll slices, separate from the frame
        # read: a frame arriving slowly across slices must not have its
        # first bytes consumed-and-discarded by an aborted read (that
        # would desynchronize the stream on the next loop).
        sock.settimeout(_POLL_SLICE)
        try:
            first = sock.recv(1, socket.MSG_PEEK)
        except socket.timeout:
            if idle_timeout is not None and \
                    time.monotonic() - idle_since > idle_timeout:
                return
            continue
        except OSError:
            return
        if not first:
            return   # peer closed between frames
        try:
            req = recv_frame(sock, _deadline(30.0))
        except TransportError:
            return     # peer gone or stream corrupt: drop the conn
        idle_since = time.monotonic()
        rid = req.get("id") if isinstance(req, dict) else None
        try:
            result = handler(req.get("method", ""),
                             req.get("params") or {})
            resp = {"id": rid, "ok": True, "result": result}
        except Exception as e:   # surfaced to the client, conn lives
            resp = {"id": rid, "ok": False,
                    "error_type": type(e).__name__,
                    "error": f"{type(e).__name__}: {e}"}
        frame = encode_frame(resp)
        if send_hook is not None and send_hook(sock, frame):
            continue
        try:
            sock.settimeout(30.0)
            sock.sendall(frame)
        except OSError:
            return


__all__ = [
    "Address", "ChecksumError", "ConnectionLost", "DeadlineExceeded",
    "FrameError", "HEADER_LEN", "MAGIC", "MAX_FRAME", "RemoteCallError",
    "RpcClient", "TransportError", "client_handshake", "encode_frame",
    "recv_exact", "recv_frame", "remote_error_kind", "send_frame",
    "serve_connection", "server_handshake",
]
