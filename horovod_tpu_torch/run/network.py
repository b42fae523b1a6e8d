"""TCP RPC with an HMAC-SHA256-authenticated pickle wire format.

The port of ``horovod_tpu.run.network``: :func:`make_secret_key`,
:func:`advertise_ip` and :func:`candidate_addresses`, and the launcher's
authenticated RPC (:class:`Wire`, :class:`BasicService`,
:class:`BasicClient`), which carries worker registration, the task
function, its arguments and the results. The serving fleet's TCP
transport takes a fresh secret per fleet from :func:`make_secret_key`,
and a TCP worker bound to a wildcard prints :func:`advertise_ip`.

Security model (the reference's): pickle bytes from the network are
only ever unpickled after their HMAC digest checks against the job's
ephemeral shared secret, which never leaves the launcher's process tree
(it travels in the environment).

Objects are pickled with the standard :mod:`pickle`. Only an object
that standard pickle cannot ship by reference (a lambda, a closure, a
function or class of ``__main__``, which the worker cannot import) is
pickled with ``cloudpickle``, when it is installed; without it such an
object raises a :class:`pickle.PicklingError` naming the way out (a
module-level function of an importable module). Frames read with
``pickle.loads`` either way (``cloudpickle.loads`` is ``pickle.loads``),
so the JAX package's frames and the port's read each other.
"""

from __future__ import annotations

import hashlib
import hmac
import io
import pickle
import secrets as _secrets
import socket
import socketserver
import struct
import threading
import time
import types
from typing import Any, Callable, Optional

DIGEST_LEN = hashlib.sha256().digest_size
MAX_FRAME = 1 << 30


def make_secret_key() -> bytes:
    """32 random bytes (reference secret.py:21-26)."""
    return _secrets.token_bytes(32)


def _route_probe_ip():
    """The default-route interface's IP via the UDP-connect trick (no
    packet is sent — ``connect`` on a datagram socket only selects the
    route). Returns None instead of raising: on an air-gapped or
    offline host the kernel has no route to 8.8.8.8 and ``connect``
    raises ``OSError`` (ENETUNREACH) — that must degrade to the next
    resolution rung, never kill address discovery."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("8.8.8.8", 80))  # no traffic: picks the route only
            return s.getsockname()[0] or None
    except OSError:
        return None


def _hostname_ips():
    """Every IPv4 address the hostname resolves to ([] when resolution
    fails — a bare container with no /etc/hosts entry)."""
    try:
        return [info[4][0]
                for info in socket.getaddrinfo(socket.gethostname(), None,
                                               socket.AF_INET)]
    except (socket.gaierror, OSError):
        return []


def advertise_ip() -> str:
    """The single best address to ADVERTISE a locally-bound service at,
    with the offline-host fallback chain: default-route interface (the
    UDP-connect probe) -> hostname resolution (first non-loopback
    address) -> loopback. Never raises — an air-gapped host where the
    route probe gets ``OSError`` still resolves (the serving fleet's
    TCP workers print their advertised endpoint through this)."""
    ip = _route_probe_ip()
    if ip:
        return ip
    for ip in _hostname_ips():
        if ip and not ip.startswith("127."):
            return ip
    return "127.0.0.1"


def candidate_addresses(port: int) -> list:
    """Every plausible ``host:port`` endpoint a service bound on 0.0.0.0
    of this machine can be reached at: loopback, the hostname's
    addresses, and the default-route interface (:func:`advertise_ip`'s
    chain). On a multi-NIC host only some of these reach a given worker,
    so the driver publishes them all and each worker probes
    (:func:`horovod_tpu_torch.run.driver.probe_service`)."""
    ips = ["127.0.0.1"]

    def add(ip: str) -> None:
        if ip and ip not in ips:
            ips.append(ip)

    for ip in _hostname_ips():
        add(ip)
    add(advertise_ip())
    return [f"{ip}:{port}" for ip in ips]


class IntegrityError(RuntimeError):
    pass


def _by_value_only(obj) -> bool:
    """Whether standard pickle would ship ``obj`` by a reference the
    worker cannot resolve: a function or class of ``__main__``, a lambda
    or a closure."""
    if not isinstance(obj, (types.FunctionType, type)):
        return False
    qual = getattr(obj, "__qualname__", "")
    return (getattr(obj, "__module__", None) == "__main__"
            or "<lambda>" in qual or "<locals>" in qual)


class _ByReferencePickler(pickle.Pickler):
    """A standard pickler that refuses what only pickles by value."""

    def reducer_override(self, obj):
        if _by_value_only(obj):
            raise pickle.PicklingError(
                f"{getattr(obj, '__module__', '?')}."
                f"{getattr(obj, '__qualname__', obj)} pickles by value only")
        return NotImplemented


def dumps(obj: Any) -> bytes:
    """Pickle ``obj`` for the wire: standard pickle, or ``cloudpickle``
    for what standard pickle ships only by value (the module
    docstring)."""
    buf = io.BytesIO()
    try:
        _ByReferencePickler(buf, pickle.HIGHEST_PROTOCOL).dump(obj)
        return buf.getvalue()
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        refused = e
    try:
        import cloudpickle
    except ImportError:
        raise pickle.PicklingError(
            f"cannot pickle the object for the wire ({refused}); "
            "cloudpickle is not installed, so lambdas, closures and "
            "functions of __main__ cannot be shipped: pass a module-level "
            "function of a module the workers can import") from refused
    return cloudpickle.dumps(obj)


class Wire:
    """Length-prefixed frames: [u64 len][HMAC-SHA256][payload]."""

    def __init__(self, key: bytes):
        self._key = key

    def write(self, sock: socket.socket, obj: Any) -> None:
        payload = dumps(obj)
        digest = hmac.new(self._key, payload, hashlib.sha256).digest()
        sock.sendall(struct.pack("<Q", len(payload)) + digest + payload)

    def read(self, sock: socket.socket,
             timeout: Optional[float] = None) -> Any:
        """Read one authenticated frame. ``timeout`` bounds the time
        without progress: a peer that stops mid-frame raises
        ``socket.timeout``, while a large frame that keeps arriving
        within the budget completes."""
        header = self._read_exact(sock, 8 + DIGEST_LEN, timeout)
        (length,) = struct.unpack("<Q", header[:8])
        if length > MAX_FRAME:
            raise IntegrityError("oversized frame")
        digest = header[8:]
        payload = self._read_exact(sock, length, timeout)
        expected = hmac.new(self._key, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(digest, expected):
            # Never unpickle unauthenticated bytes.
            raise IntegrityError("message integrity check failed")
        return pickle.loads(payload)

    @staticmethod
    def _read_exact(sock: socket.socket, n: int,
                    timeout: Optional[float] = None) -> bytes:
        """``timeout`` is a no-progress bound: the deadline re-arms on
        every received chunk, so only a stalled peer trips it."""
        buf = b""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while len(buf) < n:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise socket.timeout(
                        f"no progress for {timeout:g}s after "
                        f"{len(buf)}/{n} frame bytes")
                sock.settimeout(remaining)
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed connection")
            buf += chunk
            if deadline is not None:
                deadline = time.monotonic() + timeout
        return buf


class BasicService:
    """Threaded TCP request/response server: one authenticated request
    object in, one response object out, dispatched to ``handler``."""

    def __init__(self, name: str, key: bytes,
                 handler: Callable[[Any], Any]):
        self._name = name
        self._wire = Wire(key)
        self._handler = handler
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                try:
                    # Bounded: a half-open client that never finishes
                    # its frame must release this handler thread.
                    req = outer._wire.read(self.request, timeout=60.0)
                except (IntegrityError, ConnectionError, socket.timeout):
                    return  # drop unauthenticated or broken connections
                try:
                    resp = outer._handler(req)
                except Exception as e:  # surfaced to the client
                    resp = RemoteError(repr(e))
                try:
                    outer._wire.write(self.request, resp)
                except (ConnectionError, OSError):
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server(("0.0.0.0", 0), _Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"{name}-service")
        self._thread.start()

    @property
    def addr(self):
        host, port = self._server.server_address
        return host, port

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RemoteError:
    def __init__(self, message: str):
        self.message = message


class BasicClient:
    """One request/response round trip per call."""

    def __init__(self, addr, key: bytes, timeout: float = 60.0):
        self._addr = tuple(addr)
        self._wire = Wire(key)
        self._timeout = timeout

    def request(self, obj: Any) -> Any:
        with socket.create_connection(self._addr,
                                      timeout=self._timeout) as sock:
            self._wire.write(sock, obj)
            # The connection timeout bounds each recv(); the frame
            # timeout bounds the whole reply.
            resp = self._wire.read(sock, timeout=self._timeout)
        if isinstance(resp, RemoteError):
            raise RuntimeError(f"remote error: {resp.message}")
        return resp
