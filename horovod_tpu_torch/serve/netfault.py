"""Deterministic network fault injection at the fleet-transport seam.

The port's copy of ``horovod_tpu.serve.netfault`` (stdlib-only).

A multi-host fleet's new failure modes are NETWORK failures — a NIC
partition, a link so degraded every frame trickles, a reply delayed
past its deadline, a frame torn mid-write when a host drops — and a
recovery path only exercised by real outages is an untested one. This
module makes every one of them injectable on loopback TCP, CI-fast and
bit-deterministic: :class:`FaultableSocket` wraps a real connected
socket (plugged in through ``RpcClient(sock_wrap=...)`` on the router
side, or wrapped around an accepted connection on the worker side) and
misbehaves according to a shared :class:`NetFaults` state, one per
HOST — which is exactly what makes a *host* a failure domain: every
connection to the host degrades together, the way a real NIC loss
takes out all of them at once.

Fault modes (all composable, all resolving as the typed
:class:`~horovod_tpu_torch.serve.transport.TransportError` taxonomy, never a
hang):

* **partition** (``NetFaults.partition(secs)``): the link goes dark —
  reads see silence (``socket.timeout`` per poll slice, so the
  transport's deadline discipline fires :class:`DeadlineExceeded
  <horovod_tpu_torch.serve.transport.DeadlineExceeded>` if the window
  outlasts the budget) and writes are black-holed. When the window
  ends, every connection that predates the partition raises
  ``ConnectionResetError`` on its next operation — the **half-open
  connection after a host returns**: the peer's TCP state is gone, and
  the transport maps the reset to :class:`ConnectionLost
  <horovod_tpu_torch.serve.transport.ConnectionLost>`. Connections opened
  AFTER the window (a relaunch) are clean. ``secs=None`` partitions
  forever (the host never comes back; detection is then purely the
  deadline's).
* **delay** (``delay_s``): every read waits ``delay_s`` first — a
  congested link; a delay past the caller's recv budget resolves as
  that budget's ``socket.timeout`` (→ ``DeadlineExceeded`` upstream).
* **trickle** (``trickle_bytes``): reads return at most N bytes per
  call — a degraded link. A frame that keeps trickling *within* its
  deadline still completes (the transport's contract); one that cannot
  hits the deadline.
* **tear** (``tear_send_frame``): the Nth ``sendall`` through the
  socket writes only half its bytes, then the connection dies — the
  kill-mid-write shape, injected mid-FRAME so the peer's codec must
  resolve it as a torn :class:`FrameError
  <horovod_tpu_torch.serve.transport.FrameError>`. ONE-SHOT: firing clears
  the armed fault, so a retry's fresh connection (the params-push
  resume lane) proceeds clean instead of tearing forever.

The wrapper intercepts only the calls the transport makes (``recv``,
``sendall``, ``settimeout``, ``close``); everything else delegates.
Timing note: fault windows run on ``time.monotonic`` (the same clock
the transport's deadlines use), independent of the fleet's injectable
test clock — a partition is wall-clock physics, like heartbeat file
mtimes.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional


class NetFaults:
    """Shared, mutable fault state for every connection to one host.

    The serving fault grammar's ``partition:host=H,at=T[,secs=S]``
    resolves to ``fleet._hosts[H].faults.partition(S)``; tests drive
    the other knobs directly. Thread-safe: the worker's RPC thread and
    the router poke sockets concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        #: bumped on every partition; sockets born before the current
        #: epoch raise ConnectionResetError once the window ends (the
        #: half-open-after-return shape).
        self.epoch = 0
        self.partition_until = 0.0
        self.delay_s = 0.0
        self.trickle_bytes = 0
        #: 1-based index of the sendall call to tear on (None = off).
        self.tear_send_frame: Optional[int] = None

    def partition(self, secs: Optional[float] = None) -> None:
        """Open a partition window now: ``secs`` seconds (None =
        forever — the host never returns)."""
        with self._lock:
            self.epoch += 1
            self.partition_until = (float("inf") if secs is None
                                    else time.monotonic() + float(secs))

    def partitioned(self) -> bool:
        return time.monotonic() < self.partition_until

    def wrap(self, sock: socket.socket) -> "FaultableSocket":
        """The ``RpcClient(sock_wrap=...)`` / worker-accept hook."""
        return FaultableSocket(sock, self)


class FaultableSocket:
    """A connected socket that misbehaves per its :class:`NetFaults`.

    Drop-in at the transport seam: implements the exact surface
    ``serve/transport.py`` touches and delegates the rest."""

    def __init__(self, sock: socket.socket, faults: NetFaults):
        self._sock = sock
        self._faults = faults
        self._born_epoch = faults.epoch
        self._timeout = sock.gettimeout()
        self._sends = 0

    # ------------------------------------------------ fault gates

    def _poll_budget(self) -> float:
        t = self._timeout
        return 0.25 if t is None else min(float(t), 0.25)

    def _gate(self) -> None:
        """Raise the active fault's failure shape, if any (shared by
        reads and writes for the partition/half-open modes)."""
        f = self._faults
        if f.partitioned():
            raise _Partitioned()
        if f.epoch > self._born_epoch:
            raise ConnectionResetError(
                "half-open connection: the peer host was partitioned "
                "and has returned — this connection's state is gone")

    # ------------------------------------------------ intercepted API

    def settimeout(self, t) -> None:
        self._timeout = t
        self._sock.settimeout(t)

    def gettimeout(self):
        return self._timeout

    def recv(self, n: int, *flags) -> bytes:
        f = self._faults
        try:
            self._gate()
        except _Partitioned:
            # Silence on the wire: wait out one poll slice and time
            # out, exactly like a link that stopped delivering.
            time.sleep(self._poll_budget())
            raise socket.timeout("partitioned") from None
        if f.delay_s:
            t = self._timeout
            if t is not None and f.delay_s >= float(t):
                time.sleep(float(t))
                raise socket.timeout("delayed past the recv budget")
            time.sleep(f.delay_s)
        if f.trickle_bytes:
            n = min(n, f.trickle_bytes)
        return self._sock.recv(n, *flags)

    def sendall(self, data: bytes) -> None:
        f = self._faults
        try:
            self._gate()
        except _Partitioned:
            return   # black hole: the kernel "accepted" it, the wire ate it
        if f.tear_send_frame is not None:
            self._sends += 1
            fire = False
            with f._lock:
                if f.tear_send_frame is not None \
                        and self._sends >= f.tear_send_frame:
                    # One-shot: the armed tear is consumed by the
                    # socket that fires it (a resumed transfer's fresh
                    # connection must not re-tear).
                    f.tear_send_frame = None
                    fire = True
            if fire:
                self._sock.sendall(data[:max(1, len(data) // 2)])
                try:
                    self._sock.close()
                except OSError:
                    pass
                raise ConnectionResetError(
                    "torn mid-frame by fault injection (writer died "
                    "half-way through the frame)")
        self._sock.sendall(data)

    def close(self) -> None:
        self._sock.close()

    def __getattr__(self, name):
        return getattr(self._sock, name)


class _Partitioned(Exception):
    """Internal control flow for the partition gate."""


__all__ = ["FaultableSocket", "NetFaults"]
