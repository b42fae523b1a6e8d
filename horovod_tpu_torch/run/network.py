"""Network helpers of the launcher that the serving fleet uses.

The port of :func:`make_secret_key` and :func:`advertise_ip` from
``horovod_tpu.run.network``: the fleet's TCP transport takes a fresh
shared secret per fleet instance, and a TCP worker bound to a wildcard
prints the address peers should dial. The authenticated pickle RPC
(``BasicService``/``BasicClient``) comes with the launcher, ROADMAP.md
Queue 1 item 5.
"""

from __future__ import annotations

import secrets as _secrets
import socket


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
