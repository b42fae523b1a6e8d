"""Shared chunk-stream framing: ONE framing/CRC/resume implementation.

The port's copy of ``horovod_tpu.serve.chunk_stream``. The chunked
transfer discipline — manifest first (whole-artifact sha256, sizes),
then bounded chunks each carrying its offset and its OWN crc32,
assembled contiguously so resume-from-offset after a torn transfer is
exact by construction, and nothing is ever loadable until the
whole-artifact digest verifies — lives HERE, so the params consumer
(:mod:`~horovod_tpu_torch.serve.params_wire`, assembling to a crash-safe
temp file) and the KV handoff (:mod:`~horovod_tpu_torch.serve.kv_wire`,
assembling to memory) share one spelling of every boundary case:

* :func:`make_manifest` leads every transfer: stream kind, payload
  version, the whole-blob sha256, total/chunk byte counts (plus any
  consumer ``extra`` fields, e.g. the params manifest's per-leaf
  specs);
* :func:`make_chunk` / :func:`check_chunk` frame each chunk with its
  offset and its own crc32 — a truncated, mis-ordered or version-mixed
  chunk is a typed :class:`~horovod_tpu_torch.serve.transport.FrameError`, a
  bit flip a typed :class:`~horovod_tpu_torch.serve.transport.ChecksumError`
  (caught per chunk, so a sender retries one chunk, not the artifact);
* :class:`BufferAssembler` is the in-memory receiver half (contiguity
  enforced, digest-verified commit) for transient payloads that never
  touch a filesystem; the file-backed, crash-safe variant is
  :class:`params_wire.ArtifactAssembler
  <horovod_tpu_torch.serve.params_wire.ArtifactAssembler>`, built on the
  same check functions.

The wire contract (pinned against the reference in
tests/test_torch_serve_wire.py): manifests and chunks are BYTE-IDENTICAL
to the reference's — key order included, since manifests travel inside
JSON frames whose bytes the weight-roll records digest.

Stdlib-only, like the frame codec itself: the protocol-stub test
worker (``python -S``) runs the identical assembly/verify path.
"""

from __future__ import annotations

import base64
import hashlib
import zlib
from typing import Dict, Optional, Tuple

from horovod_tpu_torch.serve.transport import ChecksumError, FrameError

#: Default transfer chunk size. Base64 expansion (x4/3) must keep a
#: chunk frame well under transport.MAX_FRAME (16 MiB).
DEFAULT_CHUNK_BYTES = 1 << 20


def sha256_hex(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


# ------------------------------------------------------------- manifest


def make_manifest(blob: bytes, *, kind: str, version: int,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                  extra: Optional[Dict] = None) -> Dict:
    """The leading frame of every transfer: what the receiver must end
    up holding (kind, version, whole-blob sha256, sizes). ``extra``
    appends consumer fields AFTER the shared ones — key order is part
    of the wire contract (the params consumer's manifests must stay
    byte-identical to the reference's)."""
    if version < 1:
        raise ValueError(f"artifact version must be >= 1, got {version}")
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    total = len(blob)
    manifest = {
        "kind": kind,
        "version": int(version),
        "sha256": sha256_hex(blob),
        "total_bytes": total,
        "chunk_bytes": int(chunk_bytes),
        "num_chunks": max(1, -(-total // chunk_bytes)),
    }
    if extra:
        manifest.update(extra)
    return manifest


def check_manifest(manifest: Dict,
                   kind: Optional[str] = None) -> None:
    """Validate a received manifest's internal consistency (typed
    :class:`FrameError` on anything off). ``kind`` additionally pins
    the stream kind — a KV receiver fed a params manifest (or the
    reverse) must fail loudly at the manifest, not at import."""
    try:
        version = int(manifest["version"])
        sha = manifest["sha256"]
        total = int(manifest["total_bytes"])
        cb = int(manifest["chunk_bytes"])
        n = int(manifest["num_chunks"])
    except (KeyError, TypeError, ValueError) as e:
        raise FrameError(f"malformed transfer manifest: {e!r}") from None
    if version < 1 or total < 0 or cb < 1 \
            or n != max(1, -(-total // cb)) \
            or not (isinstance(sha, str) and len(sha) == 64):
        raise FrameError(f"inconsistent transfer manifest: {manifest!r}")
    if kind is not None and manifest.get("kind") != kind:
        raise FrameError(
            f"transfer manifest kind {manifest.get('kind')!r} is not "
            f"{kind!r} — wrong stream routed to this receiver")


def chunk_span(manifest: Dict, index: int) -> Tuple[int, int]:
    """``(offset, size)`` of chunk ``index`` under the manifest's
    geometry."""
    cb = int(manifest["chunk_bytes"])
    total = int(manifest["total_bytes"])
    offset = index * cb
    return offset, min(cb, total - offset)


# --------------------------------------------------------------- chunks


def make_chunk(blob: bytes, manifest: Dict, index: int) -> Dict:
    """One bounded transfer chunk: offset + size + per-chunk crc32 +
    base64 payload (the frame codec carries JSON)."""
    if not 0 <= index < int(manifest["num_chunks"]):
        raise FrameError(
            f"chunk index {index} outside 0..{manifest['num_chunks'] - 1}")
    offset, size = chunk_span(manifest, index)
    raw = blob[offset:offset + size]
    return {
        "version": int(manifest["version"]),
        "index": int(index),
        "offset": offset,
        "size": size,
        "crc32": zlib.crc32(raw),
        "data": base64.b64encode(raw).decode("ascii"),
    }


def check_chunk(manifest: Dict, chunk: Dict) -> Tuple[int, bytes]:
    """Validate one received chunk against the transfer's manifest;
    returns ``(offset, raw_bytes)``. Every way the chunk can be wrong
    is a TYPED error — a truncated payload, a mis-indexed or
    version-mixed chunk is :class:`FrameError`; payload bytes that do
    not match their own crc32 are :class:`ChecksumError` (the
    bit-corruption shape the whole-artifact digest would also catch,
    caught here per chunk so the sender retries one chunk, not the
    artifact)."""
    if not isinstance(chunk, dict):
        raise FrameError(f"chunk is not a mapping: {type(chunk).__name__}")
    try:
        version = int(chunk["version"])
        index = int(chunk["index"])
        offset = int(chunk["offset"])
        size = int(chunk["size"])
        crc = int(chunk["crc32"])
        data = chunk["data"]
    except (KeyError, TypeError, ValueError) as e:
        raise FrameError(f"malformed chunk: {e!r}") from None
    if version != int(manifest["version"]):
        raise FrameError(
            f"chunk carries version {version}, transfer manifest says "
            f"{manifest['version']} — version mix on the wire")
    if not 0 <= index < int(manifest["num_chunks"]):
        raise FrameError(
            f"chunk index {index} outside 0..{manifest['num_chunks'] - 1}")
    want_offset, want_size = chunk_span(manifest, index)
    if offset != want_offset or size != want_size:
        raise FrameError(
            f"chunk {index} claims offset/size {offset}/{size}, manifest "
            f"geometry says {want_offset}/{want_size}")
    try:
        raw = base64.b64decode(data, validate=True)
    except Exception as e:
        raise FrameError(f"chunk {index}: undecodable payload: {e}"
                         ) from None
    if len(raw) != size:
        raise FrameError(
            f"chunk {index}: payload is {len(raw)} bytes, header says "
            f"{size} — truncated or padded chunk")
    if zlib.crc32(raw) != crc:
        raise ChecksumError(
            f"chunk {index}: crc32 mismatch on {size} payload bytes — "
            "corrupted in flight or at the source")
    return offset, raw


# ------------------------------------------------------------ assembler


class BufferAssembler:
    """In-memory assemble + digest-verify: the receiver half for
    transient payloads (the KV handoff) that must never touch a
    filesystem. Same protocol as the file-backed
    :class:`~horovod_tpu_torch.serve.params_wire.ArtifactAssembler` —
    :meth:`begin` arms one transfer and returns the verified resume
    offset, :meth:`write_chunk` enforces contiguity (the resume
    contract is a single verified prefix), :meth:`commit` verifies the
    whole-blob sha256 and only then hands the bytes out (a torn or
    corrupted transfer can never be imported, partially or otherwise).

    A re-``begin`` with the SAME (version, sha256) manifest keeps the
    assembled prefix — resume-from-offset after a torn transfer; any
    other manifest drops it (a new payload starts clean)."""

    def __init__(self, kind: Optional[str] = None):
        self.kind = kind
        self.manifest: Optional[Dict] = None
        self._buf = bytearray()

    @property
    def have_bytes(self) -> int:
        return len(self._buf)

    def begin(self, manifest: Dict) -> int:
        """Arm the assembler for one transfer; returns ``have_bytes``
        — the verified prefix of THIS (version, sha256) payload
        already assembled, floored to a whole chunk, so the sender
        resumes from there instead of resending the blob."""
        check_manifest(manifest, kind=self.kind)
        prev = self.manifest
        if prev is None or prev["sha256"] != manifest["sha256"] \
                or int(prev["version"]) != int(manifest["version"]):
            self._buf = bytearray()
        self.manifest = dict(manifest)
        cb = int(manifest["chunk_bytes"])
        have = min((len(self._buf) // cb) * cb,
                   int(manifest["total_bytes"]))
        # A partial trailing chunk (a tear mid-write) is never trusted:
        # truncate back to the last whole-chunk boundary.
        del self._buf[have:]
        return have

    def write_chunk(self, chunk: Dict) -> int:
        """Validate + append one chunk; returns the new ``have_bytes``.
        Chunks must arrive contiguously (``offset == have``)."""
        if self.manifest is None:
            raise FrameError("write_chunk before begin()")
        offset, raw = check_chunk(self.manifest, chunk)
        if offset != len(self._buf):
            raise FrameError(
                f"non-contiguous chunk: offset {offset} but only "
                f"{len(self._buf)} bytes assembled — resume must "
                "continue the verified prefix")
        self._buf.extend(raw)
        return len(self._buf)

    def commit(self) -> Tuple[bytes, str]:
        """Digest-verify the assembled blob and return
        ``(blob, sha256)``. An incomplete assembly is
        :class:`FrameError`; a digest mismatch DROPS the buffer and
        raises :class:`ChecksumError` — there is no partial import, and
        the next attempt starts clean."""
        if self.manifest is None:
            raise FrameError("commit before begin()")
        m = self.manifest
        if len(self._buf) != int(m["total_bytes"]):
            raise FrameError(
                f"commit of an incomplete transfer: {len(self._buf)}/"
                f"{m['total_bytes']} bytes assembled")
        blob = bytes(self._buf)
        sha = sha256_hex(blob)
        if sha != m["sha256"]:
            self._buf = bytearray()
            raise ChecksumError(
                f"whole-blob digest mismatch: assembled {sha}, "
                f"manifest says {m['sha256']} — refusing the torn/"
                "corrupted transfer (no partial import)")
        return blob, sha

    def abort(self) -> None:
        """Drop the in-progress buffer (a transfer abandoned by the
        sender; a plain retry re-``begin``\\ s and keeps the prefix)."""
        self._buf = bytearray()
        self.manifest = None


__all__ = [
    "BufferAssembler", "DEFAULT_CHUNK_BYTES", "check_chunk",
    "check_manifest", "chunk_span", "make_chunk", "make_manifest",
    "sha256_hex",
]
