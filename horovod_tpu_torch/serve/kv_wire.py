"""KV-page transfer lane: the chunk stream's second consumer.

The port's copy of ``horovod_tpu.serve.kv_wire`` (stdlib-only, like the
framing itself). The disaggregated prefill/decode handoff
(``serve/disagg.py``) ships a finished request's K/V pages —
:meth:`PagedKVCache.export_pages
<horovod_tpu_torch.serve.kvcache.PagedKVCache.export_pages>`'s
deterministic ``HVKV`` blob — from a prefill replica to a decode replica
under the discipline the params push uses: a leading manifest
(whole-blob sha256, sizes), bounded chunks each carrying its offset and
its own crc32, contiguity-enforced assembly with resume-from-offset, and
a digest-verified commit (no partial import, ever). All of that lives in
:mod:`~horovod_tpu_torch.serve.chunk_stream` — ONE framing
implementation, two consumers; this module adds only the KV lane's
specifics:

* the stream kind ``"hvsf-kv"`` (a KV receiver fed a params manifest —
  or the reverse — fails typed at the manifest, not at import);
* the request id riding in the manifest (``extra``), so a receiver can
  never commit one request's pages under another's table;
* :class:`KvSender` / :class:`KvReceiver`, the two ends the worker RPC
  verbs (``kv_export_*`` / ``kv_import_*``) and the in-process fleet
  both drive — the in-process fleet runs the SAME chunk codec, so
  ``kv_bytes_shipped`` means the same thing on every transport.

Manifests and chunks are byte-identical to the reference's for the same
blob (tests/test_torch_serve_wire.py), so each package's receiver
commits the other's stream.

Unlike the params push lane, a KV transfer is NEVER retried across a
TransportError: the death of either side mid-transfer drains the
request through the router's bookkeeping (``rebase_for_recompute`` →
requeue, at-most-once) — recomputing a prefix is always correct, while
a retried half-transfer would need cross-replica transactional state
the fleet deliberately does not carry. Resume-from-offset exists IN the
protocol (``begin`` returns ``have_bytes``) and covers the benign case:
a re-begin of the same (rid, digest) payload after a torn chunk, on a
still-healthy pair.
"""

from __future__ import annotations

from typing import Dict

from horovod_tpu_torch.serve.chunk_stream import (
    DEFAULT_CHUNK_BYTES,
    BufferAssembler,
    make_chunk,
    make_manifest,
)
from horovod_tpu_torch.serve.transport import FrameError

#: Stream kind pinning the KV lane apart from ``"hvsf-params"``.
KV_KIND = "hvsf-kv"

#: KV transfer protocol version (the chunk framing's version-mix check
#: runs per transfer; KV payloads are transient, so unlike weights
#: there is no artifact versioning to thread through).
KV_WIRE_VERSION = 1


def make_kv_manifest(blob: bytes, *, rid: int,
                     chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Dict:
    """Manifest for one request's KV-page blob: shared framing fields
    plus the request id (the receiver pins chunks AND commit to it)."""
    return make_manifest(blob, kind=KV_KIND, version=KV_WIRE_VERSION,
                         chunk_bytes=chunk_bytes,
                         extra={"rid": int(rid)})


class KvSender:
    """Prefill-side half of one KV transfer: holds the exported blob
    (re-exportable bit-identically, so re-creating a sender after a
    torn transfer resumes the same payload) and frames chunks on
    demand. Pure host state — dropping a sender aborts nothing on the
    wire."""

    def __init__(self, blob: bytes, rid: int,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self.blob = blob
        self.rid = int(rid)
        self.manifest = make_kv_manifest(blob, rid=rid,
                                         chunk_bytes=chunk_bytes)

    @property
    def num_chunks(self) -> int:
        return int(self.manifest["num_chunks"])

    @property
    def total_bytes(self) -> int:
        return int(self.manifest["total_bytes"])

    def chunk(self, index: int) -> Dict:
        return make_chunk(self.blob, self.manifest, index)


class KvReceiver:
    """Decode-side half: a :class:`~horovod_tpu_torch.serve.chunk_stream.
    BufferAssembler` pinned to one request id. ``begin`` returns the
    resume offset; ``commit`` digest-verifies and hands the blob out
    exactly once — the caller imports it under the engine lock and only
    then acks, so a commit the prefill side never hears about leaves
    the pages parked there (at-most-once comes from the router's
    ownership move, not from this class)."""

    def __init__(self, rid: int):
        self.rid = int(rid)
        self._asm = BufferAssembler(kind=KV_KIND)

    @property
    def have_bytes(self) -> int:
        return self._asm.have_bytes

    def begin(self, manifest: Dict) -> int:
        if int(manifest.get("rid", -1)) != self.rid:
            raise FrameError(
                f"kv manifest is for rid {manifest.get('rid')!r}, this "
                f"receiver is armed for rid {self.rid} — one request's "
                "pages must never land under another's table")
        return self._asm.begin(manifest)

    def write_chunk(self, chunk: Dict) -> int:
        return self._asm.write_chunk(chunk)

    def commit(self) -> bytes:
        blob, _sha = self._asm.commit()
        return blob

    def abort(self) -> None:
        self._asm.abort()


__all__ = ["KV_KIND", "KV_WIRE_VERSION", "KvReceiver", "KvSender",
           "make_kv_manifest"]
