"""Framework-neutral helpers of the port: lifecycle, configuration and the
error taxonomy, with the names ``horovod_tpu.common`` offers, each
imported from its submodule on first use (PEP 562; ``basics`` loads
torch, ``config`` and ``exceptions`` do not)."""

from horovod_tpu_torch._lazy import lazy_getattr

#: Public name -> the submodule that defines it.
_EXPORTS = {
    "AbortedError": "exceptions",
    "Config": "config",
    "HorovodError": "exceptions",
    "HorovodInternalError": "exceptions",
    "InvalidArgumentError": "exceptions",
    "NotInitializedError": "exceptions",
    "PreconditionError": "exceptions",
    "init": "basics",
    "is_initialized": "basics",
    "local_rank": "basics",
    "local_size": "basics",
    "rank": "basics",
    "shutdown": "basics",
    "size": "basics",
}

__all__ = sorted(_EXPORTS)


__getattr__ = lazy_getattr(__name__, _EXPORTS)
