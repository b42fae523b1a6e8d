"""Error taxonomy of the port: the exception classes of
``horovod_tpu.common.exceptions``, with their names and bases, so callers
catch the same classes in both packages. :class:`NotInitializedError`
is also a :class:`PreconditionError`, the class the port raised before
it had one of its own."""


class HorovodError(Exception):
    """Base class for all framework errors (UNKNOWN_ERROR)."""


class HorovodInternalError(HorovodError):
    """Unexpected internal failure."""


class PreconditionError(HorovodError):
    """PRECONDITION_ERROR: an operation submitted in an invalid state."""


class NotInitializedError(PreconditionError):
    """An API that needs ``hvd.init()`` was called before it."""


class AbortedError(HorovodError):
    """ABORTED: a collective cancelled by a coordinated shutdown."""


class InvalidArgumentError(HorovodError, ValueError):
    """INVALID_ARGUMENT: an argument the operation cannot take."""
