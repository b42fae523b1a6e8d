"""Error taxonomy of the port: the exception classes that the serving
modules raise, with the names and bases of ``horovod_tpu.common.
exceptions`` so callers catch the same classes in both packages."""


class HorovodError(Exception):
    """Base class for all framework errors (UNKNOWN_ERROR)."""


class HorovodInternalError(HorovodError):
    """Unexpected internal failure."""


class PreconditionError(HorovodError):
    """PRECONDITION_ERROR: an operation submitted in an invalid state."""


class InvalidArgumentError(HorovodError, ValueError):
    """INVALID_ARGUMENT: an argument the operation cannot take."""
