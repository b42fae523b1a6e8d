"""The public names of each pair of packages: ``horovod_tpu`` and
``horovod_tpu_torch`` at the top level and in ``.serve``, ``.models``,
``.ops``, ``.common``, ``.run`` and ``.elastic``, and ``horovod_tpu.flax``
beside its port, ``horovod_tpu_torch.training``.

Every name the JAX package offers is offered by the port, except those
listed in ``ABSENT`` with the ROADMAP.md Queue 1 item that brings them;
every name only the port offers is listed in ``PORT_ONLY`` with why.
Each offered name resolves. The names load lazily: importing the port's
package or its ``serve`` loads no torch (the serving worker binds its
socket first).
"""

import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

#: subpackage of the JAX package -> the port's, where the names differ.
PORT_NAME = {".flax": ".training"}

#: subpackage -> {name the JAX package offers and the port does not yet:
#: the queue item that brings it}.
ABSENT = {
    "": {},
    ".serve": {},
    ".models": {},
    ".ops": {},
    ".common": {},
    ".run": {},
    ".elastic": {},
    ".flax": {},
}

_FUSION = "horovod_tpu.jax.fusion's, offered with the Horovod surface"

#: subpackage -> {name only the port offers: why}.
PORT_ONLY = {
    "": {
        "resolve_device": "the port's device rule (None is the card)",
        "fused_reduce": _FUSION, "plan_buckets": _FUSION,
        "plan_summary": _FUSION, "resolve_hierarchical": _FUSION,
        "hier_bucket_layout": _FUSION, "hier_wire_summary": _FUSION,
        "ef_residual_specs": _FUSION,
        "is_dcn_wire": "horovod_tpu.jax.compression's",
        "shard_info": "horovod_tpu.jax.zero's",
        "ef_state_partition_specs": "horovod_tpu.jax.optimizer's",
    },
    ".serve": {}, ".models": {}, ".ops": {}, ".common": {}, ".run": {},
    ".elastic": {}, ".flax": {},
}


def _public(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in dir(module) if not n.startswith("_")
                 and not isinstance(getattr(module, n), types.ModuleType)]
    return set(names)


@pytest.mark.parametrize("sub", sorted(ABSENT))
def test_public_names_match_the_reference(sub):
    ref = _public(importlib.import_module("horovod_tpu" + sub))
    port_mod = importlib.import_module("horovod_tpu_torch"
                                       + PORT_NAME.get(sub, sub))
    port = _public(port_mod)
    assert ref - port == set(ABSENT[sub])
    assert not set(ABSENT[sub]) & port
    assert port - ref == set(PORT_ONLY[sub])
    for name in sorted(port):
        assert getattr(port_mod, name) is not None, name


def test_top_level_is_the_distributed_surface():
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.distributed as dhvd

    assert list(hvd.__all__) == ["__version__", "resolve_device",
                                 *dhvd.__all__]
    for name in dhvd.__all__:
        assert getattr(hvd, name) is getattr(dhvd, name), name
    assert hvd.window is dhvd.window and hvd.zero is dhvd.zero
    import horovod_tpu

    assert hvd.__version__ == horovod_tpu.__version__
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        hvd.nope


def test_lazy_names_resolve_to_their_definitions():
    from horovod_tpu_torch import common, models, ops, serve
    from horovod_tpu_torch.common import basics, exceptions
    from horovod_tpu_torch.models import parallel_lm, transformer
    from horovod_tpu_torch.ops import attention
    from horovod_tpu_torch.serve import netfault, transport

    assert common.init is basics.init
    assert common.NotInitializedError is exceptions.NotInitializedError
    assert issubclass(exceptions.NotInitializedError,
                      exceptions.PreconditionError)
    assert models.parallel_lm is parallel_lm
    assert models.TransformerLM is transformer.TransformerLM
    assert ops.flash_attention is attention.flash_attention
    assert serve.ChecksumError is transport.ChecksumError
    assert issubclass(serve.ChecksumError, serve.FrameError)
    assert serve.NetFaults is netfault.NetFaults
    for mod in (common, models, ops, serve):
        with pytest.raises(AttributeError):
            getattr(mod, "nope")


def test_importing_the_package_and_serve_loads_no_torch():
    code = ("import sys\n"
            "import horovod_tpu_torch as hvd, horovod_tpu_torch.serve as s\n"
            "from horovod_tpu_torch import serve, run, common\n"
            "from horovod_tpu_torch.serve import worker, transport\n"
            "assert s.TransportError and common.Config and hvd.__all__\n"
            "import horovod_tpu_torch.run.task_exec\n"
            "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["False"]
