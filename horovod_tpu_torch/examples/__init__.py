"""The JAX package's examples on the port, one module each, run as
``python -m horovod_tpu_torch.examples.<name>`` (on the card by default,
``--device cpu`` for the CPU; the multi-rank ones under ``hvdrun-torch``
or ``python -m horovod_tpu_torch.run -np N``):

* :mod:`.mnist` — ``examples/jax_mnist.py``: MNISTNet, data-parallel;
* :mod:`.synthetic_benchmark` — ``examples/jax_synthetic_benchmark.py``:
  a front end over :mod:`horovod_tpu_torch.bench`;
* :mod:`.imagenet_resnet50` — ``examples/flax_imagenet_resnet50.py``:
  the callback stack, checkpoints and resume;
* :mod:`.transformer_zero` — ``examples/jax_transformer_zero.py``:
  ZeRO-1 with checkpoint and resume;
* :mod:`.word2vec` — ``examples/jax_word2vec.py``: sparse gradients;
* :mod:`.long_context_ring_attention` —
  ``examples/long_context_ring_attention.py``: sequence parallelism;
* :mod:`.gpt_parallel` — ``examples/jax_gpt_parallel.py``: the composed
  dp x sp x tp LM.

Each keeps its original's flags, ``--smoke`` sizes, synthetic data (the
same numpy generators) and assertions.
"""

import os


def init(device: str) -> None:
    """``hvd.init`` on ``device`` for an example. On the card each rank
    takes a card of its own (NCCL); where a launcher starts more ranks
    than the host has cards, they share card 0 over a gloo group (NCCL
    takes one rank a card), whose collectives stage through the host.
    Without a card ``device="cuda"`` raises, as every entry point of the
    port does."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch.distributed as hvd

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if (device == "cuda" and torch.cuda.is_available()
            and world > torch.cuda.device_count()
            and not dist.is_initialized()):
        dist.init_process_group("gloo", init_method="env://")
        hvd.init(device="cuda:0")
        return
    hvd.init(device=device)
