"""Synthetic benchmark for any zoo model (reference
examples/pytorch_synthetic_benchmark.py, same protocol), the port of
``examples/jax_synthetic_benchmark.py``.

A thin front end over :mod:`horovod_tpu_torch.bench`, its supervisor
included (one JSON line in every outcome). As in the JAX example, whose
harness defaults to ResNet-50, the model is ``resnet50`` unless
``--model`` is given:

    python -m horovod_tpu_torch.examples.synthetic_benchmark --model vgg16
    python -m horovod_tpu_torch.examples.synthetic_benchmark \\
        --model inception_v3 --image-size 299
"""

import sys

from horovod_tpu_torch import bench


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a == "--model" or a.startswith("--model=") for a in argv):
        argv = ["--model", "resnet50", *argv]
    return bench.cli(argv)


if __name__ == "__main__":
    sys.exit(main())
