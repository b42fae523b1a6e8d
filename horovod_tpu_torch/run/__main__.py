"""CLI: ``python -m horovod_tpu_torch.run -np N [-H hosts] cmd args...``,
the same as the ``hvdrun-torch`` console script
(:mod:`horovod_tpu_torch.run.launcher`)."""

import sys

from horovod_tpu_torch.run.launcher import main

if __name__ == "__main__":
    sys.exit(main())
