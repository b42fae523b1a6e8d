"""``tools.hvdlint`` over the port: ``horovod_tpu_torch/`` and
``chip_smoke.py`` carry no unsuppressed finding, and every suppression
in them says why (``# hvdlint: disable=HVDxxx (reason)``). The port
itself imports nothing of ``tools``; this test does."""

import re
from pathlib import Path

from tools.hvdlint import lint_paths

REPO = Path(__file__).resolve().parent.parent
PORT = [REPO / "horovod_tpu_torch", REPO / "chip_smoke.py"]


def test_the_port_sweep_is_clean():
    findings = lint_paths([str(p) for p in PORT])
    active = [f for f in findings if not f.suppressed]
    assert not active, "\n".join(f.format() for f in active)
    assert len(findings) >= 11         # the suppressed ones still report


def test_every_suppression_gives_its_reason():
    pat = re.compile(r"#\s*hvdlint:\s*disable(-file)?=([A-Za-z0-9_, ]+)"
                     r"(.*)$")
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bare = []
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            m = pat.search(line)
            if m and not re.match(r"\s*\(.+\)", m.group(3)):
                bare.append(f"{f.relative_to(REPO)}:{n}")
    assert not bare, bare
