"""Session-wide test set-up that must run once, before any test worker.

`native/libeff_cpu.so` is built, not committed (`.gitignore`), and
`tests/test_native.py` builds it with `make -C native` while it is imported
when it finds it missing.  Under pytest-xdist every worker imports every test
module, so on a clean tree each worker ran its own `make` at the same time;
while one relinked the library another found it missing or half written and
skipped all of that module's tests.  Building it here, in the controlling
process before the workers start, leaves each worker an up-to-date library
that its own `make` does not touch.
"""
import subprocess
from pathlib import Path


def pytest_configure(config):
    if hasattr(config, "workerinput"):   # an xdist worker
        return
    # Without make or a compiler every worker skips the native tests alike.
    try:
        subprocess.run(["make", "-C", str(Path(__file__).parent / "native")],
                       capture_output=True, check=False)
    except OSError:
        pass
