"""The C++ oracle, built once per checkout for the port's oracle tests.

tests/conftest.py's `oracle_bin` fixture builds oracle/build/oracle in
every pytest process that finds it missing or stale, with `g++ -o` onto
the path itself. Under xdist several workers do that at once, and while
one link writes the file it has no execute bits: another worker that
runs the oracle in that window fails with Permission denied.

Importing this module builds the binary first, under an exclusive lock,
into a temporary name that is then renamed onto the path, so whoever
runs the path sees the whole old binary or the whole new one. Every
xdist worker collects every test file before it runs a test, so the
binary is whole and fresh before the first test starts, and the fixture
then finds it fresh and builds nothing itself.

`python tests/torch_oracle.py TARGET` builds TARGET the same way, with
no lock (tests/test_torch_oracle.py races two such builds).
"""

import fcntl
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ORACLE = REPO / "oracle"
# conftest's flags: the oracle is the ground truth, so it is built with
# ASan and UBSan and no recovery
GXX = ["g++", "-std=c++17", "-O2", "-Wall",
       "-fsanitize=address,undefined", "-fno-sanitize-recover=all"]


def sources() -> list[Path]:
    return sorted(ORACLE.glob("*.cc")) + sorted(ORACLE.glob("*.h"))


def fresh(target: Path) -> bool:
    """Whether target exists and is newer than every oracle source (the
    fixture's test)."""
    return target.exists() and all(target.stat().st_mtime > f.stat().st_mtime
                                   for f in sources())


def build(target: Path) -> None:
    """Compiles the oracle into a temporary name beside target, then
    renames it onto target."""
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent, prefix=f".{target.name}.") as tmp:
        exe = os.path.join(tmp, target.name)
        subprocess.run([*GXX, "-o", exe, str(ORACLE / "main.cc")], check=True)
        os.replace(exe, target)


def ensure_oracle() -> Path:
    """Builds conftest.ORACLE_BIN unless it is fresh, holding an exclusive
    lock beside it, so that one process builds while the others wait and
    then find it fresh."""
    from conftest import ORACLE_BIN

    ORACLE_BIN.parent.mkdir(parents=True, exist_ok=True)
    with open(ORACLE_BIN.parent / ".oracle.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not fresh(ORACLE_BIN):
            build(ORACLE_BIN)
    return ORACLE_BIN


if __name__ == "__main__":
    build(Path(sys.argv[1]))
else:
    ensure_oracle()
