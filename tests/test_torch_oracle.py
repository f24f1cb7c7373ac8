"""The port's oracle build (tests/torch_oracle.py): two builds racing onto
one path while a loop runs it, against the plain `g++ -o` onto the path
that tests/conftest.py's fixture makes. No JAX, no tpq."""

import subprocess
import sys
import time
from pathlib import Path

import torch_oracle


def _run_while(builds, exe: Path, out: Path) -> list:
    """Runs exe (a tiny datagen) whenever it exists, until once after
    every build has exited; returns each run's outcome, 0 for a clean
    one."""
    argv = [str(exe), "datagen", "--rows=4", "--nkeys=4", "--payloads=1", "--seed=1",
            "--kind=uniform", f"--out={out}"]
    runs, done = [], False
    while not done:
        done = all(b.poll() is not None for b in builds)
        if not exe.exists():
            time.sleep(0.001)
            continue
        try:
            runs.append(subprocess.run(argv, capture_output=True).returncode)
        except OSError as e:  # Permission denied, Exec format error, or gone
            runs.append(e.strerror)
    assert all(b.returncode == 0 for b in builds)
    return runs


def test_oracle_build_is_atomic(tmp_path):
    """Two of torch_oracle's builds onto one path at once, with a loop
    running the path: once the file appears, every run succeeds. The
    same loop against one plain `g++ -o` onto a new path sees the file
    before the link has finished writing it, and some run fails."""
    exe = tmp_path / "atomic" / "oracle"
    builds = [subprocess.Popen([sys.executable, torch_oracle.__file__, str(exe)])
              for _ in range(2)]
    runs = _run_while(builds, exe, tmp_path / "a.tpqc")
    assert runs and all(r == 0 for r in runs), runs
    assert not [p for p in exe.parent.iterdir() if p.name != "oracle"]  # no temp left

    plain = tmp_path / "plain" / "oracle"
    plain.parent.mkdir()
    gxx = subprocess.Popen([*torch_oracle.GXX, "-o", str(plain),
                            str(torch_oracle.ORACLE / "main.cc")])
    runs = _run_while([gxx], plain, tmp_path / "p.tpqc")
    assert any(r != 0 for r in runs), runs
