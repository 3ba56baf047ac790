"""Build the port's native host engine: ``br_native.cpp`` -> a shared
library with a plain C ABI, loaded with ``ctypes``.

    python -m br_tpu_torch.native.build

At first use ``g++ -O3 -march=native -std=c++17 -shared -fPIC`` compiles
the source into ``<repo>/build/native`` (git-ignored), never into the
package.  The library is named by a hash of the source, the flags and the
CPU that ``-march=native`` resolves to, so an edited source or another
host's CPU gets its own build.  It is written under a temporary name and
moved into place with ``os.replace``, so processes that build at once
(test workers) never load a half-written file.  A missing ``g++`` or a
failed build raises with the compiler's log; nothing falls back.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "br_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def compiler() -> str:
    """The path of ``g++``; raises when there is none."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native host engine "
                           "(br_tpu_torch/native/br_native.cpp) is built "
                           "with g++ at first use")
    return found


@functools.lru_cache(maxsize=None)
def _target(cxx: str) -> str:
    """What ``-march=native`` means on this host (g++'s own report)."""
    r = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                       capture_output=True, text=True)
    return " ".join(ln.split()[-1] for ln in r.stdout.splitlines()
                    if ln.strip().startswith(("-march=", "-mtune=")))


def lib_path(cxx: str) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_target(cxx).encode())
    return BUILD_DIR / f"br_native_{h.hexdigest()[:12]}.so"


def build() -> str:
    """The library's path, compiled first unless it is already there."""
    cxx = compiler()
    out = lib_path(cxx)
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return str(out)


if __name__ == "__main__":
    print(build())
