"""Build the host C++ libraries of this package (native/*.cpp) with g++.

Each binding asks for its library by source name; the library is compiled at
first use into _build/ beside the package's CUDA libraries (listed in
.gitignore), through a temporary file renamed into place, so that concurrent
first imports never load a half-written library. It is rebuilt when its source
is newer.
"""

from __future__ import annotations

import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")


def build(name: str, pthread: bool = False) -> str:
    """Path of lib<name>.so, compiled from native/<name>.cpp if missing or
    stale. Raises if g++ is absent or fails."""
    src = os.path.join(_HERE, f"{name}.cpp")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]
        if pthread:
            cmd.append("-pthread")
        subprocess.run(cmd + [src, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib
