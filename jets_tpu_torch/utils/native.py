"""Build-and-load scaffolding for the port's native (C++) runtime pieces
(counterpart of ``jets_tpu/utils/native.py``).

One implementation of the compile-cache-ctypes dance used by every native
component (CRC32C hashing, the snapshot codec, the async shot loader):
compile the source with ``g++`` into ``jets_tpu_torch/_build/`` under a name
keyed by a hash of the source and the flags (so an edited source or flag
rebuilds, and the JAX package's cache is never shared), retry without the
optional ISA flags where the host refuses them, load with ctypes. A unique
temp name per build and an atomic :func:`os.replace` keep concurrent
builds (``pytest -n`` workers) from loading half a file.

Returns ``None`` when no toolchain is available — callers fall back to
their pure-Python/numpy paths, which give the same values.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import uuid
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["build_and_load"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def build_and_load(
    src_path: str,
    lib_name: str,
    *,
    extra_flags: Sequence[str] = (),
    optional_flags: Sequence[str] = (),
    timeout: int = 180,
) -> Optional[ctypes.CDLL]:
    """Compile ``src_path`` to ``_build/<lib_name>_<hash>.so`` (unless it is
    there) and load it. ``optional_flags`` (e.g. ``-msse4.2``) are dropped
    and the compile retried if the first attempt fails."""
    h = hashlib.sha256(Path(src_path).read_bytes())
    h.update(" ".join((*extra_flags, "|", *optional_flags)).encode())
    so_path = BUILD_DIR / f"{lib_name}_{h.hexdigest()[:16]}.so"
    if not so_path.is_file():
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        except OSError:
            return None
        tmp = f"{so_path}.{uuid.uuid4().hex[:8]}.tmp"
        base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp, str(src_path)]
        try:
            try:
                subprocess.run(base + list(extra_flags) + list(optional_flags),
                               check=True, capture_output=True, timeout=timeout)
            except (OSError, subprocess.SubprocessError):
                if not optional_flags:
                    return None
                subprocess.run(base + list(extra_flags),
                               check=True, capture_output=True, timeout=timeout)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    try:
        return ctypes.CDLL(str(so_path))
    except OSError:
        return None
