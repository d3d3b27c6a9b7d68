"""Run-dir environment manifest: what produced this run, for forensics.

Counterpart of vitgan_tpu/utils/manifest.py: every run dir gets an
``env.json`` next to ``config.json`` with the torch and CUDA versions, the
device's name and count, and the code revision when the package sits in its
own git checkout.  Read it before comparing numbers across runs.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
from typing import Any, Dict


def collect_env() -> Dict[str, Any]:
    import numpy as np
    import torch

    cuda = torch.cuda.is_available()
    info: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch_version": torch.__version__,
        "numpy_version": np.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
    }
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        # Only trust the hash when the repo's top level is this checkout: a
        # package installed inside another git repo would record its HEAD.
        top = subprocess.run(["git", "-C", repo, "rev-parse", "--show-toplevel"],
                             capture_output=True, text=True, timeout=5, check=True).stdout.strip()
        if os.path.realpath(top) != os.path.realpath(repo):
            raise ValueError("enclosing git repo is not the package's checkout")
        info["code_revision"] = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5, check=True).stdout.strip()
    except (OSError, ValueError, subprocess.SubprocessError):  # no git, not a checkout
        info["code_revision"] = None
    return info


def write_env_manifest(path: str) -> Dict[str, Any]:
    """Write ``collect_env()`` to ``path`` (best-effort) and return it."""
    info = collect_env()
    try:
        with open(path, "w") as f:
            json.dump(info, f, indent=2, sort_keys=True)
    except OSError:
        pass  # a read-only run dir must not kill training over a manifest
    return info
