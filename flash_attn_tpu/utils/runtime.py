"""Process set-up shared by the entry points (chip_smoke.py, bench.py,
run.py): the persistent compile cache and the card's identity."""

import os
import shutil
import subprocess
from typing import Optional

import jax

__all__ = ["configure_compile_cache", "card_name_and_power_limit"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache(root: str = REPO_ROOT) -> str:
    """Keep JAX's persistent compile cache where ``JAX_COMPILATION_CACHE_DIR``
    says (JAX reads the variable itself, so nothing is set here), else in
    ``<root>/.jax_cache``. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each, or None where there is no nvidia-smi. The query opens no JAX
    client, so it does not compete for the card's memory."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    return subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
