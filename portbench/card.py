"""The run's environment: cache directories, the card, the process's age,
and the modules a run must not hold."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

# where the checkout keeps every kernel and build cache of a run: fixed
# paths, so that only a checkout's first run of a cell builds and compiles
# (the port builds its own kernels into lantern_tpu_torch/_build/ beside its
# sources, also inside the checkout)
CACHE = ".portbench_cache"
CACHE_VARS = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "nv_compute_cache",
}
# top-level module names that no run may hold once its window has closed:
# the JAX package and JAX itself, compared whole (the port's own name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "lantern_tpu")


def point_caches(root: Path) -> None:
    """Every build and kernel cache into fixed folders of the checkout; set
    before torch is imported."""
    for var, sub in CACHE_VARS.items():
        path = root / CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # transformers, where something loads it, must not load JAX
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_age_s() -> float:
    """Seconds since this process started, from /proc (clock ticks since
    boot against the uptime); the interpreter's start is set-up too."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start


def forbidden_modules() -> list[str]:
    """Names in ``sys.modules`` whose top-level part is a forbidden name."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def require_cards(chips: int) -> None:
    """Exit 1, printing no result, without ``chips`` CUDA cards: nothing is
    measured on the CPU."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench: torch.cuda.is_available() is False; a run needs "
                 "an NVIDIA card and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        sys.exit(f"portbench: the cell asks for {chips} cards, "
                 f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def describe(device) -> dict:
    """The card line (after ``chip_smoke.py`` phase_environment, line 480):
    name, count and power limit. On the CPU (tests) the platform is ``cpu``
    and the power limit is absent."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        out["power_limit_w"] = float(smi.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        log(f"nvidia-smi gave no power limit: {e}")
    return out


def log(msg: str) -> None:
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)
