"""The card: refuse to run without one, and describe it."""

from __future__ import annotations

import subprocess
import sys

import torch


def require(chips: int) -> torch.device:
    """The first CUDA device; exits (code 2, no result) when there is no
    card or fewer than ``chips``. Nothing falls back to the CPU."""
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    torch.zeros(1, device=dev)
    return dev


def power_limit_w() -> float | None:
    """``nvidia-smi``'s power limit of card 0, in W, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev: torch.device) -> int:
    """Bytes at the allocator's peak on ``dev`` (0 off the card)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def describe(dev: torch.device, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak),
            "cards_visible": torch.cuda.device_count(),
            "power_limit_w": power_limit_w()}
