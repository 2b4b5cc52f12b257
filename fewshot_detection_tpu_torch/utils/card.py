"""The device an entry point runs on, and the card a measurement ran on, in
nvidia-smi's words.

Every number a bench script prints belongs beside the card's name and its
power limit: a card set below its maximum power runs slower under load."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. `"cuda"` without a card raises:
    nothing moves to the CPU unless the caller asked for `"cpu"`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def nvidia_smi(query: str, index: int = 0) -> str:
    """`nvidia-smi --query-gpu=<query> --format=csv,noheader` for card
    `index`, as one line. Raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[index].strip()


def card_line(device: torch.device) -> str:
    """The line a bench script prints before its result: `card: <name>,
    <power limit>` on a CUDA device, `card: none (cpu)` on the CPU."""
    if device.type != "cuda":
        return "card: none (cpu)"
    return "card: " + nvidia_smi("name,power.limit", device.index or 0)
