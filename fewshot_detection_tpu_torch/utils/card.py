"""The card a measurement ran on, in nvidia-smi's words.

Every number a bench script prints belongs beside the card's name and its
power limit: a card set below its maximum power runs slower under load."""

from __future__ import annotations

import subprocess

import torch


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
