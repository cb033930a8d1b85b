"""Where the torch backend runs: the one place that decides.

`default_devices()` is every card CUDA leaves visible, or the CPU when the
caller asks for it with HC_TORCH_DEVICE=cpu (the CLI's --device cpu), the
counterpart of the reference tests' JAX_PLATFORMS=cpu. Without a card and
without that request it raises: the port never moves to the CPU on its
own. The ops modules take their default device here and parallel/mesh.py
its default mesh; this module imports nothing of them.
"""

from __future__ import annotations

import os
from typing import List

import torch

from . import distributed

DEVICE_ENV = "HC_TORCH_DEVICE"


def _asked() -> str:
    asked = os.environ.get(DEVICE_ENV) or "cuda"
    if asked not in ("cuda", "cpu"):
        raise ValueError(f"{DEVICE_ENV} must be 'cuda' or 'cpu', not {asked!r}")
    return asked


def on_card() -> bool:
    """Whether the torch backend runs on a card: one is visible and the
    caller did not ask for the CPU. Never raises for a missing card."""
    return _asked() == "cuda" and torch.cuda.is_available()


def default_devices() -> List[torch.device]:
    """The devices the torch backend runs on: the CPU when the caller asks
    for it (HC_TORCH_DEVICE=cpu); otherwise every card CUDA leaves visible
    in a single process, the rank's own card under a process group of more
    than one rank. Without a card, and unless the CPU was asked for, this
    raises."""
    if _asked() == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the torch backend runs on a CUDA card and torch.cuda.is_available() "
            f"is False; set {DEVICE_ENV}=cpu (the CLI's --device cpu) to run its "
            "plain versions on the CPU")
    if distributed.process_count() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_device() -> torch.device:
    """The device of a call that runs on one device: the first of
    default_devices()."""
    return default_devices()[0]
