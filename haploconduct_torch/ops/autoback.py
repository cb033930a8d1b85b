"""backend="auto": the scoring kernel on the CUDA card ("torch").

Without a card, "auto" raises: the port never moves to a CPU engine on its
own. The host engines run only when named, by the caller (backend="native"
or "numpy", the CLI's --backend) or by HC_BACKEND=torch|native|numpy,
which overrides "auto".
"""

from __future__ import annotations

import os

import torch

BACKENDS = ("torch", "native", "numpy")


def resolve_backend() -> str:
    env = os.environ.get("HC_BACKEND")
    if env in BACKENDS:
        return env
    if not torch.cuda.is_available():
        raise RuntimeError(
            "backend='auto' needs a CUDA card and torch.cuda.is_available() is "
            "False; name a host engine to run on the CPU (backend='native' or "
            "'numpy', --backend, or HC_BACKEND)")
    return "torch"
