"""Where the port runs: the CUDA card unless the caller asks for another
device. An entry point without CUDA raises rather than carry on on the CPU;
callers that mean the CPU (the CPU tests) pass ``device="cpu"``."""
from __future__ import annotations

import torch


def resolve_device(device: "torch.device | str | None" = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU card unless asked "
            "otherwise; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
