"""Device selection for the port's entry points.

Entry points default to the card. Without one they raise, unless the
caller asks for the CPU explicitly: a run that was meant for the card never
drops to the CPU unnoticed.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
