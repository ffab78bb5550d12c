"""The card the run measures."""
import torch


def sync(device: torch.device) -> None:
    """Wait for the card; a CPU run (the tests) has nothing to wait for."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
