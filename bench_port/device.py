"""The few device calls the drivers share; on the CPU (the tests' rehearsal
of a run) they do nothing."""
from __future__ import annotations


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    """The process's peak of allocated device memory so far."""
    import torch
    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def free(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.empty_cache()


def profiler(device: str):
    """A profiler of the device's operations (CUPTI), not started."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if device == "cuda"
                               else ProfilerActivity.CPU])
