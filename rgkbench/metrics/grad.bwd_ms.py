"""CUDA-event ms of the same eager step's `torch.autograd.grad`."""


def read(rec):
    return rec.get("bwd_ms")
