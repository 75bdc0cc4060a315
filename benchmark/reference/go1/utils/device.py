"""Device selection and device constants."""

import functools

import torch


def resolve_device(device=None):
    """The device an entry point places its tensors on.

    ``None`` means the CUDA card; with no card present this raises rather
    than carrying on silently on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        device = "cuda"
    # normalized, so that "cuda" and "cuda:0" compare equal
    return torch.empty(0, device=device).device


@functools.lru_cache(maxsize=None)
def const(values, dtype, device):
    """A small constant tensor from a tuple of floats, copied to ``device``
    once: every fresh copy from host memory would wait for the device."""
    return torch.tensor(values, dtype=torch.float64).to(device=device,
                                                        dtype=dtype)
