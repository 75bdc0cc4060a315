"""Device selection, matmul-precision pinning, per-thread streams and
device constants."""

import contextlib
import functools

import torch


def pin_f32_matmuls():
    """Pin true-float32 products for the whole process.

    The solver, condensation and EKF paths need full f32 products (the JAX
    package pins them with ``utils/precision.py::f32_matmuls``): single-pass
    TF32 or bf16 keeps ~3 decimal digits, which drives the Newton-Schulz
    products to overflow (the JAX package's ``admm._schedule_precisions``
    records the divergence to 1e31). Entry points call this before they
    compute.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """The device an entry point places its tensors on; pins f32 products.

    ``None`` means the CUDA card; with no card present this raises rather
    than carrying on silently on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions (the tests do).
    """
    pin_f32_matmuls()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        device = "cuda"
    # normalized, so that "cuda" and "cuda:0" compare equal
    return torch.empty(0, device=device).device


def new_stream(device):
    """A CUDA stream of its own on ``device``, or None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream):
    """Context in which the calling thread issues its work on ``stream``
    (PyTorch's current stream is per thread); a no-op for None."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def synchronize(device):
    """Wait for the calling thread's current stream on ``device`` (a no-op
    on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@functools.lru_cache(maxsize=None)
def const(values, dtype, device):
    """A small constant tensor from a tuple of floats, copied to ``device``
    once: every fresh copy from host memory would wait for the device."""
    return torch.tensor(values, dtype=torch.float64).to(device=device,
                                                        dtype=dtype)
