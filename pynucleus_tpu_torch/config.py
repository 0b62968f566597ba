"""Types and device selection of the PyTorch port.

REAL and INDEX mirror pynucleus_tpu/config.py (float64 quadrature and
solves, int32 mesh connectivity).  Index tensors on the device are int64,
PyTorch's index type.  A builder's ``params['dtype']`` picks float32 in
place of REAL for the dense path (:func:`realType`).  There is no global
device: every builder and solver takes an explicit ``torch.device`` from
:func:`getDevice`.
"""
import numpy as np
import torch

REAL = np.float64
INDEX = np.int32

TREAL = torch.float64
TINDEX = torch.int64


def getDevice(device='cuda'):
    """``torch.device`` for a name or device; the card unless the caller
    asks for the CPU.  Asking for CUDA where no GPU is present raises: the
    port never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested, but '
                           'torch.cuda.is_available() is False')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {device!r}')
    return dev


def realType(dtype=None):
    """The torch dtype of a builder's ``params['dtype']``: float64 (TREAL)
    for None or a float64 name, float32 for ``np.float32``, ``'float32'``
    or ``torch.float32``; any other value raises ValueError."""
    if dtype is None:
        return TREAL
    if isinstance(dtype, torch.dtype):
        t = dtype
    else:
        try:
            t = {np.dtype(np.float64): torch.float64,
                 np.dtype(np.float32): torch.float32}.get(np.dtype(dtype))
        except TypeError:
            t = None
    if t not in (torch.float32, torch.float64):
        raise ValueError(f'dtype {dtype!r}: float64 or float32')
    return t
