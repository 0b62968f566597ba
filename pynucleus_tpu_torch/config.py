"""Types and device selection of the PyTorch port.

REAL and INDEX mirror pynucleus_tpu/config.py (float64 quadrature and
solves, int32 mesh connectivity).  Index tensors on the device are int64,
PyTorch's index type.  There is no global device: every builder and solver
takes an explicit ``torch.device`` from :func:`getDevice`.
"""
import numpy as np
import torch

REAL = np.float64
INDEX = np.int32

TREAL = torch.float64
TINDEX = torch.int64


def getDevice(device='cpu'):
    """``torch.device`` for a name or device.  Asking for CUDA where no GPU
    is present raises: the port never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested, but '
                           'torch.cuda.is_available() is False')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {device!r}')
    return dev
