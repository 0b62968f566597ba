"""Output groups of the drivers (port of pynucleus_tpu/base/utilsFem.py's
outputGroup: labelled values printed in the JAX drivers' format)."""
from __future__ import annotations

import numpy as np

__all__ = ['outputGroup']


class outputGroup:
    def __init__(self, name=''):
        self.name = name
        self.entries = []

    def add(self, label, value):
        self.entries.append((label, value))

    def toDict(self):
        out = {}
        for label, v in self.entries:
            if isinstance(v, np.floating):
                v = float(v)
            elif isinstance(v, np.integer):
                v = int(v)
            out[label] = v
        return out

    def __str__(self):
        lines = [self.name + ':'] if self.name else []
        width = max((len(label) for label, _ in self.entries), default=0)
        for label, v in self.entries:
            sval = '{:.6e}'.format(v) if isinstance(v, (float, np.floating)) \
                else str(v)
            lines.append('  {:{w}} {}'.format(label + ':', sval, w=width + 1))
        return '\n'.join(lines)

    def log(self):
        print(str(self), flush=True)
