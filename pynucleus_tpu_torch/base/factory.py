"""Name -> constructor registry.

The part of pynucleus_tpu/base/factory.py factory that nl/kernels.py
kernelFactory and twoPointFunctionFactory use: registration (with
aliases), and construction by a case-insensitive
name with the caller's arguments.
"""


class factory:
    def __init__(self):
        self.classes = {}

    def register(self, name, classType, aliases=None):
        for key in [name] + list(aliases or ()):
            self.classes[key.lower()] = classType

    def __call__(self, name, *args, **kwargs):
        key = name.lower()
        if key not in self.classes:
            raise KeyError(
                f"'{name}' not registered; available: {sorted(self.classes)}")
        return self.classes[key](*args, **kwargs)
