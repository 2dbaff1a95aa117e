"""In-memory form of the HDF5 layout shared by `.up` files and parameter
libraries.

A Group is a dict of members (Groups or Datasets) plus an `attrs` dict; a
Dataset is a NumPy array plus an `attrs` dict.  They are indexed the way
h5py objects are (``grp["input/pos"]``, ``"name" in grp``, ``grp.attrs``,
``ds.attrs``), so the config builder, the system reader and the library
readers take either form.  Building and running a system in memory needs no
h5py; `write_h5` stores a tree as the same HDF5 file the reference reads.
"""

from __future__ import annotations

import contextlib

import numpy as np


class Dataset(np.ndarray):
    """A NumPy array with an HDF5-style `attrs` dict."""

    def __new__(cls, data, attrs=None):
        obj = np.asarray(data).view(cls)
        obj.attrs = dict(attrs or {})
        return obj

    def __array_finalize__(self, obj):
        self.attrs = getattr(obj, "attrs", {})


class Group(dict):
    """A dict of members with an HDF5-style `attrs` dict; keys may be
    '/'-separated paths into nested groups."""

    def __init__(self, members=(), attrs=None):
        super().__init__(members)
        self.attrs = dict(attrs or {})

    def __getitem__(self, path):
        node = self
        for part in path.strip("/").split("/"):
            node = dict.__getitem__(node, part)
        return node

    def __contains__(self, path):
        try:
            self[path]
        except (KeyError, TypeError, AttributeError):
            return False
        return True


def write_h5(group, h5group):
    """Store a Group tree under an open h5py group or file."""
    for k, v in group.attrs.items():
        h5group.attrs[k] = v
    for name, member in group.items():
        if isinstance(member, Group):
            write_h5(member, h5group.create_group(name))
        else:
            ds = h5group.create_dataset(name, data=np.asarray(member))
            for k, v in getattr(member, "attrs", {}).items():
                ds.attrs[k] = v


@contextlib.contextmanager
def open_library(library):
    """Yield a parameter library given as a Group or as an HDF5 path."""
    if isinstance(library, Group):
        yield library
        return
    import h5py
    with h5py.File(library, "r") as f:
        yield f
