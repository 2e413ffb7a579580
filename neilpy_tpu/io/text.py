"""Text point-cloud loaders (ISPRS ground-truth samples and friends)."""

from __future__ import annotations

__all__ = ["read_xyz", "read_isprs"]


def read_isprs(fn):
    """Load an ISPRS labelled sample (``samp*.txt``): tab-separated
    ``x y z ground_label`` (reference usage: test_neilpy.py:62-79)."""
    import pandas as pd
    return pd.read_csv(fn, header=None, names=["x", "y", "z", "g"],
                       delimiter="\t")


def read_xyz(fn, delimiter=None, names=("x", "y", "z")):
    """Generic whitespace/delimited xyz loader."""
    import pandas as pd
    # one separator argument only: pandas rejects delimiter= and sep=
    # together, so an explicit delimiter used to raise unconditionally
    return pd.read_csv(fn, header=None, names=list(names),
                       sep=delimiter if delimiter is not None else r"\s+")
