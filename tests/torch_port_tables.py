"""Neighbour tables shared by the port's CPU tests."""

import numpy as np


def punch_holes(rng, nbr, mask, rslot, frac=0.2):
    """A copy of `mask` with both ends of a fraction of the edges masked off:
    rows then have real slots after padded ones, padded slots keep their
    neighbour ids, and the table stays symmetric with `rslot` still valid."""
    b, v, d = np.nonzero((mask > 0) & (rng.random(mask.shape) < frac))
    mask = mask.copy()
    mask[b, v, d] = 0
    mask[b, nbr[b, v, d], rslot[b, v, d]] = 0
    assert ((mask[..., 1:] > 0) & (mask[..., :-1] == 0)).any()
    return mask
