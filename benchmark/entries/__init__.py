"""The cells' entries, one module each, found by the workload's ``entry``.

Each defines ``Feed(run)``, whose ``next()`` gives the next (x, y) batch on
the device as the window's step takes it and whose ``close()`` stops what
it started, and ``indices(wl, step)``: the sample indices of a rank's
batch at a 0-based step, from which the reference makes the same batch."""
