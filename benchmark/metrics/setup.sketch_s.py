"""Host seconds of the cuts' sketch inside the port's bin_matrix
(``setup.sketch`` around compute_cut_points, the registry's
training_phase_seconds). Layer: ingest and binning (data/binning.py)."""

from benchmark.spans import phase_s


def read(ctx):
    return phase_s("setup.sketch")
