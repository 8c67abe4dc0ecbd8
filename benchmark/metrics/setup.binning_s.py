"""Host seconds inside the port's bin_matrix (the sketch of the cuts and the
binning of the training and validation rows). Layer: ingest and binning
(data/matrix.py, data/binning.py)."""


def read(ctx):
    return ctx.spans.get("binning_s")
