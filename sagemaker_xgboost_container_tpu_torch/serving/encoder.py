"""Inference payload decoding: request bytes -> DataMatrix.

csv with delimiter sniffing (blank cell -> NaN), libsvm with the 1-based
index shift at serve time, recordio-protobuf, and the jsonlines conversion
helper. Decoders return label-free DataMatrix objects for the predict path.
"""

import csv as csv_module
import io
import json

import numpy as np
import scipy.sparse as sp

from ..data.matrix import DataMatrix
from ..data.recordio import read_recordio_protobuf


def _clean_csv_cells(line, delimiter):
    return ["nan" if cell == "" else cell for cell in line.split(delimiter)]


# csv.Sniffer's preferred-delimiter set plus '|'
_DELIM_CANDIDATES = (",", "\t", ";", "|", " ", ":")


def _sniff_delimiter(first_line):
    """csv.Sniffer costs ~0.4 ms per call, so the unambiguous cases (zero or
    exactly one candidate delimiter present) short-circuit it; only
    ambiguous lines (e.g. both ',' and ' ' present) pay for the Sniffer.

    The probe line is stripped first: a single-column payload with
    incidental leading/trailing whitespace (``b"1.0 "``) must not sniff
    ``' '`` and grow a phantom NaN column."""
    first_line = first_line.strip()
    present = [c for c in _DELIM_CANDIDATES if c in first_line]
    if not present:
        return ","
    if len(present) == 1:
        return present[0]
    try:
        sniffed = csv_module.Sniffer().sniff(first_line).delimiter
    except csv_module.Error:
        sniffed = ","
    return "," if sniffed.isalnum() else sniffed


def csv_to_matrix(input_data, dtype=np.float32):
    """CSV request body (no label column) -> DataMatrix."""
    text = input_data.decode() if isinstance(input_data, (bytes, bytearray)) else input_data
    delimiter = _sniff_delimiter(text.split("\n")[0][:512])
    rows = [_clean_csv_cells(line, delimiter) for line in text.split("\n") if line != ""]
    data = np.asarray(rows).astype(dtype)
    return DataMatrix(data)


def libsvm_to_matrix(string_like):
    """LIBSVM request body (no labels) -> DataMatrix.

    Serve-time payloads conventionally use standard 1-based libsvm indices;
    when every index is >= 1 they are shifted down by one.
    """
    if isinstance(string_like, (bytes, bytearray)):
        string_like = string_like.decode("utf-8")
    row_ids, col_ids, values = [], [], []
    n_rows = 0
    for line in string_like.strip().split("\n"):
        for token in line.strip().split():
            if ":" in token:
                idx, _, val = token.partition(":")
                row_ids.append(n_rows)
                col_ids.append(int(idx))
                values.append(float(val))
        n_rows += 1
    if not values:
        return DataMatrix(np.full((n_rows, 0), np.nan, np.float32))
    col_ids = np.asarray(col_ids, np.int64)
    if col_ids.min() >= 1:
        col_ids = col_ids - 1
    csr = sp.csr_matrix(
        (np.asarray(values, np.float32), (np.asarray(row_ids), col_ids)),
        shape=(n_rows, int(col_ids.max()) + 1),
    )
    return DataMatrix(csr)


def recordio_protobuf_to_matrix(string_like):
    features, _labels = read_recordio_protobuf(bytes(string_like))
    return DataMatrix(features)


def json_to_jsonlines(json_data):
    """``{"predictions": [...]}`` -> one JSON document per line (bytes)."""
    resp = json_data if isinstance(json_data, dict) else json.loads(json_data)
    if len(resp.keys()) != 1:
        raise ValueError("JSON response is not compatible for conversion to jsonlines.")
    bio = io.BytesIO()
    for value in resp.values():
        for entry in value:
            bio.write(bytes(json.dumps(entry) + "\n", "UTF-8"))
    return bio.getvalue()
