"""Fragment-file access through the port's native engine (counterpart of
muon_tpu/atac/fragments.py).

``TabixFragments`` reads a bgzip'd, tabix-indexed fragments file with
``native/fragments.cpp`` (no pysam, no htslib): records come back as numpy
arrays, with the barcodes resolved to int32 row indices inside C++.
``write_fragments`` writes such a file and its ``.tbi``; it formats the
text with numpy, a column at a time, not with a Python f-string per record
(the bytes are the same).
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Optional, Sequence

import numpy as np

from ..native import load_fragments_lib

__all__ = ["TabixFragments", "write_fragments"]


class TabixFragments:
    """Region-indexed reader over a bgzip'd, tabix-indexed fragments file."""

    def __init__(self, path: str, barcodes: Optional[Sequence[str]] = None):
        self._lib = load_fragments_lib()
        self._f = self._lib.frag_open(path.encode())
        if not self._f:
            raise FileNotFoundError(f"could not open fragments file {path}")
        self.path = path
        if barcodes is not None:
            self.set_barcodes(barcodes)

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        if getattr(self, "_f", None):
            self._lib.frag_close(self._f)
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    # -- metadata -----------------------------------------------------------

    @property
    def contigs(self):
        n = self._lib.frag_n_contigs(self._f)
        return [self._lib.frag_contig_name(self._f, i).decode() for i in range(n)]

    def set_barcodes(self, barcodes: Iterable[str]):
        """Resolve records' barcodes to their positions in ``barcodes``
        (−1 for a barcode not in it)."""
        bs = list(barcodes)
        blob = b"\0".join(s.encode() for s in bs) + b"\0"
        self._lib.frag_set_barcodes(self._f, blob, len(bs))

    # -- record access ------------------------------------------------------

    def _results(self, n: int, names: bool = False):
        if n <= 0:
            out = dict(
                starts=np.empty(0, np.int64),
                ends=np.empty(0, np.int64),
                cells=np.empty(0, np.int32),
                scores=np.empty(0, np.int32),
            )
            if names:
                out["names"] = np.empty(0, dtype=object)
            return out
        as_np = np.ctypeslib.as_array
        out = dict(
            starts=as_np(self._lib.frag_starts(self._f), (n,)).copy(),
            ends=as_np(self._lib.frag_ends(self._f), (n,)).copy(),
            cells=as_np(self._lib.frag_cells(self._f), (n,)).copy(),
            scores=as_np(self._lib.frag_scores(self._f), (n,)).copy(),
        )
        if names:
            offs = as_np(self._lib.frag_name_offsets(self._f), (n + 1,))
            buflen = self._lib.frag_name_buf_len(self._f)
            buf = ctypes.string_at(self._lib.frag_name_buf(self._f), buflen)
            out["names"] = np.array(
                [buf[offs[i]:offs[i + 1]].decode() for i in range(n)], dtype=object
            )
        return out

    def fetch(self, chrom: str, start: int, end: int, names: bool = False):
        """Fetch records overlapping [start, end) on chrom.

        Returns dict of arrays: starts, ends, cells (int32 row ids from the
        barcode dict, −1 if unknown), scores; plus names if requested."""
        n = self._lib.frag_fetch(self._f, chrom.encode(), int(start), int(end))
        if n < 0:
            raise IOError(f"fetch failed on {self.path}")
        return self._results(int(n), names=names)

    def fetch_many(self, chroms, starts, ends, names: bool = False):
        """Batched region fetch: all queries run inside one native call.
        Returns the usual arrays plus ``region_offsets`` (n_regions+1)
        delimiting each query's records. Unknown contigs yield empty
        slices."""
        tid_of = {c: i for i, c in enumerate(self.contigs)}
        tids = np.asarray([tid_of.get(str(c), -1) for c in chroms], np.int32)
        begs = np.asarray(starts, np.int64)
        fins = np.asarray(ends, np.int64)
        nreg = len(tids)
        offs = np.zeros(nreg + 1, np.int64)
        n = self._lib.frag_fetch_many(
            self._f,
            tids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            begs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            fins.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            nreg,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if n < 0:
            raise IOError(f"fetch_many failed on {self.path}")
        out = self._results(int(n), names=names)
        out["region_offsets"] = offs
        return out

    def stream(self, n_max: int, names: bool = False):
        """Read the first n_max records of the file (across contigs)."""
        n = self._lib.frag_stream(self._f, int(n_max))
        if n < 0:
            raise IOError(f"stream failed on {self.path}")
        return self._results(int(n), names=names)


# ---------------------------------------------------------------------------
# the writer: each line is laid out in a byte matrix, one fixed-width slot a
# column, the unused bytes of a slot 0; dropping the 0 bytes leaves the lines
# ---------------------------------------------------------------------------

_WRITE_ROWS = 1 << 20  # records formatted at a time


def _string_slots(values):
    """(codes, table): ``table[codes]`` is each value's UTF-8 bytes, left
    aligned in a zero-padded row."""
    import pandas as pd

    if isinstance(values, pd.Categorical) or isinstance(
            getattr(values, "dtype", None), pd.CategoricalDtype):
        cat = pd.Categorical(values)
        codes, uniq = cat.codes, np.asarray(cat.categories, dtype=object)
        if (codes < 0).any():
            raise ValueError("a fragments record has no chromosome or barcode")
    else:
        uniq, codes = np.unique(np.asarray(values, dtype=str), return_inverse=True)
    enc = [str(u).encode() for u in uniq]
    table = np.zeros((len(enc), max([1, *map(len, enc)])), np.uint8)
    for i, b in enumerate(enc):
        if b"\0" in b or b"\t" in b or b"\n" in b:
            raise ValueError(f"a fragments field may not hold a tab, newline or NUL: {b!r}")
        table[i, :len(b)] = np.frombuffer(b, np.uint8)
    return np.asarray(codes, np.int64), table


def _int_slot(v: np.ndarray, width: int) -> np.ndarray:
    """Decimal text of int64 ``v`` right-aligned in ``width`` bytes (a sign
    byte included), the bytes before the text 0."""
    a = np.abs(v)
    out = np.zeros((len(v), width), np.uint8)
    ndig = np.ones(len(v), np.int64)
    for j in range(1, width):
        ndig += a >= 10 ** j
    for k in range(width):
        p = width - 1 - k  # the power of ten at byte k
        out[:, k] = np.where(ndig > p, 48 + (a // 10 ** p) % 10, 0)
    sign_at = width - 1 - ndig
    neg = np.flatnonzero(v < 0)
    out[neg, sign_at[neg]] = ord("-")
    return out


def _format_records(chroms, starts, ends, barcodes, scores) -> bytes:
    ccodes, ctable = _string_slots(chroms)
    bcodes, btable = _string_slots(barcodes)
    ints = [np.asarray(x, np.int64) for x in (starts, ends, scores)]
    # the longest text of a column is that of its least or its greatest value
    widths = [max(len(str(int(x.min()))), len(str(int(x.max())))) if len(x) else 1
              for x in ints]
    pieces = []
    for lo in range(0, len(ccodes), _WRITE_ROWS):
        hi = min(lo + _WRITE_ROWS, len(ccodes))
        tab = np.full((hi - lo, 1), ord("\t"), np.uint8)
        row = np.concatenate([
            ctable[ccodes[lo:hi]], tab,
            _int_slot(ints[0][lo:hi], widths[0]), tab,
            _int_slot(ints[1][lo:hi], widths[1]), tab,
            btable[bcodes[lo:hi]], tab,
            _int_slot(ints[2][lo:hi], widths[2]),
            np.full((hi - lo, 1), ord("\n"), np.uint8),
        ], axis=1)
        pieces.append(row[row != 0].tobytes())
    return b"".join(pieces)


def write_fragments(path: str, records) -> str:
    """Write records to a bgzip'd fragments file and its tabix index.

    records: an iterable of (chrom, start, end, barcode, score) tuples or a
    DataFrame with those five columns (categorical chromosome and barcode
    columns are read through their codes), sorted by (chrom, start). Each
    line is ``chrom\\tstart\\tend\\tbarcode\\tscore``, as the JAX package
    writes it. Returns path."""
    import pandas as pd

    lib = load_fragments_lib()
    if isinstance(records, pd.DataFrame):
        cols = [records.iloc[:, j] for j in range(5)]
        cols = [c.array if isinstance(c.dtype, pd.CategoricalDtype) else c.to_numpy()
                for c in cols]
    else:
        recs = list(records)
        cols = [np.asarray([r[j] for r in recs], dtype=object if j in (0, 3) else np.int64)
                for j in range(5)]
    data = _format_records(*cols)
    if lib.frag_write_bgzf(path.encode(), data, len(data)) != 0:
        raise IOError(f"failed to write bgzf file {path}")
    if lib.tabix_build(path.encode()) != 0:
        raise IOError(f"failed to build tabix index for {path}")
    return path
