"""Indexed FASTA access (a copy of muon_tpu/atac/_fasta.py, which replaces
the reference's pybedtools/bedtools C dependency for sequence extraction,
muon/_atac/tools.py:520-566). Host code: the faidx reader, and building and
writing the ``.fai`` index."""

from __future__ import annotations

import os
from typing import Dict, Tuple

__all__ = ["FastaFile"]


class FastaFile:
    """faidx-style random access: uses <path>.fai when present, otherwise
    builds the index by one scan (and writes it for next time if possible)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self.index: Dict[str, Tuple[int, int, int, int]] = {}
        fai = path + ".fai"
        if os.path.exists(fai):
            self._read_fai(fai)
        else:
            self._build_index()
            try:
                with open(fai, "w") as f:
                    for name, (ln, off, lb, lw) in self.index.items():
                        f.write(f"{name}\t{ln}\t{off}\t{lb}\t{lw}\n")
            except OSError:
                pass

    def _read_fai(self, fai: str):
        with open(fai) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 5:
                    name, ln, off, lb, lw = parts[:5]
                    self.index[name] = (int(ln), int(off), int(lb), int(lw))

    def _build_index(self):
        self._fh.seek(0)
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        pos = 0
        for raw in self._fh:
            llen = len(raw)
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    self.index[name] = (length, offset, linebases, linewidth)
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + llen
                linebases = 0
                linewidth = 0
            elif name is not None and line:
                if linebases == 0:
                    linebases = len(line)
                    linewidth = llen
                length += len(line)
            pos += llen
        if name is not None:
            self.index[name] = (length, offset, linebases, linewidth)

    @property
    def references(self):
        return list(self.index.keys())

    def fetch(self, chrom: str, start: int, end: int) -> str:
        """0-based half-open [start, end) sequence."""
        if chrom not in self.index:
            raise KeyError(f"contig {chrom} not in {self.path}")
        length, offset, linebases, linewidth = self.index[chrom]
        start = max(0, int(start))
        end = min(int(end), length)
        if end <= start:
            return ""
        byte_start = offset + (start // linebases) * linewidth + start % linebases
        # read enough raw bytes to cover the span including newlines
        span = end - start
        n_lines = (start % linebases + span) // linebases + 2
        self._fh.seek(byte_start)
        raw = self._fh.read(span + n_lines * (linewidth - linebases))
        seq = raw.replace(b"\n", b"").replace(b"\r", b"")[:span]
        return seq.decode()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
