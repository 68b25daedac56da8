"""Host memory of matrices that live in a disk memmap.

A large run() keeps its [C, G] residual in a disk memmap
(``residual_memmap_gb``), and a caller may hand it counts that live in one
(``np.load(..., mmap_mode="r")``).  Every page of such a mapping that the
process touches counts in its resident set, so one pass over a 36 GB
memmap could leave 36 GB resident however the pass is blocked.  So run()
moves a disk memmap's rows through its file, never through the mapping:
:func:`read_rows` and :func:`gather_rows` read rows with ``os.preadv`` and
:func:`write_rows` writes them with ``os.pwrite`` (then drops them from
the page cache).  :func:`release` drops the pages that a pass through the
mapping did touch.  Dropping pages with msync and madvise alone was not
enough on the H100 host where the 1M-cell run was measured: pages that a
pass had read or written through the mapping stayed resident long after.
The matrix stays an ``np.memmap`` of the same file, and the data never
changes.
"""

from __future__ import annotations

import mmap
import os
from typing import Optional

import numpy as np


def _mapping_address(mm: mmap.mmap) -> int:
    """The address of a mapping's first byte."""
    return np.frombuffer(mm, np.uint8).ctypes.data


def _shared_rows(a):
    """(mapping, byte offset of a's first row in the mapping, file offset of
    the mapping) for a row-major shared disk memmap, else None."""
    mm = getattr(a, "_mmap", None)
    if (mm is None or getattr(a, "mode", "c") == "c" or a.ndim == 0
            or not a.flags.c_contiguous):
        return None
    return (mm, a.ctypes.data - _mapping_address(mm),
            a.offset - a.offset % mmap.ALLOCATIONGRANULARITY)


def _row_bytes(a) -> int:
    return a.strides[0] if a.ndim > 1 else a.itemsize


def _file_offset(a, shared, row: int) -> int:
    """The file offset of row `row` of the disk memmap `a`."""
    _mm, first, file_start = shared
    return file_start + first + row * _row_bytes(a)


def _pread(fd: int, out: np.ndarray, offset: int) -> None:
    """Fill the contiguous array `out` from the file at `offset`."""
    buf = memoryview(out.reshape(-1)).cast("B")
    done = 0
    while done < len(buf):
        n = os.preadv(fd, [buf[done:]], offset + done)
        if n == 0:
            raise EOFError(f"the file ends before byte {offset + len(buf)}")
        done += n


def is_disk_memmap(a) -> bool:
    """True for a row-major shared disk memmap (what the functions here
    move through its file)."""
    return _shared_rows(a) is not None


def release(a, lo: int = 0, hi: Optional[int] = None) -> None:
    """Write rows [lo, hi) of a shared disk memmap back to its file and drop
    their pages from this process's mapping and from the page cache.
    Anything else (an in-memory array, a copy-on-write memmap, an array
    that is not row-major) is left as it is."""
    shared = _shared_rows(a)
    if shared is None:
        return
    mm, first, file_start = shared
    n = a.shape[0]
    hi = n if hi is None else min(hi, n)
    if hi <= lo:
        return
    page = mmap.PAGESIZE
    start = (first + lo * _row_bytes(a)) // page * page
    stop = min(-(-(first + hi * _row_bytes(a)) // page) * page, len(mm))
    mm.flush(start, stop - start)                  # dirty pages to the file
    mm.madvise(mmap.MADV_DONTNEED, start, stop - start)
    fd = os.open(a.filename, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, file_start + start, stop - start,
                         os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def read_rows(a, lo: int, hi: int) -> np.ndarray:
    """a[lo:hi]: a view of an in-memory array; from a shared disk memmap a
    new array, read through its file."""
    shared = _shared_rows(a)
    if shared is None:
        return a[lo:hi]
    lo, hi = max(lo, 0), min(hi, a.shape[0])
    out = np.empty((max(hi - lo, 0),) + a.shape[1:], a.dtype)
    fd = os.open(a.filename, os.O_RDONLY)
    try:
        _pread(fd, out, _file_offset(a, shared, lo))
    finally:
        os.close(fd)
    return out


def write_rows(a, lo: int, values: np.ndarray) -> None:
    """a[lo:lo + len(values)] = values.  Into a shared disk memmap the rows
    are written through its file (os.pwrite) and then released, so they
    never become resident pages of this process; the mapping reads them
    from the file."""
    shared = _shared_rows(a)
    if shared is None or a.mode == "r":   # a read-only memmap raises here
        a[lo:lo + len(values)] = values
        return
    data = np.ascontiguousarray(values, dtype=a.dtype)
    if data.shape[1:] != a.shape[1:] or not 0 <= lo <= a.shape[0] - len(data):
        raise ValueError(f"rows of shape {data.shape} do not fit at row {lo} "
                         f"of a {a.shape} memmap")
    buf = memoryview(data.reshape(-1)).cast("B")
    fd = os.open(a.filename, os.O_WRONLY)
    try:
        done, offset = 0, _file_offset(a, shared, lo)
        while done < len(buf):
            done += os.pwrite(fd, buf[done:], offset + done)
    finally:
        os.close(fd)
    release(a, lo, lo + len(data))


def _pread_rows(x, shared, fd: int, rows: np.ndarray) -> np.ndarray:
    """x[rows] from the open file of the disk memmap x: the rows' span in
    one read where they fill at least half of it, else each run of
    consecutive rows in a read of its own."""
    n = rows.size
    lo, hi = int(rows.min()), int(rows.max()) + 1
    if lo < 0 or hi > x.shape[0]:
        raise IndexError(f"rows {lo}..{hi - 1} out of range for {x.shape[0]} rows")
    if hi - lo <= 2 * n:
        span = np.empty((hi - lo,) + x.shape[1:], x.dtype)
        _pread(fd, span, _file_offset(x, shared, lo))
        return span[rows - lo]
    out = np.empty((n,) + x.shape[1:], x.dtype)
    order = np.argsort(rows, kind="stable")
    srt = rows[order]
    starts = np.flatnonzero(np.diff(srt, prepend=srt[0] - 2) != 1)
    for s, e in zip(starts.tolist(), np.append(starts[1:], n).tolist()):
        run = np.empty((e - s,) + x.shape[1:], x.dtype)
        _pread(fd, run, _file_offset(x, shared, int(srt[s])))
        out[order[s:e]] = run
    return out


def gather_rows(x, idx: np.ndarray, cols: Optional[np.ndarray] = None,
                block_rows: int = 16384) -> np.ndarray:
    """x[idx] (x[np.ix_(idx, cols)] with `cols`) as one in-memory copy,
    gathered `block_rows` rows at a time; from a shared disk memmap the
    rows are read through its file, so the gather holds its copy and no
    pages besides."""
    idx = np.asarray(idx, np.int64)
    width = x.shape[1] if cols is None else len(cols)
    out = np.empty((idx.size, width), x.dtype)
    shared = _shared_rows(x)
    fd = os.open(x.filename, os.O_RDONLY) if shared is not None else None
    try:
        for b in range(0, idx.size, block_rows):
            rows = idx[b:b + block_rows]
            part = x[rows] if fd is None else _pread_rows(x, shared, fd, rows)
            out[b:b + rows.size] = part if cols is None else part[:, cols]
    finally:
        if fd is not None:
            os.close(fd)
    return out
