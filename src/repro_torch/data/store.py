"""Out-of-core shard store: a dataset as a directory of checksummed CSR
chunks (the JAX package's ``repro.data.store``, byte-compatible both
ways).

* A dataset is converted once, from libsvm text through the streaming
  :func:`repro_torch.data.sparse.iter_libsvm_chunks` reader or from an
  in-memory :class:`CSRMatrix`, into fixed-width CSR **chunks**:
  contiguous slabs of ``chunk_size`` indices along one axis (features
  for DiSCO-F, samples for DiSCO-S), each three ``.npy`` arrays
  (``indptr`` int64 / ``indices`` int32 / ``data``).
* ``meta.json`` is the header: per-chunk ``(start, stop, nnz)`` and, in
  format v2, the CRC32 of each chunk array and of the labels, plus
  shape, dtype and version. :func:`repro_torch.data.partition.
  chunk_partition` plans a balanced solve from the header alone. v1
  stores (no checksums) still read.
* Chunks are random-access (numpy memmaps), O(chunk) memory each.

Chunk CSR convention: rows are the **chunked axis** and columns the
other one, so a chunk of either store is a ``(chunk_width, other_dim)``
slab; :meth:`ShardStore.to_csr` reassembles the feature-major ``(d, n)``
matrix either way. Everything here is host-side numpy: the store feeds
the solver's set-up, which moves the data to the device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np

from repro_torch.data.sparse import (CSRMatrix, iter_libsvm_chunks,
                                     load_libsvm_sparse)
from repro_torch.obs import tracer as obs
from repro_torch.robust.faults import ChunkCorruptionError

STORE_VERSION = 2        # v2 adds per-chunk + labels CRC32 checksums
_COMPAT_VERSIONS = (1, 2)  # v1 stores (no checksums) still read
_META = "meta.json"
_LABELS = "labels.npy"
_CHUNK_DIR = "chunks"
_FIELDS = ("indptr", "indices", "data")


def _crc(arr: np.ndarray) -> int:
    """CRC32 of an array's contiguous bytes."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ChunkInfo:
    """Header entry of one chunk: its index range, nonzero count and (v2)
    the CRC32 of each stored array."""

    index: int   # chunk id (position along the chunked axis)
    start: int   # first covered index (inclusive)
    stop: int    # last covered index (exclusive; ragged final chunk ok)
    nnz: int     # stored nonzeros, what the LPT planner balances on
    crc: dict | None = None  # {'indptr'|'indices'|'data': crc32} (v2)


def _chunk_path(root: str, i: int, field: str) -> str:
    return os.path.join(root, _CHUNK_DIR, f"{i:06d}.{field}.npy")


def _write_chunk(root: str, i: int, indptr, indices, data) -> dict:
    """Write one chunk's three arrays; return their CRC32 checksums."""
    arrays = dict(indptr=np.asarray(indptr, np.int64),
                  indices=np.asarray(indices, np.int32),
                  data=np.asarray(data))
    crcs = {}
    for field, arr in arrays.items():
        np.save(_chunk_path(root, i, field), arr)
        crcs[field] = _crc(arr)
    return crcs


class ShardStore:
    """A chunked, memory-mappable on-disk sparse dataset and its labels.

    Open an existing store with ``ShardStore(path)``; build one with
    :meth:`from_csr` or :meth:`from_libsvm`. Reads go through
    ``np.load(..., mmap_mode='r')``, so a chunk costs page-ins of its own
    bytes only. ``verify`` (default True) checks every v2 chunk read and
    the labels against their CRC32.

    Attributes:
        path: store directory.
        axis: ``'features'`` | ``'samples'``, the chunked axis.
        shape: logical feature-major ``(d, n)`` of the dataset.
        dtype: value dtype of the stored nonzeros.
        chunk_size: indices per chunk along ``axis`` (the last chunk may
            be ragged).
        chunks: list of :class:`ChunkInfo` (the header).
    """

    def __init__(self, path: str, verify: bool = True):
        self.path = path
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta.get("version") not in _COMPAT_VERSIONS:
            raise ValueError(
                f"store {path!r} has version {meta.get('version')!r}; "
                f"this reader supports versions {_COMPAT_VERSIONS}")
        self.version: int = int(meta["version"])
        self.verify = bool(verify)    # checksum reads (v2 headers only)
        self.axis: str = meta["axis"]
        self.shape: tuple[int, int] = tuple(meta["shape"])
        self.dtype = np.dtype(meta["dtype"])
        self.chunk_size: int = int(meta["chunk_size"])
        self.labels_crc: int | None = (
            int(meta["labels_crc"]) if meta.get("labels_crc") is not None
            else None)
        self.chunks: list[ChunkInfo] = [
            ChunkInfo(index=i, start=int(c["start"]), stop=int(c["stop"]),
                      nnz=int(c["nnz"]),
                      crc=({k: int(v) for k, v in c["crc"].items()}
                           if c.get("crc") else None))
            for i, c in enumerate(meta["chunks"])]

    # -- header views ------------------------------------------------------
    @property
    def n_chunks(self) -> int:
        """Number of stored chunks."""
        return len(self.chunks)

    @property
    def n_items(self) -> int:
        """Length of the chunked axis (d for 'features', n for 'samples')."""
        return self.shape[0] if self.axis == "features" else self.shape[1]

    @property
    def other_dim(self) -> int:
        """Length of the non-chunked axis."""
        return self.shape[1] if self.axis == "features" else self.shape[0]

    @property
    def chunk_nnz(self) -> np.ndarray:
        """(n_chunks,) per-chunk nonzero counts, the partitioner's input."""
        return np.array([c.nnz for c in self.chunks], np.int64)

    @property
    def nnz(self) -> int:
        """Total stored nonzeros."""
        return int(self.chunk_nnz.sum()) if self.chunks else 0

    def data_bytes(self) -> int:
        """On-disk bytes of the chunk payload (indptr + indices + data)."""
        total = 0
        for c in self.chunks:
            width = c.stop - c.start
            total += (width + 1) * 8 + c.nnz * (4 + self.dtype.itemsize)
        return total

    # -- chunk access ------------------------------------------------------
    def chunk_file_path(self, i: int, field: str) -> str:
        """Path of one stored chunk array (``field`` in ``'indptr'`` /
        ``'indices'`` / ``'data'``)."""
        return _chunk_path(self.path, i, field)

    def _load_field(self, i: int, field: str, mode):
        """np.load one chunk array; a truncated or unparsable file raises
        :class:`ChunkCorruptionError` naming the chunk."""
        path = _chunk_path(self.path, i, field)
        try:
            return np.load(path, mmap_mode=mode)
        except (ValueError, OSError, EOFError) as e:
            raise ChunkCorruptionError(
                f"chunk {i} field {field!r} of store {self.path!r} is "
                f"unreadable (truncated or damaged file {path!r}): {e}"
            ) from e

    def chunk_csr(self, i: int, mmap: bool = True,
                  verify: bool | None = None) -> CSRMatrix:
        """CSR slab of chunk ``i``: rows are the chunked axis indices
        ``[start, stop)``, columns the whole other axis; memmaps when
        ``mmap``.

        ``verify`` (default: the store's flag) checks each array against
        the v2 header's CRC32 and raises
        :class:`repro_torch.robust.faults.ChunkCorruptionError`, naming
        the chunk and field, on a mismatch. v1 stores carry no checksums.
        """
        info = self.chunks[i]
        mode = "r" if mmap else None
        do_verify = (self.verify if verify is None else verify) \
            and bool(info.crc)
        with obs.span("store.chunk_read", cid=int(i), verify=do_verify):
            arrays = {f: self._load_field(i, f, mode) for f in _FIELDS}
            if do_verify:
                self.check_chunk(i, arrays)
        return CSRMatrix(indptr=arrays["indptr"],
                         indices=arrays["indices"],
                         data=arrays["data"],
                         shape=(info.stop - info.start, self.other_dim))

    def check_chunk(self, i: int, arrays: dict) -> None:
        """Check chunk ``i``'s arrays (``indptr`` / ``indices`` / ``data``,
        e.g. the memory maps of an earlier read) against the v2 header's
        CRC32; raise :class:`ChunkCorruptionError` naming the chunk and
        field on a mismatch. A no-op for v1 chunks."""
        info = self.chunks[i]
        for field, arr in arrays.items():
            want = (info.crc or {}).get(field)
            if want is None:
                continue
            got = _crc(arr)
            if got != want:
                raise ChunkCorruptionError(
                    f"chunk {i} field {field!r} of store {self.path!r} "
                    f"failed its checksum (crc32 {got:#010x} != header "
                    f"{want:#010x}): the stored bytes are corrupt")

    def labels(self, mmap: bool = True,
               verify: bool | None = None) -> np.ndarray:
        """(n,) labels, memory-mapped by default, checked against the v2
        header's CRC32 like the chunks."""
        y = np.load(os.path.join(self.path, _LABELS),
                    mmap_mode="r" if mmap else None)
        if (self.verify if verify is None else verify) \
                and self.labels_crc is not None and _crc(y) != self.labels_crc:
            raise ChunkCorruptionError(
                f"labels of store {self.path!r} failed their checksum: "
                "the stored bytes are corrupt")
        return y

    def to_csr(self) -> tuple[CSRMatrix, np.ndarray]:
        """The whole feature-major ``(d, n)`` CSR and the labels, in host
        memory (O(nnz)); every chunk read as :meth:`chunk_csr` reads it."""
        axis_dim = self.n_items
        indptr = np.zeros(axis_dim + 1, np.int64)
        ind_parts, val_parts = [], []
        for c in self.chunks:
            slab = self.chunk_csr(c.index)
            counts = np.diff(np.asarray(slab.indptr))
            indptr[c.start + 1: c.stop + 1] = counts
            ind_parts.append(np.asarray(slab.indices))
            val_parts.append(np.asarray(slab.data))
        np.cumsum(indptr, out=indptr)
        indices = (np.concatenate(ind_parts) if ind_parts
                   else np.zeros(0, np.int32))
        values = (np.concatenate(val_parts) if val_parts
                  else np.zeros(0, self.dtype))
        axis_csr = CSRMatrix(indptr=indptr, indices=indices, data=values,
                             shape=(axis_dim, self.other_dim))
        X = axis_csr if self.axis == "features" else axis_csr.transpose()
        return X, np.asarray(self.labels())

    # -- builders ----------------------------------------------------------
    @staticmethod
    def _write_meta(path, axis, shape, dtype, chunk_size, chunk_infos,
                    labels_crc=None):
        meta = dict(version=STORE_VERSION, axis=axis,
                    shape=[int(shape[0]), int(shape[1])],
                    dtype=np.dtype(dtype).name, chunk_size=int(chunk_size),
                    labels_crc=(int(labels_crc) if labels_crc is not None
                                else None),
                    chunks=[dict(start=c.start, stop=c.stop, nnz=c.nnz,
                                 crc=c.crc)
                            for c in chunk_infos])
        with open(os.path.join(path, _META), "w") as f:
            json.dump(meta, f, indent=1)

    @classmethod
    def from_csr(cls, X: CSRMatrix, y: np.ndarray, path: str,
                 axis: str = "samples", chunk_size: int = 8192
                 ) -> "ShardStore":
        """Convert an in-memory CSR and its labels into a store at
        ``path`` (which must not hold one yet), chunked along ``axis``
        (samples chunks are stored transposed). One O(nnz) pass."""
        if axis not in ("features", "samples"):
            raise ValueError(f"unknown store axis {axis!r}")
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        d, n = X.shape
        y = np.asarray(y)
        if y.shape != (n,):
            raise ValueError(f"labels shape {y.shape} != ({n},)")
        os.makedirs(os.path.join(path, _CHUNK_DIR), exist_ok=False)
        src = X if axis == "features" else X.transpose()
        axis_dim = src.shape[0]
        infos = []
        for i, start in enumerate(range(0, axis_dim, chunk_size)):
            stop = min(start + chunk_size, axis_dim)
            lo, hi = int(src.indptr[start]), int(src.indptr[stop])
            crcs = _write_chunk(path, i, src.indptr[start:stop + 1] - lo,
                                src.indices[lo:hi], src.data[lo:hi])
            infos.append(ChunkInfo(index=i, start=start, stop=stop,
                                   nnz=hi - lo, crc=crcs))
        np.save(os.path.join(path, _LABELS), y)
        cls._write_meta(path, axis, (d, n), X.dtype, chunk_size, infos,
                        labels_crc=_crc(y))
        return cls(path)

    def append_chunks(self, X_new: CSRMatrix, y_new: np.ndarray
                      ) -> "ShardStore":
        """Append new samples to a ``'samples'``-axis store in place.

        The new samples become more chunks, the labels file is extended
        and ``meta.json`` rewritten, after which the store reads back as
        if it had been built from the joined data in one pass. A ragged
        last chunk is rewritten merged with the head of the new data, so
        chunk ``c`` keeps covering ``[c * chunk_size, (c+1) * chunk_size)``.
        Values are cast to the store's dtype.

        Raises:
            ValueError: on a 'features'-axis store, a feature-dimension
                mismatch, or a labels/samples length mismatch.
        """
        if self.axis != "samples":
            raise ValueError(
                "append_chunks needs a 'samples'-axis store (appending "
                f"samples to a {self.axis!r}-chunked store would rewrite "
                "every chunk); rebuild the store along 'samples'")
        d, n = self.shape
        y_new = np.asarray(y_new)
        if X_new.shape[0] != d:
            raise ValueError(
                f"new samples have {X_new.shape[0]} features, store has "
                f"{d}")
        n_new = X_new.shape[1]
        if y_new.shape != (n_new,):
            raise ValueError(
                f"labels shape {y_new.shape} != ({n_new},)")
        if n_new == 0:
            return self
        if X_new.dtype != self.dtype:
            X_new = CSRMatrix(indptr=X_new.indptr, indices=X_new.indices,
                              data=np.asarray(X_new.data, self.dtype),
                              shape=X_new.shape)

        # rows of sample-axis chunks are samples: work on X_new^T
        src = X_new.transpose()
        infos = list(self.chunks)
        start = n
        first = 0
        if infos and infos[-1].stop - infos[-1].start < self.chunk_size:
            # merge the ragged tail chunk with the head of the new data
            tail = infos.pop()
            head = min(self.chunk_size - (tail.stop - tail.start), n_new)
            old = self.chunk_csr(tail.index, mmap=False)
            new = src.take_rows(np.arange(head))
            merged_ptr = np.concatenate(
                [np.asarray(old.indptr, np.int64),
                 np.asarray(new.indptr[1:], np.int64) + old.nnz])
            crcs = _write_chunk(self.path, tail.index, merged_ptr,
                                np.concatenate([np.asarray(old.indices),
                                                np.asarray(new.indices)]),
                                np.concatenate([np.asarray(old.data),
                                                np.asarray(new.data)]))
            infos.append(ChunkInfo(index=tail.index, start=tail.start,
                                   stop=tail.stop + head,
                                   nnz=old.nnz + new.nnz, crc=crcs))
            start = tail.stop + head
            first = head
        for off in range(first, n_new, self.chunk_size):
            stop_off = min(off + self.chunk_size, n_new)
            slab = src.take_rows(np.arange(off, stop_off))
            i = len(infos)
            crcs = _write_chunk(self.path, i, slab.indptr, slab.indices,
                                slab.data)
            infos.append(ChunkInfo(index=i, start=start,
                                   stop=start + (stop_off - off),
                                   nnz=slab.nnz, crc=crcs))
            start += stop_off - off

        old_y = np.asarray(self.labels(mmap=False))
        y_all = np.concatenate([old_y, y_new.astype(old_y.dtype)])
        np.save(os.path.join(self.path, _LABELS), y_all)
        self.shape = (d, n + n_new)
        self.chunks = infos
        self.labels_crc = _crc(y_all)
        self.version = STORE_VERSION   # header rewritten at current format
        self._write_meta(self.path, self.axis, self.shape, self.dtype,
                         self.chunk_size, infos, labels_crc=self.labels_crc)
        return self

    @classmethod
    def from_libsvm(cls, libsvm_path: str, path: str,
                    axis: str = "samples", chunk_size: int = 8192,
                    n_features: int | None = None, dtype=np.float32
                    ) -> "ShardStore":
        """Convert a libsvm text file into a store at ``path``.

        ``axis='samples'`` streams: one pass over the file through
        :func:`repro_torch.data.sparse.iter_libsvm_chunks`, O(chunk)
        memory (samples arrive in file order, the chunk order); an
        explicit ``n_features`` truncates per chunk. ``axis='features'``
        needs a global transposition, so it reads the whole CSR first
        (O(nnz)) and goes through :meth:`from_csr`.
        """
        if axis == "features":
            X, y = load_libsvm_sparse(libsvm_path, n_features=n_features,
                                      dtype=dtype)
            return cls.from_csr(X, y, path, axis="features",
                                chunk_size=chunk_size)
        if axis != "samples":
            raise ValueError(f"unknown store axis {axis!r}")
        os.makedirs(os.path.join(path, _CHUNK_DIR), exist_ok=False)
        infos: list[ChunkInfo] = []
        y_parts: list[np.ndarray] = []
        max_feat = -1
        start = 0
        for i, (fi, si, vs, ys) in enumerate(
                iter_libsvm_chunks(libsvm_path, chunk_samples=chunk_size,
                                   dtype=dtype, n_features=n_features)):
            n_chunk = len(ys)
            if len(fi):
                max_feat = max(max_feat, int(fi.max()))
            slab = CSRMatrix.from_coo(si - start, fi, vs,
                                      (n_chunk, max_feat + 1), dtype=dtype)
            crcs = _write_chunk(path, i, slab.indptr, slab.indices,
                                slab.data)
            infos.append(ChunkInfo(index=i, start=start,
                                   stop=start + n_chunk, nnz=slab.nnz,
                                   crc=crcs))
            y_parts.append(ys)
            start += n_chunk
        d = n_features if n_features is not None else max_feat + 1
        n = start
        y = (np.concatenate(y_parts) if y_parts
             else np.zeros(0, dtype)).astype(dtype)
        np.save(os.path.join(path, _LABELS), y)
        cls._write_meta(path, "samples", (d, n), dtype, chunk_size, infos,
                        labels_crc=_crc(y))
        return cls(path)
