"""Minimal LMDB file support for LSUN ingestion, with no ``lmdb`` package
(copy of ``smmdax/data/lmdb_store.py``).

* :class:`LMDBReader` — read-only, mmap-backed: parses the meta pages,
  walks the main DB's B+tree (branch/leaf/overflow pages) once to build
  an in-memory key/value-location index, then serves random access with
  zero-copy value reads, which the (seed, step)-keyed batches need.
* :func:`write_lmdb` — a minimal single-transaction writer (sorted leaf
  pages, branch levels, overflow chains); its files are byte-identical to
  the JAX package's writer's.  ``chip_smoke.py`` builds its LSUN
  environment with it.

Format reference: the LMDB source's public struct layout (MDB_page /
MDB_node / MDB_meta in lmdb.h / mdb.c, OpenLDAP); everything here is
little-endian 64-bit, the only layout LSUN archives use in practice.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterable, Iterator, List, Tuple

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# leaf-node flags
F_BIGDATA = 0x01

PAGEHDRSZ = 16
_PGHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")         # lo, hi, flags, ksize
# MDB_db: pad, flags, depth, branch_pages, leaf_pages, overflow_pages,
# entries, root
_DB = struct.Struct("<IHHQQQQQ")
# MDB_meta prefix: magic, version, address, mapsize
_META_HEAD = struct.Struct("<IIQQ")


class LMDBFormatError(ValueError):
    pass


class LMDBReader:
    """Read-only random access over an LMDB environment's main DB.

    ``path`` may be the environment directory (containing ``data.mdb``)
    or the data file itself.  Entries are exposed in B+tree (sorted
    key) order: ``len(r)``, ``r.key(i)``, ``r.value(i)``, ``r.items()``.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        f = open(path, "rb")
        try:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            f.close()
        self.psize, root, self.entries = self._read_meta()
        # One linear walk of the tree builds the random-access index:
        # (key, value_offset, value_size) with overflow chains resolved.
        self._index: List[Tuple[bytes, int, int]] = []
        if root != 0xFFFFFFFFFFFFFFFF:                 # P_INVALID = empty DB
            self._walk(root)
        if self.entries not in (0, len(self._index)):
            raise LMDBFormatError(
                f"walked {len(self._index)} entries, meta says {self.entries}")

    # -- meta ---------------------------------------------------------------

    def _parse_meta(self, off: int) -> Tuple[int, int, int, int]:
        """-> (txnid, psize, main_root, main_entries) or raises."""
        _, _, flags, _, _ = _PGHDR.unpack_from(self._mm, off)
        if not flags & P_META:
            raise LMDBFormatError("not a meta page")
        o = off + PAGEHDRSZ
        magic, version, _, _ = _META_HEAD.unpack_from(self._mm, o)
        if magic != MAGIC:
            raise LMDBFormatError(f"bad magic {magic:#x}")
        if version not in (DATA_VERSION, 999):
            raise LMDBFormatError(f"unsupported data version {version}")
        o += _META_HEAD.size
        free_db = _DB.unpack_from(self._mm, o)
        main_db = _DB.unpack_from(self._mm, o + _DB.size)
        o += 2 * _DB.size
        _last_pg, txnid = struct.unpack_from("<QQ", self._mm, o)
        psize = free_db[0]                 # mm_psize lives in FREE_DBI.md_pad
        return txnid, psize, main_db[7], main_db[6]

    def _read_meta(self) -> Tuple[int, int, int]:
        metas = []
        try:
            t0, psize, root0, n0 = self._parse_meta(0)
            metas.append((t0, psize, root0, n0))
        except LMDBFormatError:
            psize = 4096
        for cand in ({psize} | {4096, 8192, 16384, 32768}):
            try:
                metas.append(self._parse_meta(cand))
                break
            except (LMDBFormatError, struct.error):
                continue
        if not metas:
            raise LMDBFormatError(f"{self.path}: no valid LMDB meta page")
        txn, psize, root, entries = max(metas)     # newest committed txn
        return psize, root, entries

    # -- tree walk ----------------------------------------------------------

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self._mm):
            raise LMDBFormatError(f"page {pgno} out of bounds")
        return off

    def _walk(self, pgno: int) -> None:
        off = self._page(pgno)
        _, _, flags, lower, _ = _PGHDR.unpack_from(self._mm, off)
        nkeys = (lower - PAGEHDRSZ) >> 1
        if flags & P_LEAF2:
            raise LMDBFormatError("MDB_DUPFIXED (LEAF2) pages unsupported")
        for i in range(nkeys):
            (ptr,) = struct.unpack_from("<H", self._mm, off + PAGEHDRSZ + 2 * i)
            node = off + ptr
            lo, hi, nflags, ksize = _NODEHDR.unpack_from(self._mm, node)
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                self._walk(child)
            elif flags & P_LEAF:
                key = bytes(self._mm[node + 8: node + 8 + ksize])
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    (ovf,) = struct.unpack_from("<Q", self._mm,
                                                node + 8 + ksize)
                    self._index.append((key, self._page(ovf) + PAGEHDRSZ,
                                        dsize))
                else:
                    self._index.append((key, node + 8 + ksize, dsize))
            else:
                raise LMDBFormatError(f"page {pgno}: unexpected flags {flags:#x}")

    # -- access -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    def key(self, i: int) -> bytes:
        return self._index[i][0]

    def value(self, i: int) -> bytes:
        _, off, size = self._index[i]
        return bytes(self._mm[off: off + size])

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        for i in range(len(self._index)):
            yield self._index[i][0], self.value(i)

    def close(self) -> None:
        self._mm.close()


# ---------------------------------------------------------------------------
# writer (fixtures + dataset conversion)


def _node_size(ksize: int, dsize: int, bigdata: bool) -> int:
    sz = 8 + ksize + (8 if bigdata else dsize)
    return sz + (sz & 1)                   # even alignment, as mdb.c does


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]],
               psize: int = 4096) -> None:
    """Write a fresh single-transaction LMDB environment at ``path``
    (a directory; creates ``data.mdb``) containing ``items`` in the
    main DB.  Values too large for a quarter page go to overflow pages
    (F_BIGDATA), like the C library's MDB_node sizing rule.
    """
    pairs = sorted((bytes(k), bytes(v)) for k, v in items)
    if any(len(k) == 0 or len(k) > 511 for k, _ in pairs):
        raise ValueError("keys must be 1..511 bytes")
    os.makedirs(path, exist_ok=True)

    pages: List[bytes] = []                # data pages, pgno = 2 + index
    next_pg = 2

    def alloc(raw: bytes) -> int:
        nonlocal next_pg
        pages.append(raw)
        pg = next_pg
        next_pg += len(raw) // psize
        return pg

    # the C library spills to overflow when a node exceeds ~1/4 page
    big_cutoff = psize // 4
    n_overflow = 0

    leaves: List[Tuple[bytes, int]] = []   # (first_key, pgno)
    cur: List[Tuple[bytes, bytes, bool, int]] = []  # key, data, big, ovf_pg
    cur_bytes = 0

    def flush_leaf() -> None:
        nonlocal cur, cur_bytes
        if not cur:
            return
        buf = bytearray(psize)
        nk = len(cur)
        upper = psize
        ptrs = []
        body = []
        for key, data, big, ovf in cur:
            sz = _node_size(len(key), len(data), big)
            upper -= sz
            ptrs.append(upper)
            if big:
                payload = struct.pack("<Q", ovf)
            else:
                payload = data
            node = _NODEHDR.pack(len(data) & 0xFFFF, len(data) >> 16,
                                 F_BIGDATA if big else 0, len(key))
            body.append((upper, node + key + payload))
        lower = PAGEHDRSZ + 2 * nk
        if lower > upper:
            raise LMDBFormatError("leaf overflow (bug in fill accounting)")
        pg = next_pg
        _PGHDR.pack_into(buf, 0, pg, 0, P_LEAF, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
        for off, raw in body:
            buf[off: off + len(raw)] = raw
        alloc(bytes(buf))
        leaves.append((cur[0][0], pg))
        cur, cur_bytes = [], 0

    for key, val in pairs:
        big = _node_size(len(key), len(val), False) > big_cutoff
        ovf_pg = 0
        if big:
            npg = (len(val) + PAGEHDRSZ + psize - 1) // psize
            raw = bytearray(npg * psize)
            # overflow header: pgno, pad, P_OVERFLOW, pb_pages (u32 union)
            struct.pack_into("<QHHI", raw, 0, next_pg, 0, P_OVERFLOW, npg)
            raw[PAGEHDRSZ: PAGEHDRSZ + len(val)] = val
            ovf_pg = alloc(bytes(raw))
            n_overflow += npg
        sz = _node_size(len(key), len(val), big)
        if PAGEHDRSZ + 2 * (len(cur) + 1) + cur_bytes + sz > psize:
            flush_leaf()
        cur.append((key, val, big, ovf_pg))
        cur_bytes += sz
    flush_leaf()

    def flush_branch(children) -> Tuple[bytes, int]:
        """Write one branch page over [(node_key, child_pg, first_key)];
        returns (representative first key, page number)."""
        buf = bytearray(psize)
        upper = psize
        ptrs = []
        body = []
        for key, pg, _ in children:
            sz = _node_size(len(key), 0, False)
            upper -= sz
            ptrs.append(upper)
            node = _NODEHDR.pack(pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                                 (pg >> 32) & 0xFFFF, len(key))
            body.append((upper, node + key))
        lower = PAGEHDRSZ + 2 * len(children)
        if lower > upper:
            raise LMDBFormatError("branch overflow (bug in fill accounting)")
        pg = next_pg
        _PGHDR.pack_into(buf, 0, pg, 0, P_BRANCH, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
        for off, raw in body:
            buf[off: off + len(raw)] = raw
        alloc(bytes(buf))
        return children[0][2], pg

    depth = 1 if leaves else 0
    n_branch = 0
    if not leaves:
        root = 0xFFFFFFFFFFFFFFFF
    elif len(leaves) == 1:
        root = leaves[0][1]
    else:
        # build branch levels bottom-up until one root page holds the
        # whole level (a single level caps out around 200 leaves at
        # psize 4096 — LSUN-scale environments need several)
        level = leaves                     # [(first_key, pgno)]
        root = leaves[0][1]
        while len(level) > 1:
            next_level = []
            cur: List[Tuple[bytes, int, bytes]] = []  # node_key, pg, first_key
            cur_bytes = 0
            for fk, pg in level:
                key = b"" if not cur else fk   # leftmost branch key empty
                sz = _node_size(len(key), 0, False)
                if cur and PAGEHDRSZ + 2 * (len(cur) + 1) + cur_bytes + sz > psize:
                    next_level.append(flush_branch(cur))
                    n_branch += 1
                    cur, cur_bytes = [], 0
                    key = b""
                    sz = _node_size(0, 0, False)
                cur.append((key, pg, fk))
                cur_bytes += sz
            next_level.append(flush_branch(cur))
            n_branch += 1
            depth += 1
            level = next_level
        root = level[0][1]

    last_pg = next_pg - 1

    def meta(txnid: int) -> bytes:
        buf = bytearray(psize)
        _PGHDR.pack_into(buf, 0, txnid & 1, 0, P_META, 0, 0)
        o = PAGEHDRSZ
        _META_HEAD.pack_into(buf, o, MAGIC, DATA_VERSION, 0,
                             max(len(pairs) + 4, 64) * psize)
        o += _META_HEAD.size
        # FREE_DBI: md_pad carries the page size; empty free list
        _DB.pack_into(buf, o, psize, 0, 0, 0, 0, 0, 0, 0xFFFFFFFFFFFFFFFF)
        o += _DB.size
        _DB.pack_into(buf, o, 0, 0, depth, n_branch, len(leaves),
                      n_overflow, len(pairs), root)
        o += _DB.size
        struct.pack_into("<QQ", buf, o, last_pg, txnid)
        return bytes(buf)

    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(meta(0))                   # meta page 0 (older txn)
        f.write(meta(1))                   # meta page 1 (the committed txn)
        for raw in pages:
            f.write(raw)
