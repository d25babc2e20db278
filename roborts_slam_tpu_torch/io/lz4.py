"""Pure-python LZ4 frame codec (decompressor + simple compressor).

Own copy of the JAX package's ``io/lz4.py`` (the port imports nothing of
that package). rosbag v2.0 chunks are commonly lz4-compressed (ROS
``roslz4`` writes the LZ4 frame format: magic 0x184D2204, FLG/BD
descriptor, independent blocks, content checksum). The port depends on no
``lz4`` wheel, so the reader carries its own decoder; it favors clarity over
speed (a few MB/s — fine for replay fixtures; use the native scan-log
pipeline for bulk data).

Format reference: the public LZ4 frame + block specifications.
"""

from __future__ import annotations

import struct

FRAME_MAGIC = 0x184D2204


def decompress_block(src: bytes, dst_hint: int = 0) -> bytes:
    """Raw LZ4 block: sequences of
    [token][literal-len ext*][literals][offset u16][match-len ext*]."""
    dst = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        # literals
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        dst += src[i:i + ll]
        i += ll
        if i >= n:
            break                      # last sequence: literals only
        (offset,) = struct.unpack_from("<H", src, i)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        ml = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset past start")
        # overlapping copy semantics: byte-by-byte when ranges overlap
        if offset >= ml:
            dst += dst[start:start + ml]
        else:
            for k in range(ml):
                dst.append(dst[start + k])
    return bytes(dst)


def decompress_frame(data: bytes) -> bytes:
    """LZ4 frame: magic, descriptor, blocks (high size bit = stored
    uncompressed), 0 endmark. Checksums are skipped, not verified."""
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != FRAME_MAGIC:
        raise ValueError(f"not an LZ4 frame (magic {magic:#x})")
    off = 4
    flg = data[off]
    off += 2                            # FLG + BD
    version = flg >> 6
    if version != 1:
        raise ValueError(f"unsupported LZ4 frame version {version}")
    block_checksum = bool(flg & 0x10)
    content_size = bool(flg & 0x08)
    if content_size:
        off += 8
    if flg & 0x01:                      # dict id
        off += 4
    off += 1                            # header checksum (HC)

    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", data, off)
        off += 4
        if bsize == 0:                  # endmark
            break
        stored = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        blob = data[off:off + bsize]
        off += bsize
        if block_checksum:
            off += 4
        out += blob if stored else decompress_block(blob)
    return bytes(out)


def _compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compressor (hash-chain-free: single-slot hash table,
    like the reference's fast path). Spec constraints honored: matches end
    >= 12 bytes before the block end; the block ends with literals."""
    n = len(src)
    dst = bytearray()
    table: dict[int, int] = {}
    anchor = 0
    i = 0
    limit = n - 12

    def emit(lit_end: int, match_len: int, offset: int):
        nonlocal dst
        ll = lit_end - anchor
        ml = match_len - 4 if match_len else 0
        token = (min(ll, 15) << 4) | (min(ml, 15) if match_len else 0)
        dst.append(token)
        if ll >= 15:
            rem = ll - 15
            while rem >= 255:
                dst.append(255)
                rem -= 255
            dst.append(rem)
        dst += src[anchor:lit_end]
        if match_len:
            dst += struct.pack("<H", offset)
            if ml >= 15:
                rem = ml - 15
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)

    while i < limit:
        key = src[i:i + 4]
        ikey = int.from_bytes(key, "little")
        cand = table.get(ikey)
        table[ikey] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand:cand + 4] == key:
            ml = 4
            while i + ml < limit + 7 and ml < 0xFFFF and \
                    src[cand + ml:cand + ml + 1] == src[i + ml:i + ml + 1]:
                ml += 1
            emit(i, ml, i - cand)
            i += ml
            anchor = i
        else:
            i += 1
    emit(n, 0, 0)                       # trailing literals
    return bytes(dst)


def compress_frame(data: bytes, block_size: int = 1 << 16) -> bytes:
    """Minimal LZ4 frame writer (independent blocks, no checksums): enough
    for round-trip tests and fixture bags. The header-checksum byte is a
    fixed placeholder — the reader skips it unverified."""
    out = bytearray(struct.pack("<I", FRAME_MAGIC))
    out.append(0x40)                    # FLG: version 01, independent blocks
    out.append(0x40)                    # BD: 64 KiB max block size
    out.append(0x82)                    # HC placeholder (skipped by reader)
    for start in range(0, max(len(data), 1), block_size):
        chunk = data[start:start + block_size]
        comp = _compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", 0x80000000 | len(chunk)) + chunk
    out += struct.pack("<I", 0)         # endmark
    return bytes(out)
